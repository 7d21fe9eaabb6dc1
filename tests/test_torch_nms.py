"""Port NMS on the CPU against the JAX versions: batched greedy NMS with
score ties, single-image NMS and batch compaction, param fusion and the
fusion neighbour sets; the letterbox against the JAX lanczos4 letterbox."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu.ops.letterbox import letterbox as jax_lb
from head_detector_tpu.ops.letterbox import letterbox_batch as jax_lb_batch
from head_detector_tpu.ops import nms as jax_nms
from head_detector_tpu_torch.ops import letterbox, nms


def _boxes(rng, b, a):
    xy = rng.uniform(0, 60, (b, a, 2))
    wh = rng.uniform(10, 40, (b, a, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # quantised scores: many exact ties, broken by anchor index
    scores = (rng.randint(0, 12, (b, a)) / 12.0).astype(np.float32)
    params = rng.randn(b, a, 7).astype(np.float32)
    return boxes, scores, params


@pytest.mark.parametrize("pre,post", [(1000, 100), (40, 8)])
def test_batched_nms_matches_jax(pre, post):
    boxes, scores, params = _boxes(np.random.RandomState(0), 3, 300)
    kw = dict(confidence_threshold=0.3, iou_threshold=0.45, pre_nms_max=pre,
              post_nms_max=post)
    want = jax_nms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores[..., None]),
                               jnp.asarray(params), **kw)
    got = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores[..., None]),
                          torch.from_numpy(params), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.flame_params.numpy(), np.asarray(want.flame_params))
    # every image keeps boxes, and greedy suppression removed some
    assert got.valid.any(dim=1).all()
    assert int(got.valid.sum()) < int((scores >= 0.3).sum())

    one = nms.single_image_nms(torch.from_numpy(boxes[1]), torch.from_numpy(scores[1]),
                               torch.from_numpy(params[1]), **kw)
    np.testing.assert_array_equal(one.anchor_idx.numpy(), np.asarray(want.anchor_idx[1]))

    for m in (5, 3 * post):
        cw = jax_nms.compact_detections(want, m)
        cg = nms.compact_detections(got, m)
        for field in ("valid", "anchor_idx", "batch_idx", "slot_idx", "scores", "boxes",
                      "flame_params"):
            np.testing.assert_array_equal(getattr(cg, field).numpy(),
                                          np.asarray(getattr(cw, field)), err_msg=field)


def test_nms_zero_width_params_and_empty():
    boxes, scores, _ = _boxes(np.random.RandomState(1), 2, 50)
    res = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.zeros((2, 50, 0)), confidence_threshold=2.0,
                          post_nms_max=10)
    assert res.flame_params.shape == (2, 10, 0)
    assert not res.valid.any() and (res.anchor_idx == 0).all()


@pytest.mark.parametrize("shape", [(48, 80, 3), (90, 50, 3), (64, 64, 3)])
def test_letterbox_matches_jax(shape):
    imgs = np.random.RandomState(2).randint(0, 255, (2,) + shape, dtype=np.uint8)
    want = np.asarray(jax_lb_batch(jnp.asarray(imgs), 64))
    got = letterbox.letterbox_batch(torch.from_numpy(imgs), 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    one, pad, scale = letterbox.letterbox(torch.from_numpy(imgs[0]), 64)
    _, pad_j, scale_j = jax_lb(jnp.asarray(imgs[0]), 64)
    np.testing.assert_allclose(one.numpy()[0], want[0], atol=1e-5)
    assert pad == tuple(pad_j) and scale == scale_j


@pytest.mark.parametrize("fusion_iou,neighbors", [(0.7, 4), (0.5, 1), (0.3, 8), (0.5, 400)])
def test_fusion_and_neighbors_match_jax(fusion_iou, neighbors):
    """Fused rows and neighbour sets on crowded seeded boxes with quantised
    scores (ties at positive weights: the higher-ranked candidate first).
    Indices equal; weights and fused params within 1e-5 (float32)."""
    boxes, scores, params = _boxes(np.random.RandomState(7), 3, 300)
    kw = dict(confidence_threshold=0.3, iou_threshold=0.45, pre_nms_max=200,
              post_nms_max=20, fusion_iou=fusion_iou)
    args_j = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(params))
    args_t = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(params))
    want = jax_nms.batched_nms(*args_j, fuse_flame=True, **kw)
    got = nms.batched_nms(*args_t, fuse_flame=True, **kw)
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.flame_params.numpy(), np.asarray(want.flame_params),
                               rtol=1e-5, atol=1e-5)
    res_j, nb_j = jax_nms.batched_nms(*args_j, return_neighbors=neighbors, **kw)
    res_t, nb_t = nms.batched_nms(*args_t, return_neighbors=neighbors, **kw)
    assert nb_t.anchor_idx.shape == (3, 20, min(neighbors, 200))
    np.testing.assert_array_equal(res_t.flame_params.numpy(), np.asarray(res_j.flame_params))
    np.testing.assert_array_equal(nb_t.anchor_idx.numpy(), np.asarray(nb_j.anchor_idx))
    np.testing.assert_allclose(nb_t.weights.numpy(), np.asarray(nb_j.weights), atol=1e-5)
    # clusters of more than one candidate occur, and a kept box leads its own
    assert neighbors == 1 or (nb_t.weights[..., 1] > 0).any()
    kept = res_t.valid
    np.testing.assert_array_equal(nb_t.anchor_idx[..., 0][kept].numpy(),
                                  res_t.anchor_idx[kept].numpy())
    one, nb_one = nms.single_image_nms(*(a[2] for a in args_t), return_neighbors=neighbors,
                                       **kw)
    np.testing.assert_array_equal(nb_one.anchor_idx.numpy(), np.asarray(nb_j.anchor_idx[2]))


def _iou1(a, b):
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)


def _fused(boxes, scores, params, **kw):
    return nms.single_image_nms(torch.from_numpy(np.asarray(boxes, np.float32)),
                                torch.from_numpy(np.asarray(scores, np.float32)),
                                torch.from_numpy(np.asarray(params, np.float32)), **kw)


def _unchanged_detections(rng):
    xy = rng.uniform(0, 400, (200, 2))
    wh = rng.uniform(20, 120, (200, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rng.uniform(0, 1, 200)
    params = rng.normal(size=(200, 13))
    kw = dict(confidence_threshold=0.3, iou_threshold=0.5, post_nms_max=50)
    plain = _fused(boxes, scores, params, **kw)
    fused = _fused(boxes, scores, params, fuse_flame=True, **kw)
    for field in ("boxes", "scores", "valid", "anchor_idx"):
        np.testing.assert_array_equal(getattr(plain, field).numpy(),
                                      getattr(fused, field).numpy())


def _isolated_identity(rng):
    boxes = [[0, 0, 50, 50], [200, 200, 260, 260], [500, 500, 540, 540]]
    params = rng.normal(size=(3, 9))
    plain = _fused(boxes, [0.9, 0.8, 0.7], params)
    fused = _fused(boxes, [0.9, 0.8, 0.7], params, fuse_flame=True)
    np.testing.assert_allclose(fused.flame_params.numpy(), plain.flame_params.numpy(),
                               rtol=1e-6, atol=1e-6)


def _cluster_weighted_mean(rng):
    boxes = [[0, 0, 100, 100], [1, 1, 99, 99], [2, 2, 100, 100], [400, 400, 480, 480]]
    scores = np.float32([0.9, 0.8, 0.7, 0.6])
    params = rng.normal(size=(4, 5)).astype(np.float32)
    res = _fused(boxes, scores, params, iou_threshold=0.5, fuse_flame=True, fusion_iou=0.7)
    got = res.flame_params.numpy()[res.valid.numpy()]
    assert len(got) == 2
    w = scores[:3]
    np.testing.assert_allclose(got[0], (w[:, None] * params[:3]).sum(0) / w.sum(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], params[3], rtol=1e-6, atol=1e-6)


def _best_iou_kept_box_only(rng):
    a, b, c = [0.0, 0.0, 100.0, 100.0], [38.0, 0.0, 138.0, 100.0], [34.0, 0.0, 132.0, 100.0]
    assert _iou1(a, b) < 0.5 and _iou1(b, c) > _iou1(a, c)
    params = np.float32([[1.0, 0.0], [0.0, 1.0], [10.0, 10.0]])
    scores = np.float32([0.9, 0.8, 0.7])
    res = _fused([a, b, c], scores, params, iou_threshold=0.5, fuse_flame=True,
                 fusion_iou=min(_iou1(a, c), _iou1(b, c)) - 0.01)
    got = res.flame_params.numpy()[res.valid.numpy()]
    assert len(got) == 2
    np.testing.assert_allclose(got[0], params[0], rtol=1e-6, atol=1e-6)
    w = scores[1:]
    np.testing.assert_allclose(got[1], (w[:, None] * params[1:]).sum(0) / w.sum(),
                               rtol=1e-5, atol=1e-5)


def _ignores_subconfidence(rng):
    res = _fused([[0, 0, 100, 100], [1, 1, 99, 99]], [0.9, 0.2],
                 [[1.0, 2.0], [100.0, 200.0]], confidence_threshold=0.5, fuse_flame=True)
    got = res.flame_params.numpy()[res.valid.numpy()]
    assert len(got) == 1
    np.testing.assert_allclose(got[0], [1.0, 2.0], rtol=1e-6, atol=1e-6)


def _batched_and_empty(rng):
    xy = rng.uniform(0, 400, (2, 64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 120, (2, 64, 2))], -1)
    scores = rng.uniform(0, 1, (2, 64))
    scores[1] = 0.01  # nothing of image 2 passes the threshold
    res = nms.batched_nms(torch.from_numpy(boxes.astype(np.float32)),
                          torch.from_numpy(scores.astype(np.float32)),
                          torch.from_numpy(rng.normal(size=(2, 64, 413)).astype(np.float32)),
                          confidence_threshold=0.5, fuse_flame=True, post_nms_max=16)
    assert res.flame_params.shape == (2, 16, 413)
    assert not res.valid[1].any() and torch.isfinite(res.flame_params).all()


def _neighbors_are_fusion_weights(rng):
    boxes = [[0, 0, 100, 100], [1, 1, 99, 99], [2, 2, 100, 100], [400, 400, 480, 480]]
    scores = np.float32([0.9, 0.8, 0.7, 0.6])
    params = rng.normal(size=(4, 5)).astype(np.float32)
    res, nb = _fused(boxes, scores, params, iou_threshold=0.5, fusion_iou=0.7,
                     return_neighbors=3)
    valid = res.valid.numpy()
    idx, w = nb.anchor_idx.numpy()[valid], nb.weights.numpy()[valid]
    np.testing.assert_array_equal(idx[0], [0, 1, 2])
    np.testing.assert_allclose(w[0], scores[:3], atol=1e-6)
    assert idx[1][0] == 3
    np.testing.assert_allclose(w[1], [scores[3], 0.0, 0.0], atol=1e-6)
    fused = _fused(boxes, scores, params, iou_threshold=0.5, fusion_iou=0.7, fuse_flame=True)
    mean = (w[..., None] * params[idx.reshape(-1)].reshape(2, 3, -1)).sum(1) / w.sum(1)[:, None]
    np.testing.assert_allclose(mean, fused.flame_params.numpy()[valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [
    _unchanged_detections, _isolated_identity, _cluster_weighted_mean,
    _best_iou_kept_box_only, _ignores_subconfidence, _batched_and_empty,
    _neighbors_are_fusion_weights,
], ids=lambda f: f.__name__.strip("_"))
def test_fusion_semantics(case):
    """The port's counterparts of the JAX package's fusion tests
    (tests/test_nms.py): detections unchanged, isolated boxes unchanged,
    the score-weighted cluster mean, best-IoU assignment only, candidates
    under the threshold ignored, batched with an empty image, and neighbour
    sets that reproduce the fused rows."""
    case(np.random.RandomState(0))
