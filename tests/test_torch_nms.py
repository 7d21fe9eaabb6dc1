"""Port NMS on the CPU against the JAX versions: batched greedy NMS with
score ties, single-image NMS and batch compaction; the letterbox against the
JAX lanczos4 letterbox."""

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
