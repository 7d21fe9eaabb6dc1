"""The port's training losses against the JAX package on the CPU: the box
utilities, the elementwise losses, the task-aligned assigner and
``yolo_heads_loss``, on the same inputs made from a numpy seed.

Bars: indices and masks bit-equal; values to 1e-6 (absolute, on values of
order 1, or relative where stated); ``yolo_heads_loss`` components to
relative 1e-5 and the gradients with respect to the raw outputs to 1e-4 of
their largest magnitude.  Ties are built in on purpose: equal alignment
metrics (the top-k), equal IoUs (the argmax), and the FLAME subset's top-k
over a 0/1 mask, which is all ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu.flame import FlameModel as JaxFlameModel
from head_detector_tpu.models.heads import RawOutputs as JaxRaw
from head_detector_tpu.models.heads import make_anchors
from head_detector_tpu.train import assigner as jassigner
from head_detector_tpu.train import boxes as jboxes
from head_detector_tpu.train import losses as jlosses
from head_detector_tpu.train.loss import LossConfig as JaxLossConfig
from head_detector_tpu.train.loss import Targets as JaxTargets
from head_detector_tpu.train.loss import yolo_heads_loss as jax_loss
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models.heads import RawOutputs
from head_detector_tpu_torch.train import assigner, boxes, losses
from head_detector_tpu_torch.train.loss import COMPONENT_NAMES, LossConfig, Targets
from head_detector_tpu_torch.train.loss import yolo_heads_loss

SIZE = 64
STRIDES = (8, 16, 32)
REG_MAX = 16


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(np.array(x))


def _rand_boxes(rng, shape, lo=0.0, hi=SIZE):
    xy = rng.uniform(lo, hi * 0.7, shape + (2,))
    wh = rng.uniform(4, hi * 0.5, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------------ boxes
def test_box_utilities_match():
    rng = np.random.RandomState(0)
    a, g = _rand_boxes(rng, (2, 5)), _rand_boxes(rng, (2, 7))
    g[:, 3] = g[:, 2]  # duplicated boxes: equal IoUs
    pts = rng.uniform(0, SIZE, (7, 2)).astype(np.float32)
    np.testing.assert_allclose(boxes.batch_iou_similarity(t(a), t(g)).numpy(),
                               np.asarray(jboxes.batch_iou_similarity(j(a), j(g))), atol=1e-6)
    np.testing.assert_array_equal(
        boxes.check_points_inside_bboxes(t(pts), t(a)).numpy(),
        np.asarray(jboxes.check_points_inside_bboxes(j(pts), j(a))))
    ious = np.asarray(jboxes.batch_iou_similarity(j(a), j(g)))
    np.testing.assert_array_equal(
        boxes.compute_max_iou_anchor(t(ious)).numpy(),
        np.asarray(jboxes.compute_max_iou_anchor(j(ious))))
    d = rng.uniform(0, 5, (2, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(boxes.batch_distance2bbox(t(pts), t(d)).numpy(),
                               np.asarray(jboxes.batch_distance2bbox(j(pts), j(d))), atol=1e-6)
    np.testing.assert_allclose(boxes.bbox2distance(t(pts), t(g), REG_MAX).numpy(),
                               np.asarray(jboxes.bbox2distance(j(pts), j(g), REG_MAX)),
                               atol=1e-5)


@pytest.mark.parametrize("k", [3, 13, 40])
def test_topk_membership_breaks_ties_like_jax(k):
    """Metrics with many equal values (zeros and repeated levels): the same
    anchors join the top-k, the lower index first among equals."""
    rng = np.random.RandomState(k)
    metrics = rng.choice([0.0, 0.25, 0.5], size=(2, 4, 30)).astype(np.float32)
    mask = np.ones((2, 4, 1), np.float32)
    mask[1, 2:] = 0
    got = boxes.gather_topk_anchors(t(metrics), k, t(mask)).numpy()
    want = np.asarray(jboxes.gather_topk_anchors(j(metrics), k, j(mask)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["giou_loss", "ciou_loss"])
def test_iou_losses_and_gradients_match(fn):
    rng = np.random.RandomState(1)
    p, g = _rand_boxes(rng, (50,)), _rand_boxes(rng, (50,))
    p[:5] = g[:5]  # perfect overlaps
    want, want_grad = jax.value_and_grad(lambda x: getattr(jboxes, fn)(x, j(g)).sum())(j(p))
    x = t(p).requires_grad_(True)
    got = getattr(boxes, fn)(x, t(g)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-6)


# ----------------------------------------------------------------- losses
def test_elementwise_losses_match():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 40, 1).astype(np.float32) * 4
    labels = rng.uniform(0, 1, (3, 40, 1)).astype(np.float32)
    for name in ("bce_with_logits", "focal_loss"):
        np.testing.assert_allclose(getattr(losses, name)(t(logits), t(labels)).numpy(),
                                   np.asarray(getattr(jlosses, name)(j(logits), j(labels))),
                                   atol=1e-6)
    dist = rng.randn(3, 40, 4, REG_MAX + 1).astype(np.float32)
    target = rng.uniform(0, REG_MAX - 0.01, (3, 40, 4)).astype(np.float32)
    target[0, :4] = np.arange(4)  # integer targets: the right bin weighs 0
    np.testing.assert_allclose(losses.df_loss(t(dist), t(target)).numpy(),
                               np.asarray(jlosses.df_loss(j(dist), j(target))), atol=1e-6)
    pk, tk = rng.randn(5, 30, 2).astype(np.float32) * 10, rng.randn(5, 30, 2).astype(np.float32) * 10
    area = rng.uniform(50, 500, (5, 1)).astype(np.float32)
    np.testing.assert_allclose(losses.oks_keypoint_loss(t(pk), t(tk), t(area), 0.025).numpy(),
                               np.asarray(jlosses.oks_keypoint_loss(j(pk), j(tk), j(area), 0.025)),
                               atol=1e-6)
    pv, tv = rng.randn(5, 60, 3).astype(np.float32), rng.randn(5, 60, 3).astype(np.float32)
    tv[4] = 0.0  # a padded row: the eps guard
    for crit in ("l1", "l2", "smooth_l1"):
        np.testing.assert_allclose(losses.vertices_3d_loss(t(pv), t(tv), crit).numpy(),
                                   np.asarray(jlosses.vertices_3d_loss(j(pv), j(tv), crit)),
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["geodesic", "frobenius", "cosine"])
def test_rotation_losses_and_gradients_match(kind):
    """Includes the identity pair (geodesic and cosine): the geodesic acos
    argument sits on its clip, and the gradient stays finite there in both.
    The Frobenius norm of a zero difference has a NaN gradient in JAX and 0
    in torch; the training config uses the geodesic loss, so that pair is
    left out of the Frobenius case."""
    rng = np.random.RandomState(3)
    q = rng.randn(6, 3, 3).astype(np.float32)
    r = np.linalg.qr(q)[0].astype(np.float32)
    g = np.linalg.qr(rng.randn(6, 3, 3))[0].astype(np.float32)
    if kind != "frobenius":
        g[0] = r[0]
    want, want_grad = jax.value_and_grad(
        lambda x: jlosses.rotation_loss(x, j(g), kind).sum())(j(r))
    x = t(r).requires_grad_(True)
    got = losses.rotation_loss(x, t(g), kind).sum()
    got.backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-4)


# --------------------------------------------------------------- assigner
def _anchors():
    shapes = tuple((SIZE // s, SIZE // s) for s in STRIDES)
    _, points, counts, stride = make_anchors(shapes, STRIDES)
    return (points * stride).astype(np.float32), stride.astype(np.float32), counts


@pytest.mark.parametrize("case", ["random", "ties", "empty_gt"])
def test_assigner_matches(case):
    rng = np.random.RandomState(4)
    pts, stride, _ = _anchors()
    l = pts.shape[0]
    scores = rng.uniform(0.01, 0.99, (2, l, 1)).astype(np.float32)
    pred = _rand_boxes(rng, (2, l))
    gt = _rand_boxes(rng, (2, 5))
    mask = np.ones((2, 5, 1), np.float32)
    mask[1, 3:] = 0
    gt[1, 3:] = 0
    if case == "ties":
        scores[:] = 0.5  # equal alignment wherever the IoUs are equal
        pred[:] = pred[:, :1]  # one predicted box for every anchor
        gt[0, 1] = gt[0, 0]  # two gts on the same box: contested anchors
    if case == "empty_gt":
        mask[:] = 0
        gt[:] = 0
    got = assigner.task_aligned_assigner(t(scores), t(pred), t(pts), t(gt), t(mask))
    want = jassigner.task_aligned_assigner(j(scores), j(pred), j(pts), j(gt), j(mask))
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.assigned_gt_index.numpy(),
                                  np.asarray(want.assigned_gt_index))
    np.testing.assert_array_equal(got.assigned_bboxes.numpy(), np.asarray(want.assigned_bboxes))
    np.testing.assert_allclose(got.assigned_scores.numpy(), np.asarray(want.assigned_scores),
                               atol=1e-6)
    if case != "empty_gt":
        assert got.fg_mask.any()
    else:
        assert not got.fg_mask.any()


# ----------------------------------------------------------- the whole loss
@pytest.fixture(scope="module")
def flames():
    return JaxFlameModel.from_assets(), FlameModel.from_assets(device="cpu")


def _loss_inputs(seed: int, case: str):
    """RawOutputs of a 64 px TINY-sized head (84 anchors) and Targets from
    seeded FLAME heads: GT decoded by the JAX package, shared as numpy."""
    from head_detector_tpu.flame import reproject_spatial_vertices

    rng = np.random.RandomState(seed)
    pts, stride, counts = _anchors()
    l, b, n = pts.shape[0], 2, 4
    logits = rng.randn(b, l, 1).astype(np.float32)
    distri = rng.randn(b, l, 4 * (REG_MAX + 1)).astype(np.float32)
    flame = rng.randn(b, l, 413).astype(np.float32) * 0.1
    flame[..., 409:411] += pts[None]
    flame[..., 411] = 0.0
    flame[..., 412] = rng.uniform(10, 30, (b, l))

    params = rng.randn(b * n, 413).astype(np.float32) * 0.1
    params[:, 409:411] = rng.uniform(0.3 * SIZE, 0.7 * SIZE, (b * n, 2))
    params[:, 411] = 0.0
    params[:, 412] = rng.uniform(0.3 * SIZE, 0.6 * SIZE, b * n)
    verts, rots, proj = map(np.asarray, reproject_spatial_vertices(
        JaxFlameModel.from_assets(), jnp.asarray(params), to_2d=False))
    lo, hi = proj[..., :2].min(1), proj[..., :2].max(1)
    gt_bboxes = np.concatenate([lo, hi], -1).reshape(b, n, 4).astype(np.float32)
    v2d = np.concatenate([proj[..., :2], np.ones_like(proj[..., :1])], -1)
    mask = np.ones((b, n, 1), np.float32)
    if case == "padding_rows":
        mask[0, 2:] = 0
        mask[1, 1:] = 0
    if case == "all_padding":
        mask[:] = 0
    gt_bboxes = gt_bboxes * mask
    targets = (gt_bboxes, v2d.reshape(b, n, -1, 3) * mask[..., None],
               verts.reshape(b, n, -1, 3) * mask[..., None],
               np.where(mask[..., None] > 0, rots.reshape(b, n, 3, 3), np.eye(3)).astype(np.float32),
               mask)
    anchors = np.zeros((l, 4), np.float32)
    return (logits, distri, flame, anchors, pts, counts, stride), targets


@pytest.mark.parametrize("case,max_positives", [
    ("full", 256),
    ("overflow", 4),  # more positives than max_positives: the rest dropped
    ("padding_rows", 256),
    ("all_padding", 256),
])
def test_yolo_heads_loss_and_gradients_match(flames, case, max_positives):
    jflame, tflame = flames
    (logits, distri, flame, anchors, pts, counts, stride), tg = _loss_inputs(5, case)
    jcfg = JaxLossConfig(max_positives=max_positives)
    cfg = LossConfig(max_positives=max_positives)

    def jfn(lg, ds, fl):
        raw = JaxRaw(lg, ds, fl, j(anchors), j(pts), counts, j(stride))
        return jax_loss(jflame, raw, JaxTargets(*map(j, tg)), jcfg)

    (jtotal, jcomp), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        j(logits), j(distri), j(flame))

    xs = [t(x).requires_grad_(True) for x in (logits, distri, flame)]
    raw = RawOutputs(*xs, t(anchors), t(pts), counts, t(stride))
    total, comp = yolo_heads_loss(tflame, raw, Targets(*map(t, tg)), cfg)
    total.backward()

    assert int(comp["num_pos"]) == int(jcomp["num_pos"])
    assert int(comp["num_pos_dropped"]) == int(jcomp["num_pos_dropped"])
    if case == "overflow":
        assert int(comp["num_pos_dropped"]) > 0
    if case == "all_padding":
        assert int(comp["num_pos"]) == 0
    else:
        assert int(comp["num_pos"]) > 0
    for name in COMPONENT_NAMES:
        want = float(jcomp[name])
        np.testing.assert_allclose(float(comp[name]), want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    for x, g, name in zip(xs, jgrads, ("cls", "reg", "flame")):
        g = np.asarray(g)
        assert np.isfinite(x.grad.numpy()).all(), name
        np.testing.assert_allclose(x.grad.numpy(), g, atol=1e-4 * max(np.abs(g).max(), 1e-6),
                                   err_msg=name)
