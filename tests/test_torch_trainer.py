"""The port's training surroundings against the JAX package on the CPU: the
rendered synthetic dataset and its collate, the post-prediction decode and
the three validation metrics, the config loader, key-matching restore, the
``Trainer`` with checkpoint and resume, and random initialisation in the
detectors.

Bars: rendered images of the JAX dataset and the port's at 64 px byte-equal;
GT vertices to 1e-3 px, boxes to 1e-3 px, rotations to 1e-5; collate
equal.  Post-prediction: the same detections, boxes and scores to 1e-5,
vertices to 1e-3 px; the metrics to relative 1e-4.  Configs: equal dicts
and equal typed configs.  Trainer: a run cut after one epoch and resumed
equals the run that was not cut, exactly (parameters, EMA, BatchNorm
statistics, Adam moments, step; on the CPU the steps are deterministic).
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu import config as jconfig
from head_detector_tpu import metrics as jmetrics
from head_detector_tpu.flame import FlameModel as JaxFlameModel
from head_detector_tpu.models.heads import DecodedPredictions as JaxDecoded
from head_detector_tpu.post_prediction import YoloHeadsPostPredictionCallback as JaxCallback
from head_detector_tpu.train.dataset import SyntheticHeadsDataset as JaxDataset
from head_detector_tpu.train.dataset import collate_samples as jax_collate
from head_detector_tpu_torch import config, metrics
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models import build_model
from head_detector_tpu_torch.models.heads import DecodedPredictions
from head_detector_tpu_torch.post_prediction import YoloHeadsPostPredictionCallback
from head_detector_tpu_torch.train.checkpoint import (
    CheckpointManager,
    average_trees,
    restore_key_matching,
)
from head_detector_tpu_torch.train.dataset import (
    SyntheticHeadsDataset,
    collate_samples,
    flat_collate_tensors_with_batch_index,
    undo_flat_collate_tensors_with_batch_index,
)
from head_detector_tpu_torch.train.loss import LossConfig
from head_detector_tpu_torch.train.runner import RunConfig, Trainer, _Prefetcher
from head_detector_tpu_torch.train.trainer import TrainConfig
from head_detector_tpu_torch.weights import load_variables
from test_model import TINY
from test_torch_options import port_arch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "flagship_ema.msgpack")
CONFIG_FILES = sorted(glob.glob(os.path.join(ROOT, "head_detector_tpu", "configs", "*.yaml")))
SIZE = 64


@pytest.fixture(scope="module")
def samples():
    jax_ds = JaxDataset(image_size=SIZE, length=3, max_heads=3, seed=5, render=True)
    ds = SyntheticHeadsDataset(image_size=SIZE, length=3, max_heads=3, seed=5, render=True,
                               device="cpu")
    return [jax_ds[i] for i in range(3)], [ds[i] for i in range(3)]


@pytest.mark.parametrize("index", [0, 1, 2])
def test_rendered_dataset_matches_jax(samples, index):
    want, got = samples[0][index], samples[1][index]
    assert got.image.shape == want.image.shape == (SIZE, SIZE, 3)
    assert got.image.dtype == np.uint8
    np.testing.assert_array_equal(got.image, want.image)
    assert (got.image.max(-1) > 100).any()  # heads drawn over the 40..100 noise
    np.testing.assert_allclose(got.vertices_2d, want.vertices_2d, atol=1e-3)
    np.testing.assert_allclose(got.vertices_3d, want.vertices_3d, atol=1e-5)
    np.testing.assert_allclose(got.rotation_matrix, want.rotation_matrix, atol=1e-5)
    np.testing.assert_allclose(got.bboxes_xywh, want.bboxes_xywh, atol=1e-3)
    np.testing.assert_allclose(got.areas, want.areas, rtol=1e-4)


def test_collate_matches_jax(samples):
    want_images, want = jax_collate(samples[0], 5)
    got_images, got = collate_samples(samples[0], 5)
    np.testing.assert_array_equal(got_images, want_images)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    flat = flat_collate_tensors_with_batch_index([s.bboxes_xywh for s in samples[1]])
    back = undo_flat_collate_tensors_with_batch_index(flat, 3)
    for s, b in zip(samples[1], back):
        np.testing.assert_array_equal(s.bboxes_xywh, b)


def test_dataset_is_cached_and_thread_safe():
    """Rendered samples are cached; the prefetcher renders from 4 threads
    and yields every batch of the epoch in order."""
    ds = SyntheticHeadsDataset(image_size=SIZE, length=8, max_heads=2, seed=2, render=True,
                               device="cpu")
    loader = _Prefetcher(ds, 2, 3, num_workers=4, seed=0)
    batches = list(loader)
    assert len(batches) == 4 and len(ds._cache) == 8
    assert ds[3] is ds[3]
    order = np.random.RandomState(0).permutation(8)
    np.testing.assert_array_equal(batches[1][0][0], ds[order[2]].image)


def test_prefetcher_raises_loader_errors_and_stops_early():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"sample {i}")

    with pytest.raises(KeyError):
        list(_Prefetcher(Broken(), 2, 3, num_workers=2))
    ds = SyntheticHeadsDataset(image_size=SIZE, length=8, max_heads=1, device="cpu")
    for _ in _Prefetcher(ds, 2, 3, num_workers=2):
        break  # the producer thread is joined on the way out


# -------------------------------------------------------- validation decode
def _predictions(samples, seed=0):
    """Decoded predictions near the GT heads of ``samples``: per image, one
    anchor row per head with its true box and params plus noise, and random
    low-score rows elsewhere."""
    rng = np.random.RandomState(seed)
    b, a = len(samples), 20
    boxes = rng.uniform(0, SIZE, (b, a, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(2, 10, (b, a, 2))
    scores = rng.uniform(0, 0.4, (b, a, 1)).astype(np.float32)
    params = (rng.randn(b, a, 413) * 0.1).astype(np.float32)
    params[..., 409:411] = rng.uniform(0, SIZE, (b, a, 2))
    params[..., 412] = 20.0
    from head_detector_tpu_torch.train.dataset import scene_params

    for i, s in enumerate(samples):
        truth, _ = scene_params(5, i, SIZE, 3)
        for h in range(len(s.bboxes_xywh)):
            x, y, w, hh = s.bboxes_xywh[h]
            boxes[i, h] = [x, y, x + w, y + hh] + rng.uniform(-1, 1, 4)
            scores[i, h] = 0.9 - 0.1 * h
            params[i, h] = truth[h] + rng.randn(413).astype(np.float32) * 0.02
    return boxes, scores, params


def test_post_prediction_and_metrics_match_jax(samples):
    gt = samples[1]
    boxes, scores, params = _predictions(gt)
    kw = dict(confidence_threshold=0.5, nms_iou_threshold=0.7, pre_nms_max_predictions=16,
              post_nms_max_predictions=8)
    jcb = JaxCallback(flame_model=JaxFlameModel.from_assets(), **kw)
    tcb = YoloHeadsPostPredictionCallback(flame_model=FlameModel.from_assets(device="cpu"),
                                          **kw)
    want = jcb(JaxDecoded(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(params)))
    got = tcb(DecodedPredictions(*map(torch.from_numpy, (boxes, scores, params))))
    assert [len(p.scores) for p in got] == [len(p.scores) for p in want]
    assert sum(len(p.scores) for p in got) >= 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.bboxes_xyxy, w.bboxes_xyxy, atol=1e-5)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-5)
        np.testing.assert_allclose(g.mm_params, w.mm_params, atol=1e-5)
        np.testing.assert_allclose(g.predicted_2d_vertices, w.predicted_2d_vertices, atol=1e-3)
        np.testing.assert_allclose(g.predicted_3d_vertices, w.predicted_3d_vertices, atol=1e-5)

    decoded_j = JaxDecoded(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(params))
    decoded_t = DecodedPredictions(*map(torch.from_numpy, (boxes, scores, params)))
    for name, args in (("KeypointsNME", {"indexes_subset": "head"}),
                       ("KeypointsFailureRate", {"indexes_subset": "head"}),
                       ("RPYError", {})):
        mj = getattr(jmetrics, name)(jcb, **args)
        mt = getattr(metrics, name)(tcb, **args)
        mj.update(decoded_j, samples[0])
        mt.update(decoded_t, gt)
        vj, vt = mj.compute(), mt.compute()
        if isinstance(vj, dict):
            assert vj.keys() == vt.keys()
            for k in vj:
                np.testing.assert_allclose(vt[k], vj[k], rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(vt, vj, rtol=1e-4, err_msg=name)
        assert mt.total_tp == mj.total_tp > 0


def test_matching_and_rpy_helpers_match_jax():
    rng = np.random.RandomState(1)
    a, b = rng.uniform(0, 50, (6, 4)), rng.uniform(0, 50, (4, 4))
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    b[0] = a[2] + 0.5
    got, want = metrics.match_head_boxes(a, b, 0.5), jmetrics.match_head_boxes(a, b, 0.5)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    row = rng.randn(413).astype(np.float32)
    np.testing.assert_allclose(metrics.rpy_from_flame_params(row),
                               jmetrics.rpy_from_flame_params(row), atol=1e-3)
    rot = np.linalg.qr(rng.randn(3, 3))[0]
    assert metrics.rpy_from_rotation_mat(rot) == jmetrics.rpy_from_rotation_mat(rot)
    kp = rng.randn(30, 2)
    assert metrics.keypoints_nme(kp, kp + 1, np.array([0, 0, 4, 9.0])) == \
        jmetrics.keypoints_nme(kp, kp + 1, np.array([0, 0, 4, 9.0]))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("path", CONFIG_FILES, ids=os.path.basename)
def test_config_loader_matches_jax(path):
    overrides = ["training_hyperparams.initial_lr=1e-4", "dataset_params.render=true",
                 "pretrained_weights=checkpoints/flagship_ema.msgpack"]
    got = config.load_config(path, overrides)
    want = jconfig.load_config(path, overrides)
    assert got == want
    rc, rj = config.run_config_from_dict(got), jconfig.run_config_from_dict(want)
    train_j = dataclasses.asdict(rj.train)
    assert train_j.pop("grad_clip_norm") is None  # no config clips: not ported
    assert dataclasses.asdict(rc.train) == train_j
    lc, lj = dataclasses.asdict(rc.loss), dataclasses.asdict(rj.loss)
    np.testing.assert_array_equal(lc.pop("indexes_subset"), lj.pop("indexes_subset"))
    assert lc == lj
    for f in dataclasses.fields(rc):
        if f.name not in ("loss", "train") and hasattr(rj, f.name):
            assert getattr(rc, f.name) == getattr(rj, f.name), f.name


def test_key_matching_restores_the_flax_checkpoint():
    """The shipped msgpack tree restores every entry of the training-layout
    yolo_heads_m; a port state dict restores the same way; a wrong shape is
    skipped."""
    net = build_model("yolo_heads_m", deploy=False)
    target = net.state_dict()
    merged, matched, total = restore_key_matching(target, load_variables(CKPT))
    assert matched == total == sum(1 for k in target if not k.endswith("num_batches_tracked"))
    again, matched2, _ = restore_key_matching(target, merged)
    assert matched2 == total
    wrong = dict(merged)
    wrong["heads.head1.cls_pred.weight"] = torch.zeros(3, 3)
    _, matched3, _ = restore_key_matching(target, wrong)
    assert matched3 == total - 1


# ------------------------------------------------------------------ Trainer
def _run_cfg(tmp_path, **kw):
    # 16 FLAME rows and one loader thread keep the run short on a loaded CPU
    return RunConfig(arch=port_arch(TINY), image_size=SIZE, batch_size=2, max_epochs=2,
                     steps_per_epoch=2, max_gt_boxes=4, num_workers=1, mixed_precision=False,
                     ckpt_dir=str(tmp_path), log_every=1, loss=LossConfig(max_positives=16),
                     train=TrainConfig(lr_warmup_steps=1, initial_lr=1e-3), **kw)


def test_trainer_resume_equals_uninterrupted(tmp_path):
    def datasets():
        kw = dict(image_size=SIZE, max_heads=2, render=True, device="cpu")
        return (SyntheticHeadsDataset(length=4, **kw),
                SyntheticHeadsDataset(length=2, seed=1, **kw))

    whole = Trainer(_run_cfg(tmp_path / "whole"), *datasets(), device="cpu")
    metrics_whole = whole.train()
    assert whole.state.step == 4 and len(whole.history) == 2
    assert {"KeypointsNME", "KeypointsFailureRate", "RPYError"} <= set(metrics_whole)
    assert all(np.isfinite(float(c["loss"])) for c in whole.step_components)

    cut = Trainer(_run_cfg(tmp_path / "cut", epochs_per_run=1), *datasets(), device="cpu")
    cut.train()
    assert cut.state.step == 2
    ckpt = CheckpointManager(str(tmp_path / "cut"))
    assert ckpt.latest_step() == 2 and ckpt.best_step() == 2
    resumed = Trainer(_run_cfg(tmp_path / "cut", resume=True), *datasets(), device="cpu")
    saved = ckpt.restore(2)
    for k, v in saved["ema_params"].items():
        assert torch.equal(resumed.state.ema[k], v), k
    assert resumed.state.step == 2
    resumed.train()

    a, b = whole.state.state_dict(), resumed.state.state_dict()
    assert a["step"] == b["step"] == 4
    for part in ("params", "batch_stats", "ema_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for i, s in a["opt_state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[k], b["opt_state"]["state"][i][k]), (i, k)
    manager = CheckpointManager(str(tmp_path / "cut"))
    assert manager.all_steps() == [2, 4] and len(manager.metrics_history()) == 2
    history = {r["step"]: r["KeypointsNME"] for r in manager.metrics_history()}
    assert sorted(manager.best_steps(5)) == [2, 4]
    assert manager.best_steps(1) == [min(history, key=history.get)]
    two, four = manager.restore(2), manager.restore(4)
    avg = average_trees([two, four])
    for k, v in avg["params"].items():
        want = (two["params"][k].double() + four["params"][k].double()) / 2
        torch.testing.assert_close(v, want.to(v.dtype), rtol=0, atol=0)
    assert avg["step"] == 2


def test_entry_point_needs_a_card_unless_told():
    from head_detector_tpu_torch.train.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--config-name", "yolo_heads_m"])


# -------------------------------------------------- random init in detectors
@pytest.fixture
def tiny_preset(monkeypatch):
    """The port finds the TINY arch by the name "tiny"; no checkpoint is set."""
    from head_detector_tpu_torch.models import presets
    from head_detector_tpu_torch.train.dataset import render_scene

    monkeypatch.delenv("HDT_CHECKPOINT", raising=False)
    monkeypatch.setitem(presets.PRESETS, "tiny", port_arch(TINY))
    return render_scene(5, 0, size=128, max_heads=3, device="cpu")


def test_random_init_head_detector(tiny_preset):
    """Without a checkpoint the detector initialises the training layout
    (calibrated): finite boxes, scores and meshes, and deploy=False agrees
    with the fused model to 1e-2 in score (tests/test_export.py's bar)."""
    from head_detector_tpu_torch.detector import HeadDetector

    scene = tiny_preset
    fused = HeadDetector(model="tiny", image_size=SIZE, device="cpu")
    unfused = HeadDetector(model="tiny", image_size=SIZE, device="cpu", deploy=False)
    a = fused.predict_batch([scene], confidence_threshold=0.0, max_detections=5)[0]
    b = unfused.predict_batch([scene], confidence_threshold=0.0, max_detections=5)[0]
    assert len(a.heads) == len(b.heads) > 0
    for ha, hb in zip(a.heads, b.heads):
        assert np.isfinite(ha.vertices_3d).all() and np.isfinite(hb.vertices_3d).all()
        assert np.isfinite(ha.score) and abs(ha.score - hb.score) <= 1e-2


def test_random_init_streaming_detector(tiny_preset):
    """Without variables or a checkpoint the stream initialises, calibrates
    and fuses the training layout: finite boxes and scores."""
    from head_detector_tpu_torch.pipeline import StreamingDetector

    scene = tiny_preset
    stream = StreamingDetector(model_name="tiny", image_size=SIZE, batch_size=2,
                               dtype=torch.float32, verts_dtype=torch.float32,
                               confidence_threshold=0.0, decode_budget=4, workers=1,
                               device="cpu")
    out = list(stream.run([scene, scene]))
    assert len(out) == 2 and out[0]["valid"].any()
    assert np.isfinite(out[0]["boxes_xyxy"]).all() and np.isfinite(out[0]["scores"]).all()
    assert all(bool(torch.isfinite(v).all()) for v in out[0]["vertices"].values())


def test_shared_state_survives_loader_threads():
    """16 threads (more than the cores) enter and leave ``exact_float32``
    and ask for the scene tables at once, with a short switch interval:
    the TF32 flags come back as they were, and every thread gets the same
    tables (one index-range read per device)."""
    import sys
    import threading

    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.train import dataset

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    dataset._TABLES.pop(torch.device("cpu"), None)
    seen, inside = [], []
    barrier = threading.Barrier(16)

    def work():
        barrier.wait(timeout=30)
        for _ in range(200):
            with exact_float32():
                inside.append(torch.backends.cudnn.allow_tf32)
        seen.append(dataset.scene_tables(torch.device("cpu")))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 16 and len(inside) == 16 * 200
    assert not any(inside)  # TF32 off inside every block
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
    assert all(s[0] is seen[0][0] and s[1] is seen[0][1] for s in seen)
