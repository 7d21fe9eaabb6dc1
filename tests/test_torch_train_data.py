"""The port's on-disk training data path against the JAX package on the CPU:
``train/transforms.py`` (geometric and photometric), ``decode_dad_annotation``
and ``DAD3DHeadsDataset``, ``check_dataset``, the extreme-batch panels and
the TensorBoard logger, ``hostlock``, and ``build_trainer`` with
``dataset_params.data_dir`` on both wires.

Every test draws from its own ``np.random.RandomState`` (and seeds Python's
``random`` where the corrupt-image fallback draws from it).  Bars: the same
``RandomState`` gives bit-equal images and geometry within 1e-5 (the same
numpy and cv2 calls in one process); ``decode_dad_annotation`` within 1e-5
of each output's largest magnitude (float32 FLAME decode, TF32 off);
``DAD3DHeadsDataset`` equal to the JAX reader sample by sample to the same
bars; ``check_dataset`` the same report; the panels written by the two
packages' callbacks byte-equal.
"""

import dataclasses
import os
import random

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from head_detector_tpu import config as jconfig
from head_detector_tpu import hostlock as jhostlock
from head_detector_tpu.flame import FlameModel as JaxFlameModel
from head_detector_tpu.train import dataset as jdataset
from head_detector_tpu.train import transforms as jtr
from head_detector_tpu.train import visualization as jviz
from head_detector_tpu.train.check_dataset import check_dataset as jax_check_dataset
from head_detector_tpu.train.mesh_sample import MeshEstimationSample as JaxSample
from head_detector_tpu_torch import config, hostlock
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.tools.render_synthetic_dataset import render_split
from head_detector_tpu_torch.train import dataset as tdataset
from head_detector_tpu_torch.train import transforms as ttr
from head_detector_tpu_torch.train import visualization as tviz
from head_detector_tpu_torch.train.check_dataset import check_dataset
from head_detector_tpu_torch.train.mesh_sample import MeshEstimationSample
from head_detector_tpu_torch.train.param_wire import (
    ParamTargets,
    RenderedHeadsDataset,
    collate_param_samples,
)
from head_detector_tpu_torch.train.runner import _is_param_dataset, _Prefetcher
from test_model import TINY
from test_torch_options import port_arch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 96
GEOMETRY = ("vertices_2d", "vertices_3d", "rotation_matrix", "areas", "bboxes_xywh")


def _sample_arrays(seed, n=3, h=80, w=120):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 255, (h, w, 3), np.uint8)
    v2d = np.concatenate([rng.uniform(0, [w, h], (n, 40, 2)), np.ones((n, 40, 1))],
                         -1).astype(np.float32)
    lo, hi = v2d[..., :2].min(1), v2d[..., :2].max(1)
    boxes = np.concatenate([lo, hi - lo], 1).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return dict(image=image, vertices_2d=v2d,
                vertices_3d=rng.randn(n, 40, 3).astype(np.float32),
                rotation_matrix=q.astype(np.float32), areas=boxes[:, 2] * boxes[:, 3],
                bboxes_xywh=boxes, is_crowd=np.zeros(n, bool))


def _copy(arrays, cls):
    return cls(**{k: v.copy() for k, v in arrays.items()})


def _assert_same(got, want):
    np.testing.assert_array_equal(got.image, want.image)
    for f in GEOMETRY + ("is_crowd",):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)


TRANSFORMS = {
    "longest_max_size": lambda m, r: m.MeshLongestMaxSize(64, 64, rng=r),
    "pad_bottom_right": lambda m, r: m.MeshPadIfNeeded(128, 144, 127, "bottom_right"),
    "pad_center": lambda m, r: m.MeshPadIfNeeded(128, 144, 127, "center"),
    "random_affine": lambda m, r: m.MeshRandomAffineTransform(prob=1.0, rng=r),
    "random_rotate90": lambda m, r: m.MeshRandomRotate90(prob=1.0, rng=r),
    "default_train": lambda m, r: m.default_train_transforms(SIZE, rng=r),
    "default_val": lambda m, r: m.default_val_transforms(SIZE),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_geometric_transforms_match_jax(name):
    for seed in range(4):
        arrays = _sample_arrays(10 + seed)
        got = TRANSFORMS[name](ttr, np.random.RandomState(seed)).apply_to_sample(
            _copy(arrays, MeshEstimationSample))
        want = TRANSFORMS[name](jtr, np.random.RandomState(seed)).apply_to_sample(
            _copy(arrays, JaxSample))
        _assert_same(got, want)


def test_apply_to_matrix_and_box_helpers_match_jax():
    rng = np.random.RandomState(5)
    mats = np.linalg.qr(rng.randn(4, 3, 3))[0].astype(np.float32)
    for angle in (-90.0, 12.5, 180.0):
        np.testing.assert_array_equal(ttr.MeshRandomAffineTransform.apply_to_matrix(mats, angle),
                                      jtr.MeshRandomAffineTransform.apply_to_matrix(mats, angle))
    boxes = np.abs(rng.randn(5, 4)).astype(np.float32) * 20
    np.testing.assert_array_equal(ttr.xywh_to_xyxy(boxes), jtr.xywh_to_xyxy(boxes))
    np.testing.assert_array_equal(ttr.xyxy_to_xywh(boxes), jtr.xyxy_to_xywh(boxes))
    for k in (1, 2, 3):
        np.testing.assert_array_equal(ttr.MeshRandomRotate90.apply_to_bboxes(boxes, k, 60, 90),
                                      jtr.MeshRandomRotate90.apply_to_bboxes(boxes, k, 60, 90))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_photometric_augs_match_jax(seed):
    image = np.random.RandomState(100 + seed).randint(0, 255, (72, 88, 3), np.uint8)
    got_aug = ttr.PhotometricAugs(rng=np.random.RandomState(seed))
    want_aug = jtr.PhotometricAugs(rng=np.random.RandomState(seed))
    changed = 0
    for _ in range(24):  # enough draws to reach every branch family
        got, want = got_aug(image), want_aug(image)
        np.testing.assert_array_equal(got, want)
        changed += not np.array_equal(got, image)
    assert changed > 0


# ---------------------------------------------------------------- DAD decode
@pytest.fixture(scope="module")
def flames():
    return JaxFlameModel.from_assets(), FlameModel.from_assets(device="cpu")


def test_decode_dad_annotation_matches_jax(flames):
    rng = np.random.RandomState(7)
    params = (rng.randn(8, 413) * 0.2).astype(np.float32)
    params[:, 409:411] = rng.uniform(-0.2, 0.2, (8, 2))
    params[:, 412] = rng.uniform(1.0, 4.0, 8)
    want = jdataset.decode_dad_annotation(flames[0], jnp.asarray(params))
    got = tdataset.decode_dad_annotation(flames[1], params)
    for name, g, w in zip(("vertices", "projected", "rotation"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
    empty = tdataset.decode_dad_annotation(flames[1], params[:0])
    assert [tuple(x.shape) for x in empty] == [(0, 5023, 3), (0, 5023, 2), (0, 3, 3)]


# ------------------------------------------------------------- dense reader
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Splits rendered by the port at 96 px: ``train`` (5 scenes, a
    ``files.txt`` exclusion and a ``val_files.txt`` keep-list), ``val`` (4)
    and ``broken`` (two of train's scenes and a corrupt image)."""
    import shutil

    root = str(tmp_path_factory.mktemp("rendered"))
    render_split(root, "train", 5, SIZE, device="cpu", log_every=0)
    render_split(root, "val", 4, SIZE, seed=1, device="cpu", log_every=0)
    train, broken = os.path.join(root, "train"), os.path.join(root, "broken")
    with open(os.path.join(train, "files.txt"), "w") as f:
        f.write("000004.jpg\n")
    with open(os.path.join(train, "val_files.txt"), "w") as f:
        f.write("000000.jpg\n000002.jpg\n")
    for sub, ext in (("images", ".jpg"), ("annotations", ".npz")):
        os.makedirs(os.path.join(broken, sub))
        for i in range(3):
            shutil.copy(os.path.join(train, sub, f"00000{i}{ext}"),
                        os.path.join(broken, sub, f"00000{i}{ext}"))
    with open(os.path.join(broken, "images", "000001.jpg"), "wb") as f:
        f.write(b"not a jpeg")
    return root


def test_file_lists_match_jax(data_dir):
    train = os.path.join(data_dir, "train")
    for mode in (None, "val"):
        got = tdataset.DAD3DHeadsDataset.get_images_and_annotations(train, mode=mode)
        assert got == jdataset.DAD3DHeadsDataset.get_images_and_annotations(train, mode=mode)
    images, _ = tdataset.DAD3DHeadsDataset.get_images_and_annotations(train)
    assert [os.path.basename(i) for i in images] == [f"00000{i}.jpg" for i in range(4)]
    got, _ = tdataset.DAD3DHeadsDataset.get_images_and_annotations(train, mode="val")
    assert [os.path.basename(i) for i in got] == ["000000.jpg", "000002.jpg"]


@pytest.mark.parametrize("chain", ["val", "train"])
def test_dense_reader_matches_jax(data_dir, flames, chain):
    def reader(mod, flame):
        if chain == "val":
            kw = dict(transforms=mod[1].default_val_transforms(SIZE))
        else:
            kw = dict(transforms=mod[1].default_train_transforms(SIZE, np.random.RandomState(4)),
                      photometric=mod[1].PhotometricAugs(rng=np.random.RandomState(6)))
        return mod[0].DAD3DHeadsDataset(data_dir, splits=["train", "val", "broken"],
                                        flame_model=flame, **kw)

    got_ds = reader((tdataset, ttr), flames[1])
    want_ds = reader((jdataset, jtr), flames[0])
    assert got_ds.flame_model.device.type == "cpu"
    assert len(got_ds) == len(want_ds) == 11
    # index 9 is corrupt: the reader re-picks at random, here from a seed
    # whose first pick is a good image (a second corrupt pick reads None,
    # in the reference as well)
    seed = next(k for k in range(100) if random.Random(k).randint(0, len(got_ds) - 1) != 9)
    for i in range(len(got_ds)):
        random.seed(seed)
        got = got_ds[i]
        random.seed(seed)
        want = want_ds[i]
        assert isinstance(got, MeshEstimationSample)
        assert got.image.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(got.image, want.image)
        for f in GEOMETRY:
            a, b = getattr(got, f), getattr(want, f)
            assert a.shape == b.shape, f
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1),
                                       err_msg=f)


def test_check_dataset_same_report(data_dir, flames, capsys):
    kw = dict(splits=["val"])
    got = check_dataset(tdataset.DAD3DHeadsDataset(
        data_dir, transforms=ttr.default_val_transforms(SIZE), flame_model=flames[1], **kw), 4)
    want = jax_check_dataset(jdataset.DAD3DHeadsDataset(
        data_dir, transforms=jtr.default_val_transforms(SIZE), flame_model=flames[0], **kw), 4)
    assert got == want and got["checked"] == 4 and got["heads"] > 4
    params_ds = RenderedHeadsDataset(data_dir, **kw)
    params = check_dataset(params_ds, 4)
    assert params == {"checked": 4, "heads": got["heads"], "problems": []}
    # faults: a box of area < 1 and non-finite values, in both sample forms
    dense = _copy(_sample_arrays(3), MeshEstimationSample)
    dense.bboxes_xywh[0, 2:] = 0.5
    dense.vertices_3d[1, 0, 0] = np.nan
    dense_j = _copy({k: getattr(dense, k) for k in _sample_arrays(3)}, JaxSample)
    params = params_ds[0]
    params.params[0, 0] = np.inf
    params.bboxes_xywh[0, 2:] = 0.1
    want = [(0, "bbox area < 1"), (0, "non-finite vertices_3d")]
    assert check_dataset([dense])["problems"] == jax_check_dataset([dense_j])["problems"] == want
    assert check_dataset([params])["problems"] == [(0, "bbox area < 1"), (0, "non-finite params")]
    assert "[check_dataset] 4 samples" in capsys.readouterr().out


def test_prefetcher_takes_the_params_collate(data_dir):
    ds = RenderedHeadsDataset(data_dir, splits=["train", "val"])
    assert _is_param_dataset(ds) and not _is_param_dataset(object())
    batches = list(_Prefetcher(ds, 2, 4, num_workers=2, seed=1, collate_fn=collate_param_samples))
    assert len(batches) == 4
    order = np.random.RandomState(1).permutation(len(ds))
    images, targets = batches[1]
    assert isinstance(targets, ParamTargets) and isinstance(targets.gt_flame, np.ndarray)
    np.testing.assert_array_equal(images[0], ds[order[2]].image)


# ------------------------------------------------------------ visualization
def _batch(seed, n=2, s=48):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (n, s, s, 3), np.uint8)
    gt = np.array([[[5, 5, 30, 30], [0, 0, 0, 0]]] * n, np.float32)
    mask = np.array([[1.0, 0.0]] * n, np.float32)
    kps = rng.rand(n, 2, 10, 3).astype(np.float32) * s
    return images, gt, mask, kps


def test_extreme_batch_panels_match_jax(tmp_path):
    def predict(images):
        n = len(images)
        return (np.tile(np.array([[6, 6, 28, 28]], np.float32), (n, 1, 1)),
                np.full((n, 1), 0.9, np.float32))

    seen = {}
    for name, mod in (("port", tviz), ("jax", jviz)):
        cb = mod.ExtremeBatchVisualizationCallback(str(tmp_path / name), freq=2)
        for loss, seed in ((1.0, 0), (5.0, 1), (2.0, 2)):
            images, gt, mask, kps = _batch(seed)
            cb.update(loss, images, gt, mask, gt_keypoints=kps)
        cb.on_epoch_end(1)  # 1 % 2: skipped, and the state resets
        assert cb._extreme is None and not os.listdir(tmp_path / name)
        for loss, seed in ((1.0, 0), (5.0, 1), (2.0, 2)):
            images, gt, mask, kps = _batch(seed)
            cb.update(loss, images, gt, mask, gt_keypoints=kps)
        calls = {}

        def predict_fn(images):
            calls["images"] = images
            return predict(images)

        cb.on_epoch_end(2, predict_fn=predict_fn)
        np.testing.assert_array_equal(calls["images"], _batch(1)[0])  # the max-loss batch
        assert cb._extreme is None
        seen[name] = open(tmp_path / name / "extreme_batch_epoch2.jpg", "rb").read()
    assert seen["port"] == seen["jax"]


def test_tensorboard_logger_writes_events(tmp_path):
    tb = tviz.TensorBoardLogger(str(tmp_path))
    tb.log_scalars({"loss": 1.0, "loss_cls": 0.5}, step=1, prefix="train/")
    tb.log_image("panel", np.zeros((8, 8, 3), np.uint8), 1)
    tb.close()
    assert any("tfevents" in f for f in os.listdir(tmp_path))


# ------------------------------------------------------------------ hostlock
def test_hostlock_protocol_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "campaign.lock")
    monkeypatch.setenv("HDT_CAMPAIGN_LOCK", path)
    monkeypatch.setattr(jhostlock, "LOCK_PATH", path)
    assert hostlock.lock_path() == path
    assert not hostlock.campaign_active()
    hostlock.acquire()
    assert open(path).read() == str(os.getpid())
    assert hostlock.campaign_active() and jhostlock.campaign_active()
    assert hostlock.wait_until_free(0.05, poll_s=0.01) and jhostlock.wait_until_free(0.05, 0.01)
    hostlock.release()
    assert not os.path.exists(path) and not jhostlock.campaign_active()
    assert not hostlock.wait_until_free(0.05) and not jhostlock.wait_until_free(0.05)
    jhostlock.acquire()  # the reference's lock is read by the port, and released by it
    assert hostlock.campaign_active()
    hostlock.release()
    assert not os.path.exists(path)
    hostlock.acquire(pid=2**22 + 12345)  # a dead holder: stale, removed
    assert not hostlock.campaign_active() and not os.path.exists(path)


# --------------------------------------------------------------- entry point
def test_flagship_configs_map_every_run_key():
    for name in ("flagship_campaign", "flagship_r5_ext"):
        path = os.path.join(config.CONFIG_DIR, f"{name}.yaml")
        overrides = ["log_dir=/logs", "visualization_frequency_epochs=3"]
        got = config.run_config_from_dict(config.load_config(path, overrides))
        want = jconfig.run_config_from_dict(jconfig.load_config(path, overrides))
        port_fields = {f.name for f in dataclasses.fields(got)}
        assert {f.name for f in dataclasses.fields(want)} - port_fields == set()
        for f in port_fields - {"loss", "train"}:
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert got.log_dir == "/logs" and got.visualization_frequency_epochs == 3
        assert (got.arch, got.image_size, got.batch_size, got.max_gt_boxes) == \
            ("yolo_heads_m", 512, 16, 4)


@pytest.mark.parametrize("wire", ["true", "false"])
def test_build_trainer_with_data_dir(data_dir, tmp_path, monkeypatch, wire):
    """The flagship configuration on the CPU, cut to the TINY arch at 96 px:
    one step on each wire, validation on the cached dense reader, a
    checkpoint, the TensorBoard scalars and an extreme-batch panel."""
    from head_detector_tpu_torch.models import presets
    from head_detector_tpu_torch.train.__main__ import _CachedDataset, build_trainer

    monkeypatch.setitem(presets.PRESETS, "tiny", port_arch(TINY))
    monkeypatch.setenv("HDT_CAMPAIGN_LOCK", str(tmp_path / "lock"))
    logs = str(tmp_path / "logs")
    trainer = build_trainer([
        "--config-name", "flagship_campaign", "--device", "cpu",
        f"dataset_params.data_dir={data_dir}", f"dataset_params.params_wire={wire}",
        "architecture=tiny", f"dataset_params.image_size={SIZE}", "dataset_params.batch_size=2",
        "dataset_params.num_workers=2", "steps_per_epoch=1", "training_hyperparams.max_epochs=1",
        "training_hyperparams.mixed_precision=false", f"ckpt_root_dir={tmp_path}",
        "log_every=1", f"log_dir={logs}", "visualization_frequency_epochs=1"])
    want_type = RenderedHeadsDataset if wire == "true" else tdataset.DAD3DHeadsDataset
    assert type(trainer.train_dataset) is want_type
    assert isinstance(trainer.val_dataset, _CachedDataset)
    metrics = trainer.train()
    assert trainer.state.step == 1 and trainer.ckpt.latest_step() == 1
    assert np.isfinite(float(trainer.step_components[0]["loss"]))
    assert {"KeypointsNME", "KeypointsFailureRate", "RPYError"} <= set(metrics)
    assert len(trainer.val_dataset._cache) == 4
    assert not os.path.exists(tmp_path / "lock")  # a CPU run takes no host lock
    if wire == "true":
        assert trainer.train_dataset._epoch == 0
    files = os.listdir(logs)
    assert "extreme_batch_epoch0.jpg" in files and any("tfevents" in f for f in files)
    panel = cv2.imread(os.path.join(logs, "extreme_batch_epoch0.jpg"))
    assert panel.shape == (2 * SIZE, 2 * SIZE, 3)


def test_dense_dataset_is_thread_safe(data_dir, flames):
    """The dense reader's CPU decode from 4 loader threads gives what one
    thread gives."""
    ds = tdataset.DAD3DHeadsDataset(data_dir, splits=["val"], flame_model=flames[1],
                                    transforms=ttr.default_val_transforms(SIZE))
    one = [ds[i] for i in range(len(ds))]
    order = np.random.RandomState(0).permutation(len(ds))
    for _ in range(3):
        batches = list(_Prefetcher(ds, 1, 4, num_workers=4, seed=0))
        assert len(batches) == len(ds)
        for (images, targets), i in zip(batches, order):
            np.testing.assert_array_equal(images[0], one[i].image)
            n = len(one[i].bboxes_xywh)
            np.testing.assert_array_equal(targets.gt_vertices_3d[0, :n], one[i].vertices_3d)
