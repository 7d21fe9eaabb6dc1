"""Weights in and out of the port, against the JAX package on the CPU: the
flax-msgpack writer, the export of a training step directory
(``tools/eval_checkpoint``), SuperGradients state dicts through both
packages' ``load_variables`` and the port's converter CLI, and the host
lock's default path.

Bars: ``save_variables`` byte-equal to ``flax.serialization.msgpack_serialize``
(float32 and float16 trees) and read back leaf-equal by both packages; the
shipped checkpoint's round trip through the port's training-layout state
dict byte-equal to the shipped file; an exported step served by the JAX and
the port's ``HeadDetector`` at the bars of ``test_torch_options.py`` (box
IoU >= 0.99, score |d| <= 1e-4, posed-vertex relative L2 <= 1e-3); the two
converters' trees of one SuperGradients state dict equal key for key and
bit for bit, with the same notes; a detector on the ``.pth`` equal to one on
the msgpack of the same weights.  Every test draws from its own
``np.random.RandomState``.
"""

import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from head_detector_tpu import torch_mirror
from head_detector_tpu.detector import HeadDetector as JaxHeadDetector
from head_detector_tpu.detector import _load_converter
from head_detector_tpu.detector import load_variables as jax_load_variables
from head_detector_tpu_torch import hostlock, weights
from head_detector_tpu_torch.detector import HeadDetector, random_variables
from head_detector_tpu_torch.models import build_model
from head_detector_tpu_torch.tools import convert_torch_checkpoint, eval_checkpoint
from head_detector_tpu_torch.train.checkpoint import CheckpointManager
from head_detector_tpu_torch.tools.render_synthetic_dataset import render_split
from head_detector_tpu_torch.train.dataset import render_scene
from head_detector_tpu_torch.train.trainer import TrainConfig, TrainState
from test_model import TINY
from test_torch_options import M_CHECKPOINT, assert_same, port_arch, tiny_preset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128
THRESHOLD = 0.03


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work in one thread for this module: the suite runs
    several test processes at once, and torch's default of one thread per
    core oversubscribes the cores (a yolo_heads_m forward at 256 px took
    51 s beside five busy processes, 0.4 s in one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def assert_trees_bit_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def tiny_variables():
    """The port's random TINY initialisation (seed 0, BatchNorm calibrated at
    64 px) as a flax tree of numpy arrays, which both packages read."""
    return random_variables(port_arch(TINY), 64, torch.device("cpu"))


@pytest.fixture(scope="module")
def scenes():
    scene = render_scene(11, 0, size=SIZE, max_heads=3, device="cpu")
    return [scene, scene[16:112, :].copy()]


# ------------------------------------------------------------ the writer
def _random_tree(rng, dtype):
    return {
        "params": {
            "zeta": {"kernel": rng.randn(3, 3, 4, 8).astype(dtype),
                     "bias": rng.randn(8).astype(dtype)},
            "alpha": np.asarray(rng.randn(), dtype),
            "beta": {"scale": rng.randn(5).astype(dtype)},
        },
        "batch_stats": {"beta": {"mean": rng.randn(5).astype(dtype),
                                 "var": rng.rand(5).astype(dtype)}},
        "counts": rng.randint(0, 9, (2, 3)).astype(np.int32),
        "flags": rng.rand(4) > 0.5,
        "step": np.int64(12),
        "lr": dtype(3e-4),
    }


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_save_variables_byte_equal_to_flax(dtype, tiny_variables, tmp_path):
    rng = np.random.RandomState(0)
    cast = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(dtype), tiny_variables)
    for tree in (_random_tree(rng, dtype), cast):
        want = serialization.msgpack_serialize(tree)
        assert weights.serialize_variables(tree) == want
        path = str(tmp_path / "w.msgpack")
        weights.save_variables(tree, path)
        with open(path, "rb") as f:
            assert f.read() == want
        assert_trees_bit_equal(jax_load_variables(path), tree)
        assert_trees_bit_equal(weights.load_variables(path), tree)
    # torch leaves are written as their numpy arrays
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, cast)
    assert weights.serialize_variables(as_tensors) == serialization.msgpack_serialize(cast)


def test_save_variables_refuses_what_the_reader_refuses(tmp_path):
    path = str(tmp_path / "bad.msgpack")
    with pytest.raises(ValueError, match="bfloat16"):
        weights.save_variables({"w": torch.zeros(2, dtype=torch.bfloat16)}, path)
    with pytest.raises(ValueError, match="complex"):
        weights.save_variables({"w": np.zeros(2, np.complex64)}, path)
    with pytest.raises(TypeError):
        weights.save_variables({"w": 1 + 2j}, path)
    big = np.broadcast_to(np.zeros(1, np.float32), (2**28 + 1,))  # 1 GiB + 4 bytes, not held
    with pytest.raises(ValueError, match="1 GiB"):
        weights.save_variables({"w": big}, path)
    assert not os.path.exists(path)


def test_shipped_checkpoint_round_trip(tmp_path):
    """msgpack -> the port's training-layout state dict -> flax tree ->
    float16 -> msgpack gives back the shipped file, byte for byte."""
    shipped = weights.load_variables(M_CHECKPOINT)
    state, used = weights.train_state_dict_from_flax(shipped)
    assert used == weights.count_leaves(shipped)
    back = eval_checkpoint.cast_float32_leaves(weights.flax_from_state_dict(state), np.float16)
    path = str(tmp_path / "m.msgpack")
    weights.save_variables(back, path)
    with open(path, "rb") as f, open(M_CHECKPOINT, "rb") as g:
        assert f.read() == g.read()


# ------------------------------------------------- step directory export
@pytest.fixture(scope="module")
def step_dir(tiny_variables, tmp_path_factory):
    """A TINY training state (JAX-initialised weights, an EMA that differs
    from them) saved by CheckpointManager at step 7."""
    model = build_model(port_arch(TINY), deploy=False)
    state, _ = weights.train_state_dict_from_flax(tiny_variables)
    model.load_state_dict(state, strict=True)
    train_state = TrainState(model, TrainConfig())
    rng = np.random.RandomState(1)
    train_state.ema = {
        k: v * torch.from_numpy(np.asarray(1 + 0.01 * rng.randn(*v.shape), np.float32))
        for k, v in train_state.ema.items()}
    train_state.step = 7
    root = str(tmp_path_factory.mktemp("steps"))
    CheckpointManager(root).save(7, train_state.state_dict(), metrics={"KeypointsNME": 1.0})
    return root, train_state


@pytest.mark.parametrize("which", ["raw", "ema"])
def test_step_export_served_by_both_packages(step_dir, scenes, which, tmp_path):
    root, train_state = step_dir
    out = str(tmp_path / f"{which}.msgpack")
    got = eval_checkpoint.main(["--ckpt-dir", root, "--arch", "tiny", "--which", which,
                                "--no-eval", "--export-msgpack", out, "--device", "cpu"])
    assert got == {}
    with open(out + ".json") as f:
        assert json.load(f) == {"arch": "tiny", "image_size": 320, "which": which,
                                "step": "7", "dtype": "f32"}
    params = train_state.params() if which == "raw" else train_state.ema
    want = weights.flax_from_state_dict({**params, **train_state.batch_stats()})
    assert_trees_bit_equal(jax_load_variables(out), want)

    with tiny_preset():
        jax_det = JaxHeadDetector(model="tiny", image_size=SIZE, checkpoint=out)
        det = HeadDetector(model="tiny", image_size=SIZE, checkpoint=out, device="cpu")
    assert det.restored_leaves[0] == det.restored_leaves[1]
    assert_same(det(scenes[0], THRESHOLD), jax_det(scenes[0], THRESHOLD))
    for g, w in zip(det.predict_batch(scenes, THRESHOLD),
                    jax_det.predict_batch(scenes, THRESHOLD)):
        assert_same(g, w)


def test_step_export_float16_is_the_shipped_file(tmp_path):
    """A yolo_heads_m step whose EMA is the shipped checkpoint's weights and
    whose raw parameters differ: ``--which ema --export-dtype f16`` writes
    the shipped file byte for byte (float16 -> float32 -> float16 is exact),
    which both packages' detectors serve alike
    (``test_torch_detector.py::test_shipped_m_checkpoint_matches_jax``; a
    random TINY network is too sensitive for float16 weights, whose reference
    fold runs in float16).  ``--which raw`` writes the other parameters."""
    model = build_model("yolo_heads_m", deploy=False)
    state, _ = weights.train_state_dict_from_flax(weights.load_variables(M_CHECKPOINT))
    model.load_state_dict(state, strict=True)
    train_state = TrainState(model, TrainConfig())  # the EMA starts as the weights
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    root = str(tmp_path / "steps")
    CheckpointManager(root).save(3, train_state.state_dict())
    out = str(tmp_path / "ema_f16.msgpack")
    eval_checkpoint.main(["--ckpt-dir", root, "--arch", "yolo_heads_m", "--image-size", "512",
                          "--which", "ema", "--no-eval", "--export-msgpack", out,
                          "--export-dtype", "f16", "--device", "cpu"])
    with open(out, "rb") as f, open(M_CHECKPOINT, "rb") as g:
        assert f.read() == g.read()
    assert_trees_bit_equal(jax_load_variables(out), jax_load_variables(M_CHECKPOINT))
    raw = str(tmp_path / "raw_f16.msgpack")
    eval_checkpoint.main(["--ckpt-dir", root, "--which", "raw", "--no-eval",
                          "--export-msgpack", raw, "--export-dtype", "f16", "--device", "cpu"])
    want = eval_checkpoint.cast_float32_leaves(weights.flax_from_state_dict(
        {**train_state.params(), **train_state.batch_stats()}), np.float16)
    assert_trees_bit_equal(jax_load_variables(raw), want)


def test_eval_checkpoint_scores_and_averages(step_dir, tmp_path):
    """Scoring both parameter sets on an on-disk validation split, and
    ``--average-best``: the export of the two best steps is their leaf-wise
    mean, in float64 then float32, as ``average_trees`` computes it."""
    root, train_state = step_dir
    data = str(tmp_path / "data")
    render_split(data, "val", count=2, image_size=64, seed=1, device="cpu", log_every=0)
    with tiny_preset():
        scored = eval_checkpoint.main(["--ckpt-dir", root, "--arch", "tiny", "--image-size", "64",
                                       "--data-dir", data, "--batch-size", "2", "--device",
                                       "cpu"])
    assert set(scored) == {"raw", "ema"}
    for metrics in scored.values():
        assert metrics["images"] == 2 and all(np.isfinite(v) for v in metrics.values())

    two = str(tmp_path / "two")
    mgr = CheckpointManager(two)
    tree = train_state.state_dict()
    scaled = {**tree, "params": {k: v * 2.0 for k, v in tree["params"].items()}}
    mgr.save(1, tree, metrics={"KeypointsNME": 2.0})
    mgr.save(2, scaled, metrics={"KeypointsNME": 1.0})
    mgr.save(3, scaled, metrics={"KeypointsNME": 3.0})
    out = str(tmp_path / "avg.msgpack")
    eval_checkpoint.main(["--ckpt-dir", two, "--which", "raw", "--average-best", "2",
                          "--no-eval", "--export-msgpack", out, "--device", "cpu"])
    with open(out + ".json") as f:
        assert json.load(f)["step"] == "avg2:1+2"
    want = weights.flax_from_state_dict({
        **{k: (v.double() * 1.5).float() for k, v in tree["params"].items()},
        **tree["batch_stats"]})
    assert_trees_bit_equal(weights.load_variables(out), want)


def test_step_state_file_is_refused_by_the_detector(step_dir):
    root, _ = step_dir
    with pytest.raises(ValueError, match="export-msgpack"):
        HeadDetector(model="yolo_heads_n", checkpoint=os.path.join(root, "7", "state.pt"),
                     device="cpu")


# ------------------------------------------------------- SuperGradients
def _sg_checkpoint(name_or_arch, rng):
    """A SuperGradients-style checkpoint: the state dict of the reference's
    torch mirror of the model, every float tensor drawn from ``rng``
    (running variances in [0.5, 1.5], the CSP bottlenecks' alphas away from 1:
    the converters fold them into cv2's post-BN), under ``net`` with a
    wrapper prefix, as SG's ``ckpt_best.pth`` holds it."""
    sd = {}
    for k, v in torch_mirror.build_torch_mirror(name_or_arch).state_dict().items():
        if not v.is_floating_point():
            sd[k] = v
        elif k.endswith("running_var") or (k.endswith(".alpha") and "flame" not in k):
            sd[k] = torch.from_numpy(np.asarray(rng.uniform(0.5, 1.5, v.shape), np.float32))
        else:
            sd[k] = torch.from_numpy(np.asarray(rng.randn(*v.shape) * 0.1, np.float32))
    return {"net": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3}


@pytest.mark.parametrize("arch", ["tiny", "yolo_heads_m"])
def test_supergradients_state_dict_matches_jax(arch, tmp_path):
    """TINY, and yolo_heads_m for every name of a full-size model."""
    raw = _sg_checkpoint(TINY if arch == "tiny" else arch, np.random.RandomState(2))
    path = str(tmp_path / "sg.pth")
    torch.save(raw, path)
    got, want = weights.load_variables(path), jax_load_variables(path)
    assert_trees_bit_equal(got, want)
    assert weights.count_leaves(got) > 100
    (_, got_notes), (_, want_notes) = (convert_torch_checkpoint.convert(raw),
                                      _load_converter().convert(raw))
    assert got_notes == want_notes and any("folded" in n for n in got_notes)


def test_supergradients_checkpoint_serves_and_converts(scenes, tmp_path, capsys):
    raw = _sg_checkpoint(TINY, np.random.RandomState(3))
    pth = str(tmp_path / "sg.pth")
    torch.save(raw, pth)
    out = str(tmp_path / "sg.msgpack")
    with tiny_preset():
        assert convert_torch_checkpoint.main([pth, out, "--arch", "tiny"]) == 0
        total = sum(1 for k in build_model(port_arch(TINY), deploy=False).state_dict()
                    if not k.endswith("num_batches_tracked"))
        assert f"key_matching vs tiny: {total}/{total} leaves matched" in capsys.readouterr().out
        from_pth = HeadDetector(model="tiny", image_size=SIZE, checkpoint=pth, device="cpu")
        from_msgpack = HeadDetector(model="tiny", image_size=SIZE, checkpoint=out, device="cpu")
    assert from_pth.restored_leaves[0] == from_pth.restored_leaves[1] > 100
    for g, w in zip(from_pth.predict_batch(scenes, THRESHOLD),
                    from_msgpack.predict_batch(scenes, THRESHOLD)):
        assert len(g.heads) == len(w.heads) > 0
        for hg, hw in zip(g.heads, w.heads):
            assert hg.bbox == hw.bbox and hg.score == hw.score
            np.testing.assert_array_equal(hg.vertices_3d, hw.vertices_3d)


class _NotATensor:
    """A pickled object that ``torch.load(weights_only=True)`` refuses."""


def test_pickled_object_needs_the_unsafe_opt_in(tmp_path, monkeypatch):
    raw = _sg_checkpoint(TINY, np.random.RandomState(4))
    raw["extra"] = _NotATensor()
    path = str(tmp_path / "pickled.ckpt")
    torch.save(raw, path)
    monkeypatch.delenv("HDT_UNSAFE_TORCH_LOAD", raising=False)
    with pytest.raises(RuntimeError, match="HDT_UNSAFE_TORCH_LOAD=1"):
        weights.load_variables(path)
    monkeypatch.setenv("HDT_UNSAFE_TORCH_LOAD", "1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = weights.load_variables(path)
    assert any("arbitrary code execution" in str(w.message) for w in caught)
    assert_trees_bit_equal(got, jax_load_variables(path))


# ------------------------------------------------------------ host lock
def test_hostlock_default_is_the_reference_path(tmp_path):
    """With TMPDIR set and HDT_CAMPAIGN_LOCK unset, the port's default lock
    is the JAX module's LOCK_PATH (read at its import, so in a fresh
    process; the module is loaded by path, as it imports nothing of jax)."""
    code = ("import importlib.util\n"
            "from head_detector_tpu_torch import hostlock\n"
            "spec = importlib.util.spec_from_file_location(\n"
            "    'ref_hostlock', 'head_detector_tpu/hostlock.py')\n"
            "ref = importlib.util.module_from_spec(spec); spec.loader.exec_module(ref)\n"
            "print(hostlock.lock_path()); print(ref.LOCK_PATH)\n")
    env = {k: v for k, v in os.environ.items() if k not in ("HDT_CAMPAIGN_LOCK", "PYTHONPATH")}
    env.update(PYTHONPATH=REPO, TMPDIR=str(tmp_path), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    port, ref = proc.stdout.split()
    assert port == ref == hostlock.DEFAULT_LOCK_PATH == "/tmp/hdt_campaign.lock"
