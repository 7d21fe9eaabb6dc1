"""HeadDetector's options in the port against the JAX package on the CPU:
``compact_wire``, ``param_fusion`` (and ``fusion_neighbors=1``, which is no
fusion), ``wire_verts_dtype="f16"`` and the bfloat16 compute dtype, each
through ``__call__`` and ``predict_batch``, with the TINY arch
(tests/test_model.py), JAX-initialised weights written to a msgpack
checkpoint both packages read, on rendered scenes at 128 px.

Bars: box IoU >= 0.99, score |d| <= 1e-4, posed-vertex relative L2 <= 1e-3
(float32); float16 vertices within 0.25 px of the port's own float32 ones;
bfloat16, detections matched by IoU: box IoU >= 0.962 (measured 0.981,
with a 2x margin), score |d| <= 2e-2 (measured 0.0104), on the shipped
yolo_heads_m checkpoint at 192 px: the randomly initialised
TINY network is not stable in bfloat16 (its JAX bfloat16 and float32 scores
differ by up to 0.2), the trained one is (0.015).
"""

import os

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu.detector import HeadDetector as JaxHeadDetector
from head_detector_tpu.detector import save_variables
from head_detector_tpu.models import build_model as jax_build_model
from head_detector_tpu.models import init_model
from head_detector_tpu.models import presets as jax_presets
from head_detector_tpu_torch.detector import HeadDetector
from head_detector_tpu_torch.models import presets
from head_detector_tpu_torch.train.dataset import render_scene
from test_model import TINY

SIZE = 128
THRESHOLD = 0.03
M_CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "checkpoints", "flagship_ema.msgpack")


def port_arch(arch) -> presets.ArchCfg:
    """The port's ArchCfg with the fields of a JAX one."""
    f = dataclasses.asdict(arch)
    return presets.ArchCfg(**{
        **f,
        "stages": tuple(presets.StageCfg(**s) for s in f["stages"]),
        "neck_up": tuple(presets.NeckStageCfg(**s) for s in f["neck_up"]),
        "neck_down": tuple(presets.NeckStageCfg(**s) for s in f["neck_down"]),
        "heads": tuple(presets.HeadCfg(**h) for h in f["heads"]),
    })


def tiny_variables():
    return init_model(jax_build_model(TINY), jax.random.PRNGKey(0), (64, 64))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.msgpack")
    save_variables(tiny_variables(), path)
    return path


@pytest.fixture(scope="module")
def scenes():
    scene = render_scene(11, 0, size=SIZE, max_heads=3, device="cpu")
    return [scene, scene[16:112, :].copy()]  # two input shapes


@contextlib.contextmanager
def tiny_preset():
    """Both packages find the TINY arch by the name "tiny"."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_presets.PRESETS, "tiny", TINY)
        mp.setitem(presets.PRESETS, "tiny", port_arch(TINY))
        yield


def make(checkpoint, jax_dtype=jnp.float32, port_dtype=torch.float32, **opts):
    with tiny_preset():
        want = JaxHeadDetector(model="tiny", image_size=SIZE, checkpoint=checkpoint,
                               dtype=jax_dtype, **opts)
        got = HeadDetector(model="tiny", image_size=SIZE, checkpoint=checkpoint,
                           device="cpu", dtype=port_dtype, **opts)
    return want, got


def _iou(a, b):
    ax2, ay2, bx2, by2 = a.x + a.w, a.y + a.h, b.x + b.w, b.y + b.h
    iw = max(0, min(ax2, bx2) - max(a.x, b.x))
    ih = max(0, min(ay2, by2) - max(a.y, b.y))
    inter = iw * ih
    return inter / max(a.w * a.h + b.w * b.h - inter, 1e-12)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_same(got, want):
    assert len(got.heads) == len(want.heads) > 0
    for hg, hw in zip(got.heads, want.heads):
        assert _iou(hg.bbox, hw.bbox) >= 0.99
        assert abs(hg.score - hw.score) <= 1e-4
        assert _rel(hg.vertices_3d, hw.vertices_3d) <= 1e-3


def both_ways(det, scenes):
    """(__call__ on the first scene, predict_batch on both)."""
    return det(scenes[0], THRESHOLD), det.predict_batch(scenes, THRESHOLD)


@pytest.mark.parametrize("opts", [
    dict(compact_wire=2),
    dict(param_fusion=True, fusion_iou=0.5),
    dict(param_fusion=True, fusion_iou=0.5, fusion_neighbors=2, compact_wire=4),
], ids=["compact_wire", "param_fusion", "param_fusion_compact_wire"])
def test_option_matches_jax(checkpoint, scenes, opts):
    want_det, got_det = make(checkpoint, **opts)
    (w1, wb), (g1, gb) = both_ways(want_det, scenes), both_ways(got_det, scenes)
    if opts.get("compact_wire") == 2:
        assert len(g1.heads) == 2  # the budget binds on this scene (3 heads)
    assert_same(g1, w1)
    for g, w in zip(gb, wb):
        assert_same(g, w)


def test_fusion_changes_params_not_detections(checkpoint, scenes):
    """Fusion keeps boxes and scores and moves the meshes; one neighbour is
    no fusion (the default detector's meshes up to the rounding of
    ``w * row / w``: relative L2 <= 1e-6)."""
    _, plain = make(checkpoint)
    _, fused = make(checkpoint, param_fusion=True, fusion_iou=0.5)
    _, one = make(checkpoint, param_fusion=True, fusion_neighbors=1, fusion_iou=0.5)
    p, f, o = (d.predict_batch(scenes, THRESHOLD) for d in (plain, fused, one))
    moved = 0.0
    for rp, rf, ro in zip(p, f, o):
        assert [h.bbox for h in rf.heads] == [h.bbox for h in rp.heads]
        assert [h.score for h in rf.heads] == [h.score for h in rp.heads]
        for hp, hf, ho in zip(rp.heads, rf.heads, ro.heads):
            assert _rel(ho.vertices_3d, hp.vertices_3d) <= 1e-6
            moved = max(moved, _rel(hf.vertices_3d, hp.vertices_3d))
    assert moved > 1e-3  # some head had neighbours to fuse


def test_f16_wire_vertices(checkpoint, scenes):
    """float16 vertices are the float32 ones rounded on the device: within
    0.25 px; ``__call__`` keeps float32 without a compact wire."""
    _, f32 = make(checkpoint, compact_wire=3)
    _, f16 = make(checkpoint, compact_wire=3, wire_verts_dtype="f16")
    worst = 0.0
    for call in (lambda d: [d(scenes[0], THRESHOLD)], lambda d: d.predict_batch(scenes, THRESHOLD)):
        for r32, r16 in zip(call(f32), call(f16)):
            assert len(r16.heads) == len(r32.heads) > 0
            for a, b in zip(r16.heads, r32.heads):
                assert a.vertices_3d.dtype == np.float32
                np.testing.assert_array_equal(a.vertices_3d,
                                              b.vertices_3d.astype(np.float16).astype(np.float32))
                worst = max(worst, float(np.abs(a.vertices_3d - b.vertices_3d).max()))
    assert 0.0 < worst <= 0.25
    (_, plain16), (_, plain32) = make(checkpoint, wire_verts_dtype="f16"), make(checkpoint)
    np.testing.assert_array_equal(plain16(scenes[0], THRESHOLD).heads[0].vertices_3d,
                                  plain32(scenes[0], THRESHOLD).heads[0].vertices_3d)
    with pytest.raises(ValueError, match="f32\\|f16"):
        make(checkpoint, wire_verts_dtype="bf16")


def test_bfloat16_matches_jax():
    """bfloat16 compute in both packages (M checkpoint, 192 px, three
    rendered scenes); every JAX detection matched by IoU."""
    scenes = [render_scene(11, i, size=192, max_heads=3, device="cpu") for i in range(3)]
    kw = dict(model="yolo_heads_m", image_size=192, checkpoint=M_CHECKPOINT)
    want_det = JaxHeadDetector(dtype=jnp.bfloat16, **kw)
    got_det = HeadDetector(dtype=torch.bfloat16, device="cpu", **kw)
    want = [want_det(scenes[0], 0.3)] + want_det.predict_batch(scenes, 0.3)
    got = [got_det(scenes[0], 0.3)] + got_det.predict_batch(scenes, 0.3)
    worst = {"iou": 1.0, "score": 0.0}
    for g, w in zip(got, want):
        for hw in w.heads:
            best = max(g.heads, key=lambda hg: _iou(hg.bbox, hw.bbox))
            worst["iou"] = min(worst["iou"], _iou(best.bbox, hw.bbox))
            worst["score"] = max(worst["score"], abs(best.score - hw.score))
    print("bfloat16, port vs JAX:", worst)
    assert sum(len(w.heads) for w in want) >= 3
    assert worst["iou"] >= 0.962 and worst["score"] <= 2e-2
