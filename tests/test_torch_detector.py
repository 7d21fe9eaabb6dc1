"""The port's slice end to end on the CPU, against the JAX package: synthetic
scene rendering, PNCC, and HeadDetector (letterbox -> model -> NMS ->
sparse towers -> FLAME -> un-letterbox) with the same yolo_heads_n weights
(random init, written to a msgpack checkpoint both packages read).

Bars: box IoU >= 0.99 and posed-vertex relative L2 <= 1e-3 (the rebuild's
bar, README.md); PNCC maps of the same meshes equal or off by at most 1 on
<= 0.1% of pixels, of the two detectors' meshes off by more than 1 on <= 0.1%.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu.detector import HeadDetector as JaxHeadDetector
from head_detector_tpu.detector import save_variables
from head_detector_tpu.flame import FlameModel as JaxFlameModel
from head_detector_tpu.flame import reproject_spatial_vertices as jax_reproject
from head_detector_tpu.head_info import HeadMetadata as JaxHeadMetadata
from head_detector_tpu.models import build_model as jax_build_model
from head_detector_tpu.models import init_model
from head_detector_tpu.pncc import PNCCProcessor as JaxPNCC
from head_detector_tpu.train.dataset import SyntheticHeadsDataset
from head_detector_tpu_torch.detector import HeadDetector
from head_detector_tpu_torch.pncc import PNCCProcessor
from head_detector_tpu_torch.train.dataset import render_scene, scene_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128
THRESHOLD = 0.02


def _iou(a, b):
    ax2, ay2, bx2, by2 = a.x + a.w, a.y + a.h, b.x + b.w, b.y + b.h
    iw = max(0, min(ax2, bx2) - max(a.x, b.x))
    ih = max(0, min(ay2, by2) - max(a.y, b.y))
    inter = iw * ih
    return inter / max(a.w * a.h + b.w * b.h - inter, 1e-12)


def _pncc_diff(got, want):
    return np.abs(got.astype(int) - want.astype(int)).max(-1)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model = jax_build_model("yolo_heads_n")
    variables = init_model(model, jax.random.PRNGKey(0), (64, 64))
    path = str(tmp_path_factory.mktemp("ckpt") / "yolo_heads_n.msgpack")
    save_variables(variables, path)
    return path


@pytest.fixture(scope="module")
def scene():
    return render_scene(11, 0, size=SIZE, max_heads=3, device="cpu")


@pytest.fixture(scope="module")
def results(checkpoint, scene):
    jax_det = JaxHeadDetector(model="yolo_heads_n", image_size=SIZE, checkpoint=checkpoint)
    det = HeadDetector(model="yolo_heads_n", image_size=SIZE, checkpoint=checkpoint,
                       device="cpu")
    assert det.restored_leaves[0] == det.restored_leaves[1]
    second = scene[16:112, :]  # a second input shape: two letterbox groups
    want = jax_det.predict_batch([scene, second], confidence_threshold=THRESHOLD)
    got = det.predict_batch([scene, second], confidence_threshold=THRESHOLD)
    single = (jax_det(scene, THRESHOLD), det(scene, THRESHOLD))
    return want, got, single


def test_render_scene_matches_jax_dataset(scene):
    want = SyntheticHeadsDataset(image_size=SIZE, length=1, max_heads=3, seed=11,
                                 render=True)[0].image
    assert scene.shape == want.shape and scene.dtype == np.uint8
    differ = np.abs(scene.astype(int) - want.astype(int)).max(-1) > 1
    assert differ.mean() <= 0.001
    assert (scene.max(-1) > 100).any()  # heads drawn over the 40..100 background


def _compare(got, want):
    assert len(got.heads) == len(want.heads) > 0
    for hg, hw in zip(got.heads, want.heads):
        assert _iou(hg.bbox, hw.bbox) >= 0.99
        assert abs(hg.score - hw.score) <= 1e-3 * hw.score
        rel = np.linalg.norm(hg.vertices_3d - hw.vertices_3d) / np.linalg.norm(hw.vertices_3d)
        assert rel <= 1e-3
        # the bar is on the vertices; raw params and pose of these random
        # weights agree to float32 reassociation through the towers
        np.testing.assert_allclose(hg.flame_params.to_3dmm_tensor(),
                                   hw.flame_params.to_3dmm_tensor(), rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(hg.head_pose, hw.head_pose, atol=0.25)  # degrees


def test_predict_batch_matches_jax(results):
    want, got, _ = results
    for g, w in zip(got, want):
        _compare(g, w)


def test_call_matches_jax(results):
    want, got = results[2]
    _compare(got, want)
    _compare(got, results[1][0])  # __call__ == predict_batch for one image


def test_get_pncc_matches_jax(results, monkeypatch):
    monkeypatch.setenv("HDT_RASTERIZER", "xla")
    want, got, _ = results
    pncc_w = want[0].get_pncc()
    pncc_g = got[0].get_pncc()
    assert pncc_g.shape == pncc_w.shape and pncc_g.any()
    # the meshes differ by ~1e-5 relative, which moves the truncating uint8
    # cast by 1 at some pixels and flips a few edge pixels
    diff = _pncc_diff(pncc_g, pncc_w)
    assert (diff > 1).mean() <= 0.001


def test_pncc_processor_matches_jax(monkeypatch):
    monkeypatch.setenv("HDT_RASTERIZER", "xla")
    params, _ = scene_params(3, 1, size=SIZE, max_heads=3)
    params = params[:2]
    _, _, proj = jax_reproject(JaxFlameModel.from_assets(), jnp.asarray(params), to_2d=False)
    heads = [JaxHeadMetadata(bbox=None, score=1.0, flame_params=None,
                             vertices_3d=np.asarray(v), head_pose=None) for v in proj]
    image = np.zeros((SIZE, SIZE, 3), np.uint8)
    want = JaxPNCC()(image, heads)
    port = PNCCProcessor(device="cpu")
    np.testing.assert_array_equal(port.triangles, JaxPNCC().triangles)
    got = port(image, heads)
    assert got.any()
    diff = _pncc_diff(got, want)
    assert (diff > 1).sum() == 0 and (diff > 0).mean() <= 0.001
    assert not port(image, []).any()


def test_port_imports_no_jax():
    code = (
        "import sys, importlib\n"
        "mods = ['head_detector_tpu_torch', 'head_detector_tpu_torch.detector',\n"
        "        'head_detector_tpu_torch.pncc', 'head_detector_tpu_torch.train.dataset',\n"
        "        'head_detector_tpu_torch.weights', 'head_detector_tpu_torch.cuda_build',\n"
        "        'head_detector_tpu_torch.pipeline', 'head_detector_tpu_torch.utils',\n"
        "        'head_detector_tpu_torch.draw_utils', 'head_detector_tpu_torch.ops.warp',\n"
        "        'head_detector_tpu_torch.evaluation.head_alignment', 'chip_smoke']\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax'))\n"
        "       or m == 'head_detector_tpu' or m.startswith('head_detector_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_raises_without_cuda(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here; the refusal is for hosts without it")
    with pytest.raises(RuntimeError, match="cuda"):
        HeadDetector(model="yolo_heads_n", checkpoint=checkpoint, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        PNCCProcessor()


M_CHECKPOINT = os.path.join(REPO, "checkpoints", "flagship_ema.msgpack")
M_SIZE = 320


@pytest.fixture(scope="module")
def m_results():
    """The shipped yolo_heads_m checkpoint (float16 leaves, training layout)
    through both packages on two seeded rendered scenes."""
    scenes = [render_scene(11, i, size=M_SIZE, max_heads=3, device="cpu") for i in (0, 3)]
    jax_det = JaxHeadDetector(model="yolo_heads_m", image_size=M_SIZE,
                              checkpoint=M_CHECKPOINT)
    det = HeadDetector(model="yolo_heads_m", image_size=M_SIZE, checkpoint=M_CHECKPOINT,
                       device="cpu")
    assert det.restored_leaves[0] == det.restored_leaves[1]
    return (jax_det.predict_batch(scenes, confidence_threshold=0.5),
            det.predict_batch(scenes, confidence_threshold=0.5))


def test_shipped_m_checkpoint_matches_jax(m_results):
    """The shipped checkpoint's leaves are float16.  The reference folds its
    QARepVGG branches in float16, the port in float32 (weights.py); the fold's
    rounding stays well inside the rebuild's bar: box IoU >= 0.99,
    posed-vertex relative L2 <= 1e-3, and score |difference| <= 2e-3
    (measured on these scenes: IoU 1.0, 4.2e-4, 6.9e-5)."""
    want, got = m_results
    assert sum(len(w.heads) for w in want) >= 2
    worst = {"iou": 1.0, "score": 0.0, "rel": 0.0}
    for g, w in zip(got, want):
        assert len(g.heads) == len(w.heads)
        for hg, hw in zip(g.heads, w.heads):
            worst["iou"] = min(worst["iou"], _iou(hg.bbox, hw.bbox))
            worst["score"] = max(worst["score"], abs(hg.score - hw.score))
            worst["rel"] = max(worst["rel"], float(
                np.linalg.norm(hg.vertices_3d - hw.vertices_3d)
                / np.linalg.norm(hw.vertices_3d)))
    print("shipped M checkpoint, port vs reference:", worst)
    assert worst["iou"] >= 0.99
    assert worst["score"] <= 2e-3
    assert worst["rel"] <= 1e-3


def test_pncc_processor_keeps_image_layout():
    """The map has the image's shape and dtype: the rendered canvas in its
    first three channels, the rest zero."""
    from head_detector_tpu_torch.flame import FlameModel, reproject_spatial_vertices
    from head_detector_tpu_torch.head_info import HeadMetadata

    params, _ = scene_params(3, 1, size=SIZE, max_heads=3)
    _, _, proj = reproject_spatial_vertices(
        FlameModel.from_assets(device="cpu"), torch.as_tensor(params[:1]), to_2d=False)
    heads = [HeadMetadata(bbox=None, score=1.0, flame_params=None,
                          vertices_3d=proj[0].numpy(), head_pose=None)]
    port = PNCCProcessor(device="cpu")
    rgb = port(np.zeros((SIZE, SIZE - 32, 3), np.uint8), heads)
    assert rgb.shape == (SIZE, SIZE - 32, 3) and rgb.dtype == np.uint8 and rgb.any()
    rgba = port(np.full((SIZE, SIZE - 32, 4), 7, np.uint8), heads)
    assert rgba.shape == (SIZE, SIZE - 32, 4) and not rgba[..., 3].any()
    np.testing.assert_array_equal(rgba[..., :3], rgb)
    as_float = port(np.ones((SIZE, SIZE - 32, 3), np.float32), heads)
    assert as_float.dtype == np.float32
    np.testing.assert_array_equal(as_float, rgb.astype(np.float32))


def test_render_scene_reuses_its_tables(monkeypatch):
    """Every call hands the rasterizer the same triangle and color tensors,
    so the CUDA wrapper reads the table's index range once per device."""
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.train import dataset

    seen = []
    rasterize_zbuffer = dataset.rasterize_zbuffer

    def spy(vertices, triangles, colors, **kwargs):
        seen.append((triangles, colors))
        return rasterize_zbuffer(vertices, triangles, colors, **kwargs)

    monkeypatch.setattr(dataset, "rasterize_zbuffer", spy)
    flame_model = FlameModel.from_assets(device="cpu")
    for index in (0, 1):
        render_scene(11, index, size=64, max_heads=2, device="cpu", flame_model=flame_model)
    assert seen[0][0] is seen[1][0] and seen[0][1] is seen[1][1]
    assert seen[0][0].dtype == torch.int32 and seen[0][1].dtype == torch.float32
