"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device
(the kernels have no CPU form).  This file imports neither jax nor the JAX
package, so it runs on a machine with only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and the plain version run the same unfused float32 operations,
so ``rasterize_zbuffer`` is held to the Pallas kernel's bar
(tests/test_rasterize_pallas.py): hit agreement >= 0.999 and |color| < 1e-4
on common hits; ``pncc_render`` to equality of every uint8 pixel.
"""

import numpy as np
import pytest
import torch

from head_detector_tpu_torch.ops import rasterize as r


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _mesh(rng, n_heads, n_verts, n_tris, size):
    verts = np.stack([
        np.stack([rng.uniform(-5, size + 5, n_verts), rng.uniform(-5, size + 5, n_verts),
                  rng.uniform(-1, 1, n_verts)], axis=1)
        for _ in range(n_heads)
    ]).astype(np.float32)
    tris = rng.randint(0, n_verts, (n_tris, 3)).astype(np.int32)
    colors = rng.rand(n_verts, 3).astype(np.float32)
    return torch.from_numpy(verts), torch.from_numpy(tris), torch.from_numpy(colors)


def _assert_agree(got, want):
    (gc, gh), (wc, wh) = [(c.cpu(), h.cpu()) for c, h in (got, want)]
    assert (gh == wh).float().mean().item() >= 0.999
    common = gh & wh
    if common.any():
        assert (gc - wc).abs()[common].max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("seed,size", [(0, 100), (1, 64), (2, 130)])
def test_kernel_matches_plain(cuda_device, seed, size):
    args = _mesh(np.random.RandomState(seed), 2, 40, 200, size)
    for reverse in (False, True):
        want = r.rasterize_zbuffer_plain(*args, size, size, reverse)
        before = r.rasterize_zbuffer_cuda.launches
        got = r.rasterize_zbuffer(*[a.to(cuda_device) for a in args], size, size, reverse)
        torch.cuda.synchronize()
        assert r.rasterize_zbuffer_cuda.launches == before + 1
        _assert_agree(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_canvas", "canvas_filling_head", "dense_tile"])
def test_kernel_matches_plain_shapes(cuda_device, case):
    """A canvas that ends inside tiles, a head larger than the canvas (every
    tile lists triangles), and a mesh denser than one tile's list (the list
    is walked in several rounds)."""
    rng = np.random.RandomState(7)
    height, width = (100, 130) if case == "ragged_canvas" else (96, 160)
    verts, tris, colors = _mesh(rng, 2, 60, 400, 100)
    if case == "canvas_filling_head":
        verts[..., :2] = verts[..., :2] * 3.0 - 60.0
    if case == "dense_tile":
        verts, tris, colors = _mesh(rng, 1, 200, 5000, 100)
        verts[..., :2] = verts[..., :2] * 0.2 + 30.0
    for reverse in (False, True):
        want = r.rasterize_zbuffer_plain(verts, tris, colors, height, width, reverse)
        got = r.rasterize_zbuffer(*[a.to(cuda_device) for a in (verts, tris, colors)],
                                  height, width, reverse)
        torch.cuda.synchronize()
        assert want[1].any()
        _assert_agree(got, want)
        assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["overlapping_heads", "zero_uint8_color", "ragged_canvas",
                                  "no_heads", "empty_mesh"])
def test_pncc_render_kernel_equals_plain(cuda_device, case):
    rng = np.random.RandomState(8)
    height, width = (100, 130) if case == "ragged_canvas" else (96, 96)
    verts, tris, colors = _mesh(rng, 3, 40, 150, 96)
    if case == "zero_uint8_color":
        colors = colors * (torch.from_numpy(rng.rand(len(colors), 1)) > 0.6).float()
    if case == "no_heads":
        verts = verts[:0]
    if case == "empty_mesh":
        tris = tris[:0]
    want = r.pncc_render_plain(verts, tris, colors, height, width)
    before = r.pncc_render_cuda.launches
    got = r.pncc_render(*[a.to(cuda_device) for a in (verts, tris, colors)], height, width)
    torch.cuda.synchronize()
    assert r.pncc_render_cuda.launches == before + (0 if case == "no_heads" else 1)
    assert got.dtype == torch.uint8 and got.device.type == "cuda"
    assert want.any() == (case not in ("no_heads", "empty_mesh"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_steady_state_call_does_not_synchronise(cuda_device):
    """The index range of a triangle table is read back once; after that
    neither wrapper waits for the device."""
    verts, tris, colors = [a.to(cuda_device) for a in _mesh(np.random.RandomState(9), 2, 40,
                                                            200, 64)]
    r.rasterize_zbuffer_cuda(verts, tris, colors, 64, 64)  # reads the index range
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        canvas, hit = r.rasterize_zbuffer_cuda(verts, tris, colors, 64, 64)
        rgb = r.pncc_render_cuda(verts, tris, colors, 64, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert hit.any() and rgb.any() and canvas.isfinite().all()
    tris[0, 0] = 40  # written to: the range is read again, and is now outside [0, V)
    with pytest.raises(ValueError):
        r.rasterize_zbuffer_cuda(verts, tris, colors, 64, 64)


@pytest.mark.cuda
def test_render_scene_reads_its_table_once(cuda_device, monkeypatch):
    """render_scene keeps its triangle table per device, so only the first
    call reads the table's index range back from the card."""
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.train.dataset import render_scene

    flame_model = FlameModel.from_assets(device=cuda_device)
    render_scene(11, 0, size=64, max_heads=2, device=cuda_device, flame_model=flame_model)
    reads = []
    aminmax = torch.aminmax
    monkeypatch.setattr(torch, "aminmax", lambda t: reads.append(1) or aminmax(t))
    before = r.rasterize_zbuffer_cuda.launches
    scene = render_scene(11, 1, size=64, max_heads=2, device=cuda_device,
                         flame_model=flame_model)
    assert r.rasterize_zbuffer_cuda.launches == before + 1 and not reads
    assert scene.shape == (64, 64, 3) and (scene.max(-1) > 100).any()


@pytest.mark.cuda
def test_kernel_tie_empty_degenerate(cuda_device):
    v = torch.tensor([[[2, 2, 0.5], [30, 2, 0.5], [2, 30, 0.5], [2, 2, 0.5], [30, 2, 0.5],
                       [2, 30, 0.5], [1, 1, 0.9], [20, 20, 0.9], [10, 10, 0.9]]],
                     device=cuda_device)
    t = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8], [6, 8, 8]], dtype=torch.int32,
                     device=cuda_device)
    c = torch.zeros((9, 3), device=cuda_device)
    c[:3, 0], c[3:6, 1], c[6:, 2] = 1.0, 1.0, 1.0
    color, hit = r.rasterize_zbuffer_cuda(v, t, c, 32, 32)
    assert color[0, 10, 10].tolist() == [1.0, 0.0, 0.0]  # lowest index wins the tie
    assert not (color[0, ..., 2] > 0).any()  # degenerate triangles cover nothing
    _, empty = r.rasterize_zbuffer_cuda(v, t[:0].contiguous(), c, 16, 16)
    assert not empty.any()


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    v = torch.zeros((1, 3, 3), device=cuda_device)
    c = torch.zeros((3, 3), device=cuda_device)
    with pytest.raises(TypeError):
        r.rasterize_zbuffer_cuda(v, torch.zeros((1, 3), dtype=torch.int64,
                                                device=cuda_device), c, 8, 8)
    with pytest.raises(ValueError):
        r.rasterize_zbuffer_cuda(v, torch.full((1, 3), 7, dtype=torch.int32,
                                               device=cuda_device), c, 8, 8)
    with pytest.raises(ValueError):
        r.rasterize_zbuffer_cuda(v.cpu(), torch.zeros((1, 3), dtype=torch.int32), c.cpu(),
                                 8, 8)


@pytest.mark.cuda
def test_pncc_card_matches_cpu(cuda_device):
    from head_detector_tpu_torch.head_info import HeadMetadata
    from head_detector_tpu_torch.pncc import PNCCProcessor

    rng = np.random.RandomState(0)
    heads = []
    for _ in range(2):
        verts = np.random.RandomState(len(heads)).rand(5023, 3).astype(np.float32)
        verts[:, :2] = verts[:, :2] * 60 + rng.uniform(10, 50, 2)
        heads.append(HeadMetadata(None, 1.0, None, verts, None))
    image = np.zeros((128, 128, 3), np.uint8)
    got = PNCCProcessor(device=cuda_device)(image, heads)
    want = PNCCProcessor(device="cpu")(image, heads)
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert got.any() and (diff > 0).mean() <= 0.001


@pytest.mark.cuda
def test_warps_card_match_cpu(cuda_device):
    """The batched warps of the aligned-crop path, card against CPU, within
    1e-3 on a 0-255 scale (TF32 off on both)."""
    from head_detector_tpu_torch.ops import warp

    rng = np.random.RandomState(5)
    picture = torch.from_numpy(rng.uniform(0, 255, (90, 120, 3)).astype(np.float32))
    mats = np.array([[[1.2, -0.3, 10.0], [0.3, 1.2, -5.0]],
                     [[0.7, 0.1, -20.0], [-0.1, 0.7, 30.0]]])
    inv = torch.from_numpy(warp.invert_affine(mats))
    boxes = torch.tensor([[10.0, 5.0, 70.0, 65.0], [-10.0, 30.0, 50.0, 100.0]])
    angles = torch.tensor([25.0, -140.0])
    for fn, args in [
        (warp.affine_warp, (picture, inv, 48, 56)),
        (warp.scaled_crops_matmul, (picture, boxes, 32)),
        (warp.rotate_crops_matmul, (picture[None, :64, :64].repeat(2, 1, 1, 1), angles)),
        (warp.aligned_crops_matmul, (picture, boxes, angles, 32)),
    ]:
        want = fn(*args)
        got = fn(*[a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args])
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_streaming_batch_on_card_matches_cpu(cuda_device):
    """One float32 batch of rendered scenes through StreamingDetector (M
    checkpoint, 256 px, batch 4, a short tail batch) on the card and on the
    CPU: the same valid slots, scores within 1e-4, boxes within 0.05 px,
    vertices (float32 on the wire) relative L2 <= 1e-3; the vertices stay on
    the card."""
    import os

    from head_detector_tpu_torch.pipeline import StreamingDetector
    from head_detector_tpu_torch.train.dataset import render_scene

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checkpoints", "flagship_ema.msgpack")
    scenes = [render_scene(11, i, size=256, max_heads=3, device="cpu") for i in range(5)]
    kw = dict(model_name="yolo_heads_m", checkpoint=ckpt, image_size=256, batch_size=4,
              dtype=torch.float32, verts_dtype=torch.float32, workers=2)
    got = list(StreamingDetector(device=cuda_device, **kw).run(scenes))
    want = list(StreamingDetector(device="cpu", **kw).run(scenes))
    assert len(got) == len(want) == 5
    assert sum(int(w["valid"].sum()) for w in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
        np.testing.assert_allclose(g["boxes_xyxy"], w["boxes_xyxy"], atol=0.05)
        assert sorted(g["vertices"]) == sorted(w["vertices"])
        for slot, v in g["vertices"].items():
            assert v.device.type == "cuda"
            ref = w["vertices"][slot]
            assert float(torch.linalg.norm(v.cpu() - ref) / torch.linalg.norm(ref)) <= 1e-3
