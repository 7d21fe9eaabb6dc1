"""The port's native host library against the JAX package's and its own twins.

Mirrors ``tests/test_native.py``: ``head_detector_tpu_torch.native`` builds
its own byte-for-byte copy of ``hdt_native.cpp``, so its rasterizer equals
the JAX package's native one on the same inputs, and both stand against the
port's plain rasterizer; its OBJ writer is byte-equal to the port's Python
writer and to the JAX ``MeshSaver``'s files; its letterbox is held against
cv2 and drives ``StreamingDetector``'s host letterbox under
``HDT_LETTERBOX=native`` or without cv2; and the library's cache key names
the host it was built on.
"""

import filecmp
import os

import cv2
import numpy as np
import pytest
import torch

from head_detector_tpu import native as jax_native
from head_detector_tpu.detection_result import MeshSaver as JaxMeshSaver
from head_detector_tpu_torch import detection_result, native, pipeline
from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.ops import rasterize as rz
from test_torch_rasterize import _sliver_pixels
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"native build unavailable: {native.build_error()}")
    return native


def _random_mesh(rng, n_verts, n_tris, size):
    vertices = np.stack([rng.uniform(-5, size + 5, n_verts), rng.uniform(-5, size + 5, n_verts),
                         rng.uniform(-1, 1, n_verts)], axis=1).astype(np.float32)
    triangles = rng.randint(0, n_verts, (n_tris, 3)).astype(np.int32)
    colors = rng.rand(n_verts, 3).astype(np.float32)
    return vertices, triangles, colors


def _plain(v, t, c, h, w, reverse=False):
    color, hit = rz.rasterize_zbuffer(torch.from_numpy(v), torch.from_numpy(t),
                                      torch.from_numpy(c), h, w, reverse)
    return color.numpy(), hit.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_native_matches_plain_and_jax_native(lib, seed):
    rng = np.random.RandomState(seed)
    size = 48
    v, t, c = _random_mesh(rng, 30, 40, size)
    cn, hn = lib.rasterize_zbuffer_native(v, t, c, size, size)
    cj, hj = jax_native.rasterize_zbuffer_native(v, t, c, size, size)
    np.testing.assert_array_equal(hn, hj)  # the same C++ source
    np.testing.assert_array_equal(cn, cj)
    cp, hp = _plain(v, t, c, size, size)
    # near-degenerate random triangles may flip a strict edge test (FMA
    # against scalar rounding): a sliver of edge pixels
    assert (hn == hp).mean() > 0.999
    both = hn & hp
    assert np.abs(cn[both] - cp[both]).max() < 1e-3


def test_rasterize_native_flame_head_exact(lib):
    """On the FLAME template mesh the native and plain rasterizers cover the
    same pixels and agree on every color outside sliver triangles, where
    float32 rounding over sin^2 of a tiny corner angle (the native code
    contracts to FMAs, the plain version does not) moves one pixel by 3.2e-3
    (``tests/test_torch_rasterize.py:_sliver_pixels``)."""
    assets = load_flame_assets()
    v = assets.v_template.astype(np.float32).copy()
    v[:, :2] -= v[:, :2].min(0)
    v[:, :2] *= 150.0 / v[:, :2].max()
    v[:, :2] += 5
    t = assets.faces.astype(np.int32)
    c = np.random.RandomState(0).rand(v.shape[0], 3).astype(np.float32)
    cn, hn = lib.rasterize_zbuffer_native(v, t, c, 160, 160)
    cp, hp = _plain(v, t, c, 160, 160)
    assert (hn == hp).all()
    exempt = _sliver_pixels(v, t, c, 160)
    assert exempt.mean() < 0.01
    assert np.abs(cn - cp)[hn & ~exempt].max() < 1e-4


def test_rasterize_native_depth_tie_prefers_first_triangle(lib):
    vertices = np.array([[2, 2, 0.5], [30, 2, 0.5], [2, 30, 0.5],
                         [2, 2, 0.5], [30, 2, 0.5], [2, 30, 0.5]], np.float32)
    triangles = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    colors = np.zeros((6, 3), np.float32)
    colors[:3] = [1.0, 0.0, 0.0]
    colors[3:] = [0.0, 1.0, 0.0]
    color, hit = lib.rasterize_zbuffer_native(vertices, triangles, colors, 32, 32)
    assert hit[10, 10]
    assert color[10, 10, 0] == pytest.approx(1.0) and color[10, 10, 1] == 0.0
    cp, _ = _plain(vertices, triangles, colors, 32, 32)
    np.testing.assert_array_equal(color[10, 10], cp[10, 10])


def test_rasterize_native_reverse_flips_rows(lib):
    v = np.array([[2, 2, 0.5], [30, 2, 0.5], [2, 30, 0.5]], np.float32)
    t = np.array([[0, 1, 2]], np.int32)
    c = np.ones((3, 3), np.float32)
    fwd, hf = lib.rasterize_zbuffer_native(v, t, c, 32, 32)
    rev, hr = lib.rasterize_zbuffer_native(v, t, c, 32, 32, reverse=True)
    assert (hf[::-1] == hr).all()
    np.testing.assert_array_equal(fwd[::-1], rev)
    _, hp = _plain(v, t, c, 32, 32, reverse=True)
    np.testing.assert_array_equal(hr, hp)


def test_rasterize_native_composites_like_the_public_entry(lib):
    """The native canvas through ``composite`` against ``rasterize()``'s
    uint8 output (the plain version on the CPU): the JAX package's
    ``HDT_RASTERIZER=native`` check, without routing the port through it."""
    rng = np.random.RandomState(3)
    v, t, c = _random_mesh(rng, 25, 30, 40)
    bg = rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)
    canvas, hit = lib.rasterize_zbuffer_native(v, t, c, 40, 40)
    got = rz.composite(bg.copy(), canvas, hit)
    want = rz.rasterize(v, t, c, bg=bg.copy(), device="cpu")
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 2).mean() > 0.999  # uint8 rounding on edge pixels


def test_write_objs_byte_identical_to_python_and_jax(lib, tmp_path):
    saver = detection_result.MeshSaver()
    jax_saver = JaxMeshSaver()
    assert saver._faces_block == jax_saver._faces_block
    rng = np.random.RandomState(0)
    verts = rng.randn(2, 57, 3) * np.array([100.0, 1e-4, 1.0])
    verts[0, 0] = [0.0, -0.0, 123456.123456789]
    native_paths = [str(tmp_path / f"n{i}.obj") for i in range(2)]
    python_paths = [str(tmp_path / f"p{i}.obj") for i in range(2)]
    jax_paths = [str(tmp_path / f"j{i}.obj") for i in range(2)]
    lib.write_objs_native(verts, saver._faces_block.encode(), native_paths)
    saver.save_many_python(verts, python_paths)
    jax_saver.save_many(verts, jax_paths)
    for n, p, j in zip(native_paths, python_paths, jax_paths):
        assert filecmp.cmp(n, p, shallow=False)
        assert filecmp.cmp(n, j, shallow=False)


def test_mesh_saver_uses_native_and_roundtrips(lib, tmp_path):
    saver = detection_result.MeshSaver()
    assert saver._native is lib
    verts = np.random.RandomState(1).randn(5023, 3).astype(np.float32)
    path = str(tmp_path / "head.obj")
    saver(verts, path)
    with open(path) as f:
        lines = f.read().splitlines()
    v_lines = [line for line in lines if line.startswith("v ")]
    f_lines = [line for line in lines if line.startswith("f ")]
    assert len(v_lines) == 5023 and len(f_lines) == len(saver.triangles)
    back = np.array([line.split()[1:] for line in v_lines], np.float64)
    np.testing.assert_allclose(back, verts.astype(np.float64), atol=5e-9)
    assert min(int(x) for x in f_lines[0].split()[1:]) >= 1  # faces stay 1-based
    saver.save_many_python(verts[None], [str(tmp_path / "python.obj")])
    assert filecmp.cmp(path, str(tmp_path / "python.obj"), shallow=False)
    saver.save_many(np.zeros((0, 5023, 3)), [])  # no heads: nothing written


def test_letterbox_native_matches_cv2(lib):
    rng = np.random.RandomState(0)
    for sh, sw in [(480, 640), (123, 217), (1024, 768)]:
        img = rng.randint(0, 255, (sh, sw, 3), dtype=np.uint8)
        size = 256
        got, scale = lib.letterbox_native(img, size)
        want_scale = min(size / sh, size / sw)
        nh, nw = int(sh * want_scale + 0.5), int(sw * want_scale + 0.5)
        want = np.full((size, size, 3), 127, np.uint8)
        top, left = (size - nh) // 2, (size - nw) // 2
        want[top:top + nh, left:left + nw] = cv2.resize(img, (nw, nh),
                                                        interpolation=cv2.INTER_LINEAR)
        assert scale == pytest.approx(want_scale)
        # cv2's 11-bit fixed-point weights against the native float path
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
        pad = np.ones((size, size), bool)
        pad[top:top + nh, left:left + nw] = False
        np.testing.assert_array_equal(got[pad], want[pad])
        jax_got, jax_scale = jax_native.letterbox_native(img, size)
        np.testing.assert_array_equal(got, jax_got)
        assert scale == jax_scale


def test_letterbox_batch_matches_single(lib):
    imgs = np.random.RandomState(2).randint(0, 255, (4, 96, 128, 3), dtype=np.uint8)
    batch = lib.letterbox_batch_native(imgs, 64)
    for i in range(4):
        single, _ = lib.letterbox_native(imgs[i], 64)
        np.testing.assert_array_equal(batch[i], single)


class _Stub:  # _letterbox_host reads only image_size: no model is built
    image_size = 64


def test_streaming_letterbox_native_env_and_without_cv2(lib, monkeypatch):
    img = np.random.RandomState(0).randint(0, 255, (100, 200, 3), dtype=np.uint8)
    want, want_scale = lib.letterbox_native(img, 64)
    cv2_out, _ = pipeline.StreamingDetector._letterbox_host(_Stub(), img)
    monkeypatch.setenv("HDT_LETTERBOX", "native")
    out, scale = pipeline.StreamingDetector._letterbox_host(_Stub(), img)
    np.testing.assert_array_equal(out, want)
    assert scale == want_scale
    assert np.abs(out.astype(int) - cv2_out.astype(int)).max() <= 2
    monkeypatch.delenv("HDT_LETTERBOX")
    monkeypatch.setattr(pipeline, "cv2", None)
    out, _ = pipeline.StreamingDetector._letterbox_host(_Stub(), img)
    np.testing.assert_array_equal(out, want)


def test_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(native.SOURCE,
                       os.path.join(REPO, "head_detector_tpu", "native", "csrc",
                                    "hdt_native.cpp"), shallow=False)


def test_cache_key_names_the_host():
    a = native.library_path(host="x86_64|CPU model A")
    assert a == native.library_path(host="x86_64|CPU model A")
    assert a != native.library_path(host="x86_64|CPU model B")
    assert a != native.library_path(host="aarch64|CPU model A")
    machine, model, target = native.host_key().split("|")  # g++'s -march=native, digested
    assert machine and len(target) == 16
    assert native.library_path() == native.library_path(host=native.host_key())
    assert os.path.dirname(native.library_path()) == os.path.join(
        REPO, "head_detector_tpu_torch", "_build")
