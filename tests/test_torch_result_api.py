"""The port's result API and warps against the JAX package on the CPU.

The same head numbers (FLAME meshes decoded from seeded parameters, boxes,
poses) go into both packages' ``PredictionResult``:

* ``draw`` is byte-equal for every method of ``DRAW_MAPPING``;
* ``get_aligned_heads`` gives byte-equal crops;
* ``save_meshes`` writes byte-identical OBJ files;
* ``affine_warp``, ``scaled_crops_matmul``, ``rotate_crops_matmul``,
  ``aligned_crops_matmul`` and ``aligned_heads_batched`` agree within 1e-3
  on a 0-255 float scale.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu import detection_result as jax_result
from head_detector_tpu import head_info as jax_head_info
from head_detector_tpu.evaluation import head_alignment as jax_alignment
from head_detector_tpu.ops import warp as jax_warp
from head_detector_tpu_torch import detection_result, head_info
from head_detector_tpu_torch.evaluation import head_alignment
from head_detector_tpu_torch.flame import FlameModel, reproject_spatial_vertices
from head_detector_tpu_torch.ops import warp

SIZE = 320  # a square image: the letterbox at 640 px scales it by 2, no pad


@pytest.fixture(scope="module")
def head_numbers():
    """Four heads as the detector gives them: params in the 640 px letterbox
    space, meshes decoded from them and scaled to the image, poses (one with
    |yaw| >= 60, which skips the alignment)."""
    rng = np.random.RandomState(3)
    params = (rng.randn(4, 413) * 0.2).astype(np.float32)
    params[:, 409:411] = rng.uniform(180, 460, (4, 2))
    params[:, 412] = rng.uniform(500, 1000, 4)
    _, _, verts = reproject_spatial_vertices(
        FlameModel.from_assets(device="cpu"), torch.from_numpy(params), to_2d=False)
    verts = verts.numpy() / np.float32(640 / SIZE)
    rpy = np.array([[12.0, -5.0, 20.0], [-30.0, 10.0, -45.0], [5.0, 3.0, 75.0],
                    [170.0, 0.0, 10.0]], np.float32)
    return params, verts, rpy


def _results(head_numbers, image):
    params, verts, rpy = head_numbers
    out = []
    for pkg_info, pkg_result in ((jax_head_info, jax_result), (head_info, detection_result)):
        heads = []
        for p, v, (roll, pitch, yaw) in zip(params, verts, rpy):
            x0, y0 = np.floor(v[:, :2].min(0)).astype(int)
            x1, y1 = np.ceil(v[:, :2].max(0)).astype(int)
            heads.append(pkg_info.HeadMetadata(
                bbox=pkg_info.Bbox(x=x0, y=y0, w=x1 - x0, h=y1 - y0), score=0.9,
                flame_params=pkg_info.FlameParams.from_3dmm(p[None]), vertices_3d=v.copy(),
                head_pose=pkg_info.RPY(roll=float(roll), pitch=float(pitch), yaw=float(yaw))))
        kw = {} if pkg_result is jax_result else {"device": "cpu"}
        out.append(pkg_result.PredictionResult(image.copy(), heads, **kw))
    return out


@pytest.fixture(scope="module")
def results(head_numbers):
    # smooth texture: a gradient of at most ~20 levels a pixel keeps float32
    # rounding of the sample coordinates (the JAX warp's are FMA-contracted)
    # well under 1e-3 of a level
    yy, xx = np.mgrid[:SIZE, :SIZE]
    image = np.stack([127.5 + 127 * np.sin(xx / 7.0 + c) * np.cos(yy / 9.0 - c)
                      for c in (0.0, 1.0, 2.0)], -1).astype(np.uint8)
    return _results(head_numbers, image)


@pytest.mark.parametrize("method", sorted(jax_result.DRAW_MAPPING))
def test_draw_is_byte_equal(results, method):
    assert sorted(detection_result.DRAW_MAPPING) == sorted(jax_result.DRAW_MAPPING)
    want, got = (r.draw(method) for r in results)
    assert got.dtype == np.uint8 and not np.array_equal(got, results[1].original_image)
    np.testing.assert_array_equal(got, want)


def test_aligned_heads_are_byte_equal(results):
    want, got = (r.get_aligned_heads() for r in results)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.size > 0 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_save_meshes_is_byte_identical(results, tmp_path):
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    results[0].save_meshes(str(want_dir))
    results[1].save_meshes(str(got_dir))
    names = sorted(os.listdir(got_dir))
    assert names == sorted(os.listdir(want_dir)) == [f"head_{i}.obj" for i in range(4)]
    for name in names:
        assert filecmp.cmp(got_dir / name, want_dir / name, shallow=False)
    with open(got_dir / "head_0.obj") as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("v ") and lines[5023].startswith("f ")
    assert min(int(i) for line in lines[5023:] for i in line.split()[1:]) == 1


def test_aligned_heads_batched_matches_jax(results):
    want = jax_alignment.aligned_heads_batched(results[0], out_size=64)
    got = head_alignment.aligned_heads_batched(results[1], out_size=64)
    assert got.shape == (4, 64, 64, 3) and got.dtype == np.float32 and got.max() > 0
    np.testing.assert_allclose(got, want, atol=1e-3)
    empty = detection_result.PredictionResult(results[1].original_image, [], device="cpu")
    assert head_alignment.aligned_heads_batched(empty, 32).shape == (0, 32, 32, 3)


@pytest.fixture(scope="module")
def picture():
    return np.random.RandomState(1).uniform(0, 255, (90, 120, 3)).astype(np.float32)


def test_affine_warp_matches_jax(picture):
    rng = np.random.RandomState(2)
    mats = []
    for angle in (0.0, 17.0, -100.0, 181.0):
        t = np.deg2rad(angle)
        s = rng.uniform(0.5, 2.0)
        mats.append([[s * np.cos(t), -s * np.sin(t), rng.uniform(-20, 60)],
                     [s * np.sin(t), s * np.cos(t), rng.uniform(-20, 40)]])
    inv = warp.invert_affine(np.asarray(mats))
    np.testing.assert_array_equal(inv, jax_warp.invert_affine(np.asarray(mats)))
    want = np.asarray(jax_warp.affine_warp(jnp.asarray(picture), jnp.asarray(inv), 48, 56,
                                           fill_value=3.0))
    got = warp.affine_warp(torch.from_numpy(picture), torch.from_numpy(inv), 48, 56,
                           fill_value=3.0).numpy()
    assert got.shape == (4, 48, 56, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    as_u8 = picture.astype(np.uint8)
    np.testing.assert_array_equal(
        warp.warp_like_cv2(as_u8, np.asarray(mats[1]), (56, 48), device="cpu"),
        jax_warp.warp_like_cv2(as_u8, np.asarray(mats[1]), (56, 48)))


def test_matmul_crops_match_jax(picture):
    boxes = np.array([[10, 5, 70, 65], [-10, 30, 50, 100], [60, 0, 130, 40]], np.float32)
    angles = np.array([0.0, 30.0, -135.0], np.float32)
    np.testing.assert_allclose(
        warp.scaled_crops_matmul(torch.from_numpy(picture), torch.from_numpy(boxes), 32).numpy(),
        np.asarray(jax_warp.scaled_crops_matmul(jnp.asarray(picture), jnp.asarray(boxes), 32)),
        atol=1e-3)
    crops = np.random.RandomState(4).uniform(0, 255, (3, 24, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(
        warp.rotate_crops_matmul(torch.from_numpy(crops), torch.from_numpy(angles)).numpy(),
        np.asarray(jax_warp.rotate_crops_matmul(jnp.asarray(crops), jnp.asarray(angles))),
        atol=1e-3)
    got = warp.aligned_crops_matmul(torch.from_numpy(picture), torch.from_numpy(boxes),
                                    torch.from_numpy(angles), out_size=32).numpy()
    want = np.asarray(jax_warp.aligned_crops_matmul(jnp.asarray(picture), jnp.asarray(boxes),
                                                    jnp.asarray(angles), out_size=32))
    assert got.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
