"""Port parity on the CPU: assets, head_info, rotation and FLAME decode.

Inputs are made from seeds with numpy and fed to the JAX function and to its
counterpart in head_detector_tpu_torch (device="cpu").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu import assets_io as jax_assets
from head_detector_tpu import flame as jax_flame
from head_detector_tpu import head_info as jax_head_info
from head_detector_tpu.ops import rotation as jax_rotation
from head_detector_tpu_torch import assets_io, flame, head_info
from head_detector_tpu_torch.ops import rotation


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


@pytest.fixture(scope="module")
def models():
    return jax_flame.FlameModel.from_assets(), flame.FlameModel.from_assets(device="cpu")


@pytest.fixture(scope="module")
def params():
    rng = np.random.RandomState(5)
    p = rng.normal(scale=0.5, size=(8, 413)).astype(np.float32)
    p[:, 409:411] = rng.uniform(50, 200, (8, 2))
    p[:, 412] = rng.uniform(40, 150, 8)
    return p


def test_assets_equal_arrays():
    want = jax_assets.load_flame_assets()
    got = assets_io.load_flame_assets()
    assert got.synthetic_basis == want.synthetic_basis
    for field in ("v_template", "shapedirs", "posedirs", "j_regressor", "parents",
                  "lbs_weights", "faces", "face_indices", "head_indices",
                  "head_w_ears_indices", "triangles"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_head_info_wire_format_and_swap():
    assert head_info.FLAME_CONSTS == jax_head_info.FLAME_CONSTS
    x = np.arange(2 * 413, dtype=np.float32).reshape(2, 413)
    got = head_info.FlameParams.from_3dmm(x)
    want = jax_head_info.FlameParams.from_3dmm(x)
    for name in ("shape", "expression", "rotation", "jaw", "translation", "scale",
                 "eyeballs", "neck"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.to_3dmm_tensor(), want.to_3dmm_tensor())
    # torch tensors go through the same slicing and the jaw<->rotation swap
    t = head_info.FlameParams.from_3dmm(torch.from_numpy(x)).to_3dmm_tensor()
    np.testing.assert_array_equal(t.numpy(), want.to_3dmm_tensor())
    assert not np.array_equal(t.numpy(), x)  # the swap is real


def test_rotation_functions(params):
    rot6 = params[:, 403:409]
    R_j = np.array(jax_rotation.rot_mat_from_6dof(jnp.asarray(rot6)))
    R_t = rotation.rot_mat_from_6dof(torch.from_numpy(rot6)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)

    aa = np.random.RandomState(1).normal(scale=0.7, size=(8, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        rotation.rodrigues(torch.from_numpy(aa)).numpy(),
        np.asarray(jax_rotation.rodrigues(jnp.asarray(aa))), atol=1e-6,
    )
    np.testing.assert_allclose(
        rotation.rotation_mats_to_rpy(torch.from_numpy(R_j)).numpy(),
        np.asarray(jax_rotation.rotation_mats_to_rpy(jnp.asarray(R_j))), atol=1e-3,
    )
    angles = np.array([540.0, -900.0, 180.0, -180.0, 12.5, -725.0], np.float32)
    np.testing.assert_array_equal(
        rotation.limit_angle(torch.from_numpy(angles)).numpy(),
        np.asarray(jax_rotation.limit_angle(jnp.asarray(angles))),
    )


def test_fused_project_vertices_parity(models, params):
    jm, tm = models
    R_j, v_j = jax_flame.fused_project_vertices(jm, jnp.asarray(params))
    R_t, v_t = flame.fused_project_vertices(tm, torch.from_numpy(params))
    assert v_t.shape == (8, 5023, 3)
    assert _rel(v_t, v_j) <= 1e-5
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-6)


def test_reproject_spatial_vertices_parity(models, params):
    jm, tm = models
    canon_j, R_j, proj_j = jax_flame.reproject_spatial_vertices(
        jm, jnp.asarray(params), to_2d=False
    )
    canon_t, R_t, proj_t = flame.reproject_spatial_vertices(
        tm, torch.from_numpy(params), to_2d=False
    )
    assert _rel(canon_t, canon_j) <= 1e-5
    assert _rel(proj_t, proj_j) <= 1e-5
    # 2D form and the fused path agree with the unfused one
    _, _, proj2 = flame.reproject_spatial_vertices(tm, torch.from_numpy(params))
    assert proj2.shape == (8, 5023, 2)
    _, fused = flame.fused_project_vertices(tm, torch.from_numpy(params))
    assert _rel(fused, proj_t) <= 1e-5


@pytest.mark.parametrize("zero_rot", [False, True])
def test_flame_vertices_parity(models, params, zero_rot):
    jm, tm = models
    want = jax_flame.flame_vertices(
        jm, jax_head_info.FlameParams.from_3dmm(jnp.asarray(params)), zero_rot=zero_rot
    )
    got = flame.flame_vertices(
        tm, head_info.FlameParams.from_3dmm(torch.from_numpy(params)), zero_rot=zero_rot
    )
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("subset", ["head", "face", "keypoint_445"])
def test_subset_decode_matches_jax_and_full_rows(models, params, subset):
    """FlameModel.subset: the subset decode against JAX's and against the
    rows of the full decode (the joints stay the full mesh's); relative L2
    <= 1e-5.  Named subsets and the remapped faces equal JAX's."""
    jm, tm = models
    idx = assets_io.get_indices()[subset]
    np.testing.assert_array_equal(idx, jax_assets.get_indices()[subset])
    jsub, tsub = jm.subset(idx), tm.subset(idx)
    np.testing.assert_array_equal(tsub.faces.numpy(), np.asarray(jsub.faces))
    np.testing.assert_allclose(tsub.joint_template.numpy(), np.asarray(jsub.joint_template),
                               rtol=1e-6, atol=1e-7)
    _, want = jax_flame.fused_project_vertices(jsub, jnp.asarray(params))
    _, got = flame.fused_project_vertices(tsub, torch.from_numpy(params))
    _, full = flame.fused_project_vertices(tm, torch.from_numpy(params))
    assert got.shape == (8, idx.size, 3)
    assert _rel(got, want) <= 1e-5
    assert _rel(got, full[:, idx]) <= 1e-5


@pytest.mark.parametrize("subset", [None, "face"])
def test_get_normal_matches_jax(models, params, subset):
    """Per-vertex normals of a posed mesh (on a subset: vertices no
    triangle touches keep a zero normal) against JAX within 1e-5."""
    from head_detector_tpu.ops.rasterize import get_normal as jax_get_normal
    from head_detector_tpu_torch.ops.rasterize import get_normal

    _, tm = models
    model = tm.subset(assets_io.get_indices()[subset]) if subset else tm
    _, verts = flame.fused_project_vertices(model, torch.from_numpy(params[:1]))
    v, faces = verts[0].numpy(), model.faces.numpy()
    want = np.asarray(jax_get_normal(jnp.asarray(v), jnp.asarray(faces)))
    got = get_normal(torch.from_numpy(v), torch.from_numpy(faces)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    norms = np.linalg.norm(got, axis=1)
    assert np.allclose(norms[norms > 0], 1.0, atol=1e-5) and (norms > 0).mean() > 0.5
