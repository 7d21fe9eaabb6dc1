"""FLAME 3DMM decoder in torch: blendshapes + LBS + 6DoF similarity transform.

Counterpart of ``head_detector_tpu/flame.py``.  Conventions kept exactly:

* betas = concat(shape padded to 300, expression padded to 100);
* full pose = [global=0, neck, jaw, eyeballs]; the head rotation is applied
  after LBS from the 6DoF params;
* after LBS, ``z += MESH_OFFSET_Z`` (0.05);
* ``reproject_spatial_vertices``: canonical verts -> rotate by the 6DoF R ->
  scale (clamped >= 1e-8) -> + translation.

Every contraction runs in full float32 (TF32 off, see ``device.py``).  The
``[N, 400] x [400, V*3]`` blendshape product is a plain ``torch.matmul``.
``FlameModel.subset`` decodes a vertex subset with the joints of the full
mesh (the joint regression folded into per-joint constants in float64).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.assets_io import FlameAssets, load_flame_assets
from benchmark.reference.device import exact_float32, resolve_device
from benchmark.reference.head_info import FlameParams
from benchmark.reference.rotation import rodrigues, rot_mat_from_6dof

MAX_SHAPE = 300
MAX_EXPRESSION = 100
MESH_OFFSET_Z = 0.05


@dataclasses.dataclass(frozen=True)
class FlameModel:
    """FLAME constants as tensors on one device."""

    v_template: torch.Tensor  # [V, 3]
    shapedirs_flat: torch.Tensor  # [400, V*3]
    posedirs: torch.Tensor  # [36, V*3]
    j_regressor: torch.Tensor  # [J, V]
    lbs_weights: torch.Tensor  # [V, J]
    parents: Tuple[int, ...]
    faces: torch.Tensor  # [F, 3] int32
    # set by subset(): joints regressed from betas directly, so that the
    # per-vertex arrays may cover a subset while the joints stay the full mesh's
    joint_template: Optional[torch.Tensor] = None  # [J, 3]
    joint_shapedirs: Optional[torch.Tensor] = None  # [400, J*3]

    @classmethod
    def from_assets(
        cls,
        assets: Optional[FlameAssets] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ) -> "FlameModel":
        dev = resolve_device(device)
        if assets is None:
            assets = load_flame_assets()
        v = assets.v_template.shape[0]
        shapedirs_flat = assets.shapedirs.reshape(v * 3, -1).T  # [400, V*3]

        def t(x, dt=dtype):
            return torch.as_tensor(x.copy(), dtype=dt, device=dev)

        return cls(
            v_template=t(assets.v_template),
            shapedirs_flat=t(shapedirs_flat).contiguous(),
            posedirs=t(assets.posedirs),
            j_regressor=t(assets.j_regressor),
            lbs_weights=t(assets.lbs_weights),
            parents=tuple(int(p) for p in assets.parents),
            faces=t(assets.faces, torch.int32),
        )

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def subset(self, indices) -> "FlameModel":
        """The same decode on ``len(indices)`` vertices.  Joints regress from
        the full shaped mesh, which is affine in betas, so they fold into
        ``joint_template = Jreg @ v_template`` and ``joint_shapedirs = Jreg @
        shapedirs`` (float64, then the model's dtype) while every per-vertex
        array is sliced.  Faces keep the triangles wholly inside the subset,
        renumbered."""
        idx = np.asarray(indices, np.int64)
        v = self.num_vertices
        nb = self.shapedirs_flat.shape[0]
        dtype, dev = self.v_template.dtype, self.device

        def host(t):
            return t.detach().cpu().numpy()

        sd3 = host(self.shapedirs_flat).reshape(nb, v, 3)
        jreg = host(self.j_regressor).astype(np.float64)
        joint_template = jreg @ host(self.v_template).astype(np.float64)  # [J, 3]
        joint_shapedirs = np.einsum("jv,kvc->kjc", jreg, sd3.astype(np.float64))
        nj = jreg.shape[0]

        faces = host(self.faces)
        inside = np.isin(faces, idx).all(axis=1)
        remap = np.full(v, -1, np.int64)
        remap[idx] = np.arange(idx.size)
        pd3 = host(self.posedirs).reshape(-1, v, 3)

        def t(x, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

        return FlameModel(
            v_template=t(host(self.v_template)[idx]),
            shapedirs_flat=t(sd3[:, idx].reshape(nb, idx.size * 3)),
            posedirs=t(pd3[:, idx].reshape(pd3.shape[0], idx.size * 3)),
            j_regressor=t(host(self.j_regressor)[:, idx]),
            lbs_weights=t(host(self.lbs_weights)[idx]),
            parents=self.parents,
            faces=t(remap[faces[inside]], torch.int32),
            joint_template=t(joint_template),
            joint_shapedirs=t(joint_shapedirs.reshape(nb, nj * 3)),
        )


def _pad_to(x: torch.Tensor, width: int) -> torch.Tensor:
    cur = x.shape[-1]
    if cur == width:
        return x
    return torch.nn.functional.pad(x, (0, width - cur))


def _make_tf(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[N,3,3], [N,3] -> [N,4,4] homogeneous transforms."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _rigid_transform_chain(
    rot_mats: torch.Tensor, joints: torch.Tensor, parents: Tuple[int, ...]
) -> torch.Tensor:
    """Forward kinematics -> [N, J, 4, 4] relative transforms with the rest
    joint removed (the ``A - pack(A @ [J;0])`` step of SMPL LBS)."""
    j = joints.shape[1]
    parent_joints = joints[:, [max(p, 0) for p in parents][1:]]
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), parent_joints], dim=1
    ) * torch.tensor(
        [0.0] + [1.0] * (j - 1), dtype=joints.dtype, device=joints.device
    )[None, :, None]

    world = [_make_tf(rot_mats[:, 0], rel_joints[:, 0])]
    for i in range(1, j):
        local = _make_tf(rot_mats[:, i], rel_joints[:, i])
        world.append(torch.matmul(world[parents[i]], local))
    A = torch.stack(world, dim=1)  # [N, J, 4, 4]

    correction = torch.einsum("njab,njb->nja", A[..., :3, :3], joints)
    A_rel = A.clone()
    A_rel[..., :3, 3] = A[..., :3, 3] - correction
    return A_rel


def lbs(
    model: FlameModel,
    betas: torch.Tensor,  # [N, 400]
    full_pose: torch.Tensor,  # [N, J*3]
    pre_transform: Optional[torch.Tensor] = None,  # [N, 4, 4]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning; ``pre_transform`` M is folded into the joint
    transforms (A_j <- M @ A_j), so it reaches the output without another
    [N, V, 3] pass.  Returns (vertices [N, V, 3], joints [N, J, 3])."""
    n = betas.shape[0]
    v = model.num_vertices
    dtype = model.v_template.dtype
    with exact_float32():
        offsets = torch.matmul(betas.to(dtype), model.shapedirs_flat).reshape(n, v, 3)
        v_shaped = model.v_template[None] + offsets
        if model.joint_template is not None:  # a subset model (see subset())
            nj = model.joint_template.shape[0]
            joints = model.joint_template[None] + torch.matmul(
                betas.to(dtype), model.joint_shapedirs).reshape(n, nj, 3)
        else:
            joints = torch.einsum("jv,nvc->njc", model.j_regressor, v_shaped)

        num_joints = full_pose.shape[-1] // 3
        rot_mats = rodrigues(full_pose.reshape(n, num_joints, 3))  # [N, J, 3, 3]
        ident = torch.eye(3, dtype=dtype, device=betas.device)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(n, (num_joints - 1) * 9)
        pose_offsets = torch.matmul(pose_feature, model.posedirs).reshape(n, v, 3)
        v_posed = v_shaped + pose_offsets

        A = _rigid_transform_chain(rot_mats, joints, model.parents)
        if pre_transform is not None:
            A = torch.einsum("nab,njbc->njac", pre_transform.to(dtype), A)
        j_ = A.shape[1]
        a12 = A[:, :, :3, :].reshape(n, j_, 12)
        T = torch.einsum("vj,njk->nvk", model.lbs_weights, a12).reshape(n, v, 3, 4)
        verts = torch.einsum("nvab,nvb->nva", T[..., :3], v_posed) + T[..., 3]
    return verts, joints


def _betas_and_pose(
    model: FlameModel, params: FlameParams
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack FlameParams into the (betas [N,400], full_pose [N,J*3]) LBS inputs."""
    n = params.shape.shape[0]
    dtype = model.v_template.dtype
    dev = params.shape.device
    betas = torch.cat(
        [
            _pad_to(params.shape.to(dtype), MAX_SHAPE),
            _pad_to(params.expression.to(dtype), MAX_EXPRESSION),
        ],
        dim=1,
    )

    def _or_zeros(x, width):
        if x is None or 0 in x.shape:
            return torch.zeros((n, width), dtype=dtype, device=dev)
        return x.to(dtype)

    neck = _or_zeros(params.neck, 3)
    eyeballs = _or_zeros(params.eyeballs, 6)
    jaw = _or_zeros(params.jaw, 3)
    global_rot = torch.zeros((n, 3), dtype=dtype, device=dev)
    return betas, torch.cat([global_rot, neck, jaw, eyeballs], dim=1)


def flame_vertices(
    model: FlameModel, params: FlameParams, zero_rot: bool = False
) -> torch.Tensor:
    """Vertices [N, V, 3] (FLAMELayer.forward): LBS, the z offset, then the
    6DoF rotation unless ``zero_rot`` (canonical vertices)."""
    dtype = model.v_template.dtype
    betas, full_pose = _betas_and_pose(model, params)
    verts, _ = lbs(model, betas, full_pose)
    verts = verts.clone()
    verts[:, :, 2] += MESH_OFFSET_Z
    if not zero_rot:
        R = rot_mat_from_6dof(params.rotation.to(dtype))
        with exact_float32():
            verts = torch.einsum("nab,nvb->nva", R, verts)
    return verts


def _flatten(flame_params: torch.Tensor):
    lead_shape = tuple(flame_params.shape[:-1])
    n = 1
    for d in lead_shape:
        n *= d
    return lead_shape, flame_params.reshape(n, flame_params.shape[-1])


def _finish(projected, lead_shape, to_2d, subset_indexes):
    if subset_indexes is not None:
        projected = projected[:, subset_indexes]
    if to_2d:
        projected = projected[..., :2]
    return projected.reshape(lead_shape + tuple(projected.shape[-2:]))


def reproject_spatial_vertices(
    model: FlameModel,
    flame_params: torch.Tensor,  # [..., 413]
    to_2d: bool = True,
    subset_indexes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed params -> (canonical verts [N, V, 3], R [N, 3, 3],
    projected [..., V, 2 or 3])."""
    lead_shape, flat = _flatten(flame_params)
    p = FlameParams.from_3dmm(flat)

    vertices = flame_vertices(model, p, zero_rot=True)
    R = rot_mat_from_6dof(p.rotation.to(vertices.dtype))
    with exact_float32():
        rot_vertices = torch.einsum("nab,nvb->nva", R, vertices)
    scale = torch.clamp(p.scale[:, None], min=1e-8)  # [N, 1, 1]
    projected = rot_vertices * scale + p.translation[:, None, :]
    return vertices, R, _finish(projected, lead_shape, to_2d, subset_indexes)


def fused_project_vertices(
    model: FlameModel,
    flame_params: torch.Tensor,  # [..., 413]
    to_2d: bool = False,
    subset_indexes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected vertices only: rotate / scale / translate and the z offset
    are one per-head affine ``M = [[s*R, s*R*[0,0,oz] + t], [0, 1]]`` folded
    into the skinning transforms.  Returns (R [N, 3, 3], projected)."""
    lead_shape, flat = _flatten(flame_params)
    p = FlameParams.from_3dmm(flat)
    dtype = model.v_template.dtype
    n = flat.shape[0]

    R = rot_mat_from_6dof(p.rotation.to(dtype))  # [N, 3, 3]
    scale = torch.clamp(p.scale.to(dtype), min=1e-8)  # [N, 1]
    sr = R * scale[:, :, None]
    t_eff = p.translation.to(dtype) + sr[:, :, 2] * MESH_OFFSET_Z
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=flat.device)
    m = torch.cat(
        [torch.cat([sr, t_eff[:, :, None]], dim=2), bottom.expand(n, 1, 4)], dim=1
    )

    betas, full_pose = _betas_and_pose(model, p)
    projected, _ = lbs(model, betas, full_pose, pre_transform=m)
    return R, _finish(projected, lead_shape, to_2d, subset_indexes)
