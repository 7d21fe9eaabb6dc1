"""Rotation math: 6DoF -> R, Rodrigues, R -> roll/pitch/yaw (batched torch).

Counterpart of ``head_detector_tpu/ops/rotation.py``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.head_info import RPY


def _normalize(x: torch.Tensor) -> torch.Tensor:
    # x / max(||x||, 1e-12), the torch.nn.functional.normalize rule
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-12)


def rot_mat_from_6dof(v: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] with the Gram-Schmidt basis as *columns*."""
    vx = v[..., :3]
    vy = v[..., 3:6]
    b1 = _normalize(vx)
    b3 = _normalize(torch.linalg.cross(b1, vy, dim=-1))
    b2 = -torch.linalg.cross(b1, b3, dim=-1)
    return torch.stack((b1, b2, b3), dim=-1)


def rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle vectors -> rotation matrices ([..., 3] -> [..., 3, 3])."""
    angle = torch.linalg.vector_norm(rot_vecs + eps, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle

    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]

    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    outer = rot_dir[..., :, None] * rot_dir[..., None, :]
    return cos * ident + (1 - cos) * outer + sin * K


def _euler_xyz_extrinsic(R: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z Euler angles (radians), R = Rz(c) @ Ry(b) @ Rx(a)."""
    r20 = torch.clamp(R[..., 2, 0], -1.0, 1.0)
    b = -torch.arcsin(r20)
    safe = torch.abs(torch.cos(b)) > 1e-6
    a = torch.where(
        safe,
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
        torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
    )
    c = torch.where(safe, torch.atan2(R[..., 1, 0], R[..., 0, 0]), torch.zeros_like(b))
    return torch.stack([a, b, c], dim=-1)


def limit_angle(a: torch.Tensor, pi: float = 180.0) -> torch.Tensor:
    """Wrap degrees to [-pi, pi] with the reference's boundary quirks
    (trunc-then-floor-div correction factors, both branches in sequence)."""
    t0 = torch.trunc(a / pi)
    k_neg = -2.0 * torch.floor(t0 / 2.0)
    a1 = torch.where(a < -pi, a + k_neg * pi, a)
    t1 = torch.trunc(a1 / pi)
    k_pos = 2.0 * torch.floor((t1 + 1.0) / 2.0)
    return torch.where(a1 > pi, a1 - k_pos * pi, a1)


def rotation_mats_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> (roll, pitch, yaw) degrees: the xyz-extrinsic
    angles of R^T; roll = euler[2], pitch = euler[0] - 180, yaw = euler[1]."""
    euler = _euler_xyz_extrinsic(R.transpose(-1, -2)) * (180.0 / math.pi)
    roll = limit_angle(euler[..., 2])
    pitch = limit_angle(euler[..., 0] - 180.0)
    yaw = limit_angle(euler[..., 1])
    return torch.stack([roll, pitch, yaw], dim=-1)


def calculate_rpy(rotation_6dof):
    """One head's 6DoF rotation parameters -> ``RPY`` in degrees."""
    v = torch.as_tensor(rotation_6dof, dtype=torch.float32).reshape(1, 6)
    rpy = rotation_mats_to_rpy(rot_mat_from_6dof(v))[0].tolist()
    return RPY(roll=rpy[0], pitch=rpy[1], yaw=rpy[2])
