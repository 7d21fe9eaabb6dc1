"""Elementwise loss functions (focal/BCE/DFL/vertices/rotation/OKS), torch.

Counterpart of ``head_detector_tpu/train/losses.py``.  Every function
returns *unreduced* per-element values; masking and normalisation happen in
:mod:`head_detector_tpu_torch.train.loss`.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable binary cross entropy on logits, elementwise."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


def focal_loss(pred_logits: torch.Tensor, label: torch.Tensor, alpha: float = -1.0,
               gamma: float = 2.0) -> torch.Tensor:
    """Quality focal loss, elementwise (alpha <= 0: no class-balance term)."""
    pred_score = torch.sigmoid(pred_logits)
    weight = torch.abs(pred_score - label) ** gamma
    if alpha > 0:
        weight = weight * (alpha * label + (1 - alpha) * (1 - label))
    return weight * bce_with_logits(pred_logits, label)


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution-focal loss: pred_dist [..., 4, reg_max+1] logits, target
    [..., 4] in [0, reg_max) -> [..., 1], the mean over the 4 sides."""
    target_left = target.to(torch.int64)
    target_right = target_left + 1
    weight_left = target_right.to(target.dtype) - target
    weight_right = 1.0 - weight_left
    log_probs = torch.log_softmax(pred_dist, dim=-1)
    nbins = pred_dist.shape[-1]
    ce_left = -torch.gather(log_probs, -1, target_left.clamp(0, nbins - 1)[..., None])[..., 0]
    ce_right = -torch.gather(log_probs, -1, target_right.clamp(0, nbins - 1)[..., None])[..., 0]
    return (ce_left * weight_left + ce_right * weight_right).mean(-1, keepdim=True)


def normalize_to_cube(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Normalise vertex sets to the unit cube [-1, 1]^3 per instance (eps
    guards padded rows)."""
    v = v - v.amin(dim=-2, keepdim=True)
    v = v - 0.5 * v.amax(dim=-2, keepdim=True)
    denom = v.amax(dim=-1, keepdim=True).amax(dim=-2, keepdim=True)
    return v / torch.clamp(denom, min=eps)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def vertices_3d_loss(pred: torch.Tensor, target: torch.Tensor,
                     criterion: str = "smooth_l1") -> torch.Tensor:
    """Per-element loss between cube-normalised vertex sets [..., V, 3]."""
    p = normalize_to_cube(pred.to(torch.float32))
    t = normalize_to_cube(target.to(torch.float32))
    if criterion == "l1":
        return torch.abs(p - t)
    if criterion == "l2":
        return (p - t) ** 2
    if criterion == "smooth_l1":
        return smooth_l1(p, t)
    raise ValueError(f"Unsupported vertices loss {criterion!r}")


def rotation_loss(pred: torch.Tensor, target: torch.Tensor, kind: str = "geodesic",
                  eps: float = 1e-7) -> torch.Tensor:
    """Per-instance rotation distance for [..., 3, 3] matrices -> [...].  The
    geodesic ``acos`` argument is clipped to [-1 + eps, 1 - eps], so that its
    gradient stays finite at the identity."""
    if kind == "frobenius":
        return torch.linalg.matrix_norm(pred - target)
    if kind == "geodesic":
        diffs = torch.einsum("...ij,...kj->...ik", pred, target)  # R1 @ R2^T
        traces = diffs.diagonal(dim1=-2, dim2=-1).sum(-1)
        return torch.arccos(torch.clamp((traces - 1.0) / 2.0, -1.0 + eps, 1.0 - eps))
    if kind == "cosine":
        product = torch.einsum("...ji,...jk->...ik", pred, target)  # R1^T @ R2
        trace = product.diagonal(dim1=-2, dim2=-1).sum(-1)
        return 1.0 - trace / 3.0
    raise ValueError(f"Unsupported rotation loss {kind!r}")


def oks_keypoint_loss(pred_coords: torch.Tensor, target_coords: torch.Tensor,
                      area: torch.Tensor, sigma: float, eps: float = 1e-9) -> torch.Tensor:
    """OKS-style keypoint loss over [..., K, 2] coordinates with ``area``
    [..., 1], reduced over keypoints -> [...]."""
    d = ((pred_coords - target_coords) ** 2).sum(-1)
    e = d / (2 * sigma) ** 2 / (area + eps) / 2
    return (1.0 - torch.exp(-e)).mean(-1)
