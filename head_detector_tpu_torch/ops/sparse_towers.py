"""Sparse post-NMS FLAME towers: the 413 params only at the kept anchors.

Counterpart of ``head_detector_tpu/ops/sparse_towers.py``.  The tower stack
is a 1x1 pose stem + N 3x3 convs + a 1x1 pred, so a ``(2N+1)``-pixel square
patch of the neck map around an anchor yields exactly that anchor's
413-vector when the 3x3 convs run without padding.  The dense convs zero-pad
every layer at the map border, so out-of-map pixels are re-zeroed after
every layer (``_boundary_masks``); those masks are load-bearing.

Layout: the neck maps are NCHW; patches are ``[R, K, C, rf, rf]``.  The
towers run in the features' dtype; the rows come back in float32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch.nn import functional as F

from head_detector_tpu_torch.head_info import NUM_FLAME_PARAMS
from head_detector_tpu_torch.models.heads import (
    TOWERS,
    YoloHeadsDFLHead,
    YoloHeadsNDFLHeads,
    flame_vector,
)
from head_detector_tpu_torch.models.presets import ArchCfg


def _in_map(ys, xs, h, w, m):
    """[R, K, 2m+1, 2m+1] mask of patch pixels inside the h x w map, and the
    clamped row/col coordinates."""
    d = torch.arange(-m, m + 1, device=ys.device)
    yy = ys[..., None] + d
    xx = xs[..., None] + d
    ok = ((yy >= 0) & (yy < h))[..., :, None] & ((xx >= 0) & (xx < w))[..., None, :]
    return ok, yy.clamp(0, h - 1), xx.clamp(0, w - 1)


def extract_patches(
    feat: torch.Tensor,  # [B, C, H, W]
    ys: torch.Tensor,  # [R, K] (may be out of range; masked)
    xs: torch.Tensor,  # [R, K]
    rf: int,
    batch_idx: Optional[torch.Tensor] = None,  # [R, K] source image per slot
) -> torch.Tensor:
    """[R, K, C, rf, rf] patches centered at (ys, xs), zero outside the map.
    Without ``batch_idx`` row r of (ys, xs) indexes image r (R == B)."""
    b, c, h, w = feat.shape
    r, k = ys.shape
    ok, yy, xx = _in_map(ys, xs, h, w, rf // 2)
    if batch_idx is None:
        if r != b:
            raise ValueError(f"need one coord row per image: {r} != {b}")
        batch_idx = torch.arange(r, device=ys.device)[:, None].expand(r, k)
    nhwc = feat.permute(0, 2, 3, 1)
    rows = nhwc[
        batch_idx[..., None, None], yy[..., :, None], xx[..., None, :]
    ]  # [R, K, rf, rf, C]
    rows = rows * ok[..., None].to(rows.dtype)
    return rows.permute(0, 1, 4, 2, 3)


def _boundary_masks(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int,
                    rf: int) -> List[torch.Tensor]:
    """Per-layer in-map masks, [R*K, 1, m2, m2] for m2 = rf, rf-2, ..., 1."""
    r, k = ys.shape
    masks = []
    for level in range(rf // 2 + 1):
        m = rf // 2 - level
        ok = _in_map(ys, xs, h, w, m)[0]
        masks.append(ok.reshape(r * k, 1, 2 * m + 1, 2 * m + 1))
    return masks


def _tower_rows(head: YoloHeadsDFLHead, patches: torch.Tensor,
                masks: List[torch.Tensor]) -> torch.Tensor:
    """pose_stem + the six towers on patches -> [R, K, 413] rows."""
    r, k, c, rf, _ = patches.shape
    # pose stem: 1x1 conv, BatchNorm folded to a multiply-add in the
    # features' dtype (as the reference's sparse path does), ReLU
    stem = head.pose_stem
    x = F.conv2d(patches.reshape(r * k, c, rf, rf), stem.conv.weight)
    mul = stem.bn.weight / torch.sqrt(stem.bn.running_var + stem.bn.eps)
    add = stem.bn.bias - stem.bn.running_mean * mul
    x = F.relu(x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None])
    x = x * masks[0].to(x.dtype)  # BN/ReLU make padded zeros nonzero

    outputs = []
    for name in TOWERS:
        tower = getattr(head, name)
        y = x
        for i in range(tower.num_blocks):
            conv = getattr(tower, f"block{i}").rbr_reparam
            y = F.relu(F.conv2d(y, conv.weight, conv.bias))  # VALID 3x3
            y = y * masks[i + 1].to(y.dtype)
        y = tower.pred(y)
        if y.shape[2] != 1 or y.shape[3] != 1:
            raise ValueError(
                f"receptive field mismatch: tower left {y.shape[2]}x{y.shape[3]}; "
                "patch rf must be 2*num_blocks+1"
            )
        outputs.append(y.reshape(r * k, -1))
    return flame_vector(outputs).reshape(r, k, NUM_FLAME_PARAMS)


def sparse_flame_rows(
    heads: YoloHeadsNDFLHeads,
    arch: ArchCfg,
    feats: Sequence[torch.Tensor],  # neck pyramid (p3, p4, p5), NCHW
    anchor_idx: torch.Tensor,  # [R, K] global anchor indices
    batch_idx: Optional[torch.Tensor] = None,  # [R, K] source image per slot
) -> torch.Tensor:
    """FLAME rows [R, K, 413] (float32, anchor-local, before globalisation)
    equal to the dense head's rows at those anchors."""
    r, k = anchor_idx.shape
    out = torch.zeros((r, k, NUM_FLAME_PARAMS), dtype=torch.float32,
                      device=anchor_idx.device)
    base = 0
    for i, feat in enumerate(feats):
        _, _, h, w = feat.shape
        count = h * w
        rf = 2 * arch.heads[i].flame_regression_blocks + 1
        in_scale = (anchor_idx >= base) & (anchor_idx < base + count)
        local = torch.where(in_scale, anchor_idx - base, 0)
        ys, xs = local // w, local % w
        patches = extract_patches(feat, ys, xs, rf, batch_idx=batch_idx)
        masks = _boundary_masks(ys, xs, h, w, rf)
        rows = _tower_rows(getattr(heads, f"head{i + 1}"), patches, masks)
        out = torch.where(in_scale[..., None], rows.float(), out)
        base += count
    return out
