"""Task-aligned label assignment (TOOD-style), fixed-shape torch.

Counterpart of ``head_detector_tpu/train/assigner.py``:

1. alignment metric = score^alpha * IoU^beta between every (gt, anchor),
2. top-k (13) candidates per gt, restricted to anchors whose center is
   inside the gt box,
3. anchors claimed by several gts resolve to the max-IoU gt,
4. assigned scores = one-hot * alignment metric rescaled per instance by its
   max IoU.

GT comes padded to a fixed N with ``pad_gt_mask``; the resolution of
contested anchors is applied unconditionally (the identity where no anchor
is contested).  Ties go to the lower index (``boxes.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from head_detector_tpu_torch.train.boxes import (
    batch_iou_similarity,
    check_points_inside_bboxes,
    compute_max_iou_anchor,
    gather_topk_anchors,
)


class AssignmentResult(NamedTuple):
    fg_mask: torch.Tensor  # [B, L] bool
    assigned_bboxes: torch.Tensor  # [B, L, 4]
    assigned_scores: torch.Tensor  # [B, L, 1]
    assigned_gt_index: torch.Tensor  # [B, L] int64 (into the padded gt dim)


@torch.no_grad()
def task_aligned_assigner(
    pred_scores: torch.Tensor,  # [B, L, 1] (already sigmoided)
    pred_bboxes: torch.Tensor,  # [B, L, 4] xyxy pixels
    anchor_points: torch.Tensor,  # [L, 2] pixel centers
    gt_bboxes: torch.Tensor,  # [B, N, 4] xyxy pixels (zero-padded)
    pad_gt_mask: torch.Tensor,  # [B, N, 1] float/bool
    topk: int = 13,
    alpha: float = 1.0,
    beta: float = 6.0,
    eps: float = 1e-9,
) -> AssignmentResult:
    pad_gt_mask = pad_gt_mask.to(torch.float32)
    ious = batch_iou_similarity(gt_bboxes, pred_bboxes)  # [B, N, L]
    alignment = (pred_scores[..., 0][:, None, :] ** alpha) * (ious ** beta)

    is_in_gts = check_points_inside_bboxes(anchor_points, gt_bboxes)
    is_in_topk = gather_topk_anchors(alignment * is_in_gts, topk, pad_gt_mask)
    mask_positive = is_in_topk * is_in_gts * pad_gt_mask  # [B, N, L]

    mask_multiple = (mask_positive.sum(-2) > 1)[:, None, :].expand_as(mask_positive)
    mask_positive = torch.where(mask_multiple, compute_max_iou_anchor(ious), mask_positive)
    mask_positive_sum = mask_positive.sum(-2)

    assigned_gt_index = torch.argmax(mask_positive, dim=-2)  # [B, L]
    fg_mask = mask_positive_sum > 0
    assigned_bboxes = torch.gather(
        gt_bboxes, 1, assigned_gt_index[..., None].expand(-1, -1, 4))

    alignment = alignment * mask_positive
    max_metrics_per_instance = alignment.amax(-1, keepdim=True)
    max_ious_per_instance = (ious * mask_positive).amax(-1, keepdim=True)
    alignment = alignment / (max_metrics_per_instance + eps) * max_ious_per_instance
    assigned_scores = alignment.amax(-2)[..., None] * fg_mask[..., None]

    return AssignmentResult(
        fg_mask=fg_mask,
        assigned_bboxes=assigned_bboxes,
        assigned_scores=assigned_scores,
        assigned_gt_index=assigned_gt_index,
    )
