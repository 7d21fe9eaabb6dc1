"""Box utilities of the assigner and the loss (fixed-shape, batched torch).

Counterpart of ``head_detector_tpu/train/boxes.py``.  Ties are broken as
JAX breaks them: the top-k is a stable descending sort (``jax.lax.top_k``
returns the lower index first among equal values; ``torch.topk`` promises
no order), and ``torch.argmax`` returns the first maximal index, as
``jnp.argmax`` does.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F


def batch_iou_similarity(box1: torch.Tensor, box2: torch.Tensor,
                         eps: float = 1e-9) -> torch.Tensor:
    """IoU between two batched box sets: [B, N, 4] x [B, L, 4] -> [B, N, L]."""
    px1y1, px2y2 = box1[:, :, None, :2], box1[:, :, None, 2:]
    gx1y1, gx2y2 = box2[:, None, :, :2], box2[:, None, :, 2:]
    x1y1 = torch.maximum(px1y1, gx1y1)
    x2y2 = torch.minimum(px2y2, gx2y2)
    overlap = torch.clamp(x2y2 - x1y1, min=0).prod(-1)
    area1 = torch.clamp(px2y2 - px1y1, min=0).prod(-1)
    area2 = torch.clamp(gx2y2 - gx1y1, min=0).prod(-1)
    union = area1 + area2 - overlap + eps
    return overlap / union


def check_points_inside_bboxes(points: torch.Tensor, bboxes: torch.Tensor,
                               eps: float = 1e-9) -> torch.Tensor:
    """points [L, 2] pixel centers, bboxes [B, N, 4] xyxy -> [B, N, L] float."""
    x, y = points[:, 0], points[:, 1]
    xmin, ymin, xmax, ymax = (bboxes[..., i][..., None] for i in range(4))
    l = x[None, None] - xmin
    t = y[None, None] - ymin
    r = xmax - x[None, None]
    b = ymax - y[None, None]
    delta = torch.minimum(torch.minimum(l, t), torch.minimum(r, b))
    return (delta > eps).to(torch.float32)


def stable_topk_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim, the lower index first
    among equal values (the order of ``jax.lax.top_k``)."""
    return torch.sort(values, dim=-1, descending=True, stable=True)[1][..., :k]


def gather_topk_anchors(metrics: torch.Tensor, topk: int, topk_mask: torch.Tensor,
                        eps: float = 1e-9) -> torch.Tensor:
    """Top-k per gt over anchors -> membership mask [B, N, L] float;
    ``topk_mask`` is the [B, N, 1] pad-gt mask."""
    num_anchors = metrics.shape[-1]
    k = min(topk, num_anchors)
    idx = stable_topk_indices(metrics, k)  # [B, N, k]
    is_in_topk = torch.zeros_like(metrics).scatter_(-1, idx, 1.0)
    return is_in_topk * topk_mask.to(metrics.dtype)


def compute_max_iou_anchor(ious: torch.Tensor) -> torch.Tensor:
    """For each anchor, one-hot over gts of its max-IoU gt: [B, N, L] float."""
    num_max_boxes = ious.shape[-2]
    max_iou_index = torch.argmax(ious, dim=-2)  # [B, L]
    return F.one_hot(max_iou_index, num_max_boxes).to(ious.dtype).transpose(-1, -2)


def batch_distance2bbox(points: torch.Tensor, distance: torch.Tensor) -> torch.Tensor:
    """ltrb distances + center points -> xyxy boxes (broadcasts over batch)."""
    x1y1 = points - distance[..., :2]
    x2y2 = points + distance[..., 2:]
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy boxes -> ltrb distances, clipped to [0, reg_max - 0.01]."""
    lt = points - bbox[..., :2]
    rb = bbox[..., 2:] - points
    return torch.clamp(torch.cat([lt, rb], dim=-1), 0, reg_max - 0.01)


def _box_wh(box):
    return box[..., 2] - box[..., 0], box[..., 3] - box[..., 1]


def _iou_terms(pred, target, eps):
    ix1 = torch.maximum(pred[..., 0], target[..., 0])
    iy1 = torch.maximum(pred[..., 1], target[..., 1])
    ix2 = torch.minimum(pred[..., 2], target[..., 2])
    iy2 = torch.minimum(pred[..., 3], target[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    pw, ph = _box_wh(pred)
    tw, th = _box_wh(target)
    union = pw * ph + tw * th - inter + eps
    cx1 = torch.minimum(pred[..., 0], target[..., 0])
    cy1 = torch.minimum(pred[..., 1], target[..., 1])
    cx2 = torch.maximum(pred[..., 2], target[..., 2])
    cy2 = torch.maximum(pred[..., 3], target[..., 3])
    return inter / union, union, (pw, ph, tw, th), (cx1, cy1, cx2, cy2)


def giou_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Elementwise 1 - GIoU for xyxy boxes [..., 4] -> [...]."""
    iou, union, _, (cx1, cy1, cx2, cy2) = _iou_terms(pred, target, eps)
    c_area = (cx2 - cx1) * (cy2 - cy1) + eps
    return 1.0 - (iou - (c_area - union) / c_area)


def ciou_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Elementwise 1 - CIoU (complete IoU) for xyxy boxes [..., 4] -> [...];
    the aspect term's weight carries no gradient, as in the reference."""
    iou, _, (pw, ph, tw, th), (cx1, cy1, cx2, cy2) = _iou_terms(pred, target, eps)
    c2 = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2 + eps
    pcx = (pred[..., 0] + pred[..., 2]) * 0.5
    pcy = (pred[..., 1] + pred[..., 3]) * 0.5
    tcx = (target[..., 0] + target[..., 2]) * 0.5
    tcy = (target[..., 1] + target[..., 3]) * 0.5
    rho2 = (pcx - tcx) ** 2 + (pcy - tcy) ** 2
    v = (4.0 / (math.pi ** 2)) * (
        torch.arctan(tw / (th + eps)) - torch.arctan(pw / (ph + eps))
    ) ** 2
    alpha = (v / torch.clamp(1.0 - iou + v, min=eps)).detach()
    return 1.0 - (iou - rho2 / c2 - alpha * v)
