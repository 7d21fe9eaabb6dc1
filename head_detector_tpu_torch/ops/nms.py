"""Batched greedy NMS with fixed-size outputs, in torch.

Counterpart of ``head_detector_tpu/ops/nms.py`` (``batched_nms``,
``single_image_nms``, ``compact_detections``): confidence filter -> top-k
(``pre_nms_max``) -> greedy IoU suppression with torchvision semantics (a box
is suppressed when its IoU with a higher-scoring kept box is strictly above
the threshold; score ties break by original index through a stable sort) ->
the first ``post_nms_max`` kept boxes, padded with invalid slots.

The greedy pass is the reference's matrix form: iterate ``keep[i] = valid[i]
& !any_{j<i}(keep[j] & iou[i, j] > t)`` from the all-valid estimate until it
stops changing, which is the exact greedy answer after at most the
suppression-chain depth.

Param fusion (``fuse_flame``, ``return_neighbors``) is weighted-box-fusion
of the FLAME rows: a confidence-passing candidate joins the kept box it
overlaps best, if that IoU is >= ``fusion_iou`` and its score is not above
the kept box's (it comes at or after the kept box in score order), with its
score as weight.  A kept box is always its own candidate.  Boxes, scores and
the detection set are those of plain NMS.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from head_detector_tpu_torch.device import exact_float32


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # [B, K, 4] xyxy
    scores: torch.Tensor  # [B, K]
    flame_params: torch.Tensor  # [B, K, P]
    valid: torch.Tensor  # [B, K] bool
    anchor_idx: torch.Tensor  # [B, K] int64 (0 if invalid)


class NeighborInfo(NamedTuple):
    """Per kept detection, its top-n fusion candidates by weight (ties: the
    higher-scoring candidate first).  The serving path runs the FLAME towers
    at these anchors, globalises each row at its own anchor and takes the
    weighted mean."""

    anchor_idx: torch.Tensor  # [B, K, n] into the anchor axis (0 for empty slots)
    weights: torch.Tensor  # [B, K, n] float32 fusion weights (0 for empty slots)


class CompactDetections(NamedTuple):
    """Batch detections packed into M slots, valid first, score descending."""

    boxes: torch.Tensor  # [M, 4]
    scores: torch.Tensor  # [M]
    flame_params: torch.Tensor  # [M, P]
    valid: torch.Tensor  # [M] bool
    anchor_idx: torch.Tensor  # [M]
    batch_idx: torch.Tensor  # [M] source image (0 if invalid)
    slot_idx: torch.Tensor  # [M] source NMS slot (0 if invalid)


def box_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, batched: [..., M, 4] x [..., N, 4] -> [..., M, N]."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def _greedy_suppress(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Keep mask [B, K] for score-sorted boxes [B, K, 4]."""
    k = boxes.shape[1]
    lower = torch.ones((k, k), dtype=torch.bool, device=boxes.device).tril(-1)
    suppressing = (box_iou_xyxy(boxes, boxes) > iou_threshold) & lower  # [B, i, j]

    def sweep(keep):
        return valid & ~(suppressing & keep[:, None, :]).any(dim=2)

    keep, prev = sweep(valid), valid
    for _ in range(k):
        if torch.equal(keep, prev):
            break
        keep, prev = sweep(keep), keep
    return keep


def batched_nms(
    boxes_xyxy: torch.Tensor,  # [B, A, 4]
    scores: torch.Tensor,  # [B, A] or [B, A, 1]
    flame_params: torch.Tensor,  # [B, A, P] (P may be 0)
    confidence_threshold: float = 0.5,
    iou_threshold: float = 0.5,
    pre_nms_max: int = 1000,
    post_nms_max: int = 100,
    fuse_flame: bool = False,
    fusion_iou: float = 0.7,
    return_neighbors: int = 0,
):
    """All outputs ``[B, min(post_nms_max, k), ...]`` plus a valid mask.

    ``fuse_flame`` replaces each kept row of ``flame_params`` by the
    weighted mean of its candidates' rows.  ``return_neighbors=n`` returns
    ``(NMSResult, NeighborInfo)`` with ``min(n, k)`` candidates per kept box;
    the truncation is exact when a cluster has at most n candidates."""
    if scores.dim() == 3:
        scores = scores[..., 0]
    num_anchors = scores.shape[1]
    k = min(pre_nms_max, num_anchors)

    masked = torch.where(scores >= confidence_threshold, scores, -1.0)
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes_xyxy, 1, top_idx[..., None].expand(-1, -1, 4))
    top_valid = top_scores >= confidence_threshold

    keep = _greedy_suppress(top_boxes, top_valid, iou_threshold)

    # the first post_nms_max kept boxes, in score order
    order = torch.arange(k, device=scores.device)
    key = torch.where(keep, order, k + order)
    sel = torch.argsort(key, dim=1)[:, :post_nms_max]
    out_valid = torch.gather(keep, 1, sel)
    final_idx = torch.gather(top_idx, 1, sel)

    p = flame_params.shape[-1]
    sel_boxes = torch.gather(top_boxes, 1, sel[..., None].expand(-1, -1, 4))
    w = None
    if fuse_flame or return_neighbors:
        iou_ck = box_iou_xyxy(sel_boxes, top_boxes)  # [B, K_kept, k]
        iou_ck = torch.where(out_valid[..., None], iou_ck, -1.0)
        # a candidate joins only its best-IoU kept box (first on a tie) ...
        best_kept = torch.argmax(iou_ck, dim=1)  # [B, k]
        slots = torch.arange(sel.shape[1], device=sel.device)
        assign = best_kept[:, None, :] == slots[None, :, None]
        # ... and only down the score order, so a kept box is its own
        # top-weight candidate (n = 1 is plain NMS)
        downrank = order[None, None, :] >= sel[..., None]
        member = (iou_ck >= fusion_iou) & assign & downrank & top_valid[:, None, :]
        w = torch.where(member, top_scores[:, None, :], 0.0).to(torch.float32)
    if fuse_flame:
        cand = torch.gather(flame_params, 1, top_idx[..., None].expand(-1, -1, p))
        with exact_float32():
            fused = torch.matmul(w, cand.to(torch.float32))
        fused = fused / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-12)
        selected_flame = fused.to(flame_params.dtype)
    else:
        selected_flame = torch.gather(flame_params, 1, final_idx[..., None].expand(-1, -1, p))
    result = NMSResult(
        boxes=torch.where(out_valid[..., None], sel_boxes, 0.0),
        scores=torch.where(out_valid, torch.gather(top_scores, 1, sel), 0.0),
        flame_params=torch.where(out_valid[..., None], selected_flame, 0.0),
        valid=out_valid,
        anchor_idx=torch.where(out_valid, final_idx, 0),
    )
    if not return_neighbors:
        return result
    n = min(int(return_neighbors), k)
    wn, jn = torch.sort(w, dim=2, descending=True, stable=True)
    wn, jn = wn[..., :n], jn[..., :n]
    nb_anchor = torch.gather(top_idx[:, None, :].expand(-1, jn.shape[1], -1), 2, jn)
    return result, NeighborInfo(anchor_idx=torch.where(wn > 0, nb_anchor, 0), weights=wn)


def single_image_nms(
    boxes_xyxy: torch.Tensor,  # [A, 4]
    scores: torch.Tensor,  # [A] or [A, 1]
    flame_params: torch.Tensor,  # [A, P]
    confidence_threshold: float = 0.5,
    iou_threshold: float = 0.5,
    pre_nms_max: int = 1000,
    post_nms_max: int = 100,
    fuse_flame: bool = False,
    fusion_iou: float = 0.7,
    return_neighbors: int = 0,
):
    """One image: :func:`batched_nms` on a batch of one, batch axis removed."""
    out = batched_nms(
        boxes_xyxy[None], scores.reshape(1, -1), flame_params[None],
        confidence_threshold=confidence_threshold, iou_threshold=iou_threshold,
        pre_nms_max=pre_nms_max, post_nms_max=post_nms_max, fuse_flame=fuse_flame,
        fusion_iou=fusion_iou, return_neighbors=return_neighbors,
    )
    if return_neighbors:
        res, nb = out
        return NMSResult(*(t[0] for t in res)), NeighborInfo(*(t[0] for t in nb))
    return NMSResult(*(t[0] for t in out))


def compact_detections(res: NMSResult, max_total: int) -> CompactDetections:
    """Pack a batch's detections into ``max_total`` flat slots ordered
    (valid desc, score desc); ties keep the lower (image, slot) first."""
    b, k = res.scores.shape
    key = torch.where(res.valid.reshape(-1), res.scores.reshape(-1), -1.0)
    m = min(max_total, b * k)
    flat_idx = torch.sort(key, descending=True, stable=True)[1][:m]
    valid = res.valid.reshape(-1)[flat_idx]

    def pick(x):
        return x.reshape((b * k,) + tuple(x.shape[2:]))[flat_idx]

    zero = torch.zeros_like(flat_idx)
    return CompactDetections(
        boxes=pick(res.boxes),
        scores=pick(res.scores),
        flame_params=pick(res.flame_params),
        valid=valid,
        anchor_idx=pick(res.anchor_idx),
        batch_idx=torch.where(valid, flat_idx // k, zero),
        slot_idx=torch.where(valid, flat_idx % k, zero),
    )
