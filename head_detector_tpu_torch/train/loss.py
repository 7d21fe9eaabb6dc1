"""YoloHeadsLoss: cls + IoU + DFL + OKS keypoints + 3D vertices + rotation.

Counterpart of ``head_detector_tpu/train/loss.py``, with its shape
discipline: GT arrives padded per image (``Targets``) with a validity mask;
box and DFL losses are computed for every anchor and weighted by the
assigned-score mask, so a batch without positives runs the same code; the
FLAME decode runs on a fixed top-``max_positives`` subset of the foreground
anchors (overflow is dropped and reported as ``num_pos_dropped``).  The
scores, the DFL and every loss term are float32 whatever the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from head_detector_tpu_torch.flame import FlameModel, reproject_spatial_vertices
from head_detector_tpu_torch.models.heads import RawOutputs
from head_detector_tpu_torch.train.assigner import task_aligned_assigner
from head_detector_tpu_torch.train.boxes import (
    batch_distance2bbox,
    bbox2distance,
    ciou_loss,
    giou_loss,
    stable_topk_indices,
)
from head_detector_tpu_torch.train.losses import (
    bce_with_logits,
    df_loss,
    focal_loss,
    oks_keypoint_loss,
    rotation_loss,
    vertices_3d_loss,
)


class Targets(NamedTuple):
    """Padded per-image ground truth.

    :param gt_bboxes:      [B, N, 4] xyxy pixels (zero rows where padded)
    :param gt_vertices_2d: [B, N, K, 3] (x, y, visibility) projected vertices
    :param gt_vertices_3d: [B, N, V, 3] canonical (zero-rotation) vertices
    :param gt_rotations:   [B, N, 3, 3]
    :param pad_gt_mask:    [B, N, 1] 1 = real box
    """

    gt_bboxes: torch.Tensor
    gt_vertices_2d: torch.Tensor
    gt_vertices_3d: torch.Tensor
    gt_rotations: torch.Tensor
    pad_gt_mask: torch.Tensor

    def to(self, device) -> "Targets":
        """Every field as a float32 tensor on ``device`` (from numpy or torch)."""
        return Targets(*(torch.as_tensor(x).to(device=device, dtype=torch.float32)
                         for x in self))


@dataclasses.dataclass(frozen=True)
class LossConfig:
    oks_sigma: float = 0.025
    indexes_subset: Optional[np.ndarray] = None  # static vertex subset
    classification_loss_type: str = "focal"
    regression_iou_loss_type: str = "ciou"
    vertices_loss: str = "smooth_l1"
    rotation_loss: str = "geodesic"
    classification_loss_weight: float = 1.0
    iou_loss_weight: float = 2.0
    dfl_loss_weight: float = 0.01
    pose_reg_loss_weight: float = 5.0
    bbox_assigner_topk: int = 13
    bbox_assigner_alpha: float = 1.0
    bbox_assigner_beta: float = 6.0
    rescale_pose_loss_with_assigned_score: bool = False
    average_losses_in_ddp: bool = False
    vertices_3d_loss_weight: float = 50.0
    rotation_loss_weight: float = 1.0
    max_positives: int = 256


COMPONENT_NAMES = (
    "loss_3d_rotation",
    "loss_cls",
    "loss_iou",
    "loss_dfl",
    "loss_pose_reg",
    "loss_3d_vertices",
    "loss",
)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over elements where mask (broadcastable) is 1."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def yolo_heads_loss(flame_model: FlameModel, raw: RawOutputs, targets: Targets,
                    cfg: LossConfig = LossConfig()):
    """:return: (total loss scalar, dict of the ``COMPONENT_NAMES`` plus
    ``num_pos`` and ``num_pos_dropped``)."""
    pred_logits = raw.cls_score_list.to(torch.float32)  # [B, L, 1]
    pred_distri = raw.reg_distri_list.to(torch.float32)  # [B, L, 4*(m+1)]
    stride = raw.stride_tensor  # [L, 1]
    anchor_points = raw.anchor_points  # [L, 2] pixels
    anchor_points_s = anchor_points / stride
    b, l, _ = pred_distri.shape
    reg_max = pred_distri.shape[-1] // 4 - 1
    dev = pred_distri.device

    # bbox decode in grid units
    dist = torch.softmax(pred_distri.reshape(b, l, 4, reg_max + 1), dim=-1)
    proj = torch.arange(reg_max + 1, dtype=torch.float32, device=dev)
    expected = (dist * proj).sum(-1)
    pred_bboxes = batch_distance2bbox(anchor_points_s[None], expected)

    assign = task_aligned_assigner(
        pred_scores=torch.sigmoid(pred_logits.detach()),
        pred_bboxes=pred_bboxes.detach() * stride[None],
        anchor_points=anchor_points,
        gt_bboxes=targets.gt_bboxes,
        pad_gt_mask=targets.pad_gt_mask,
        topk=cfg.bbox_assigner_topk,
        alpha=cfg.bbox_assigner_alpha,
        beta=cfg.bbox_assigner_beta,
    )
    assigned_scores = assign.assigned_scores  # [B, L, 1]
    fg = assign.fg_mask  # [B, L]

    # ---------------- classification ---------------- #
    if cfg.classification_loss_type == "focal":
        loss_cls = focal_loss(pred_logits, assigned_scores, alpha=-1.0).sum()
    elif cfg.classification_loss_type == "bce":
        loss_cls = bce_with_logits(pred_logits, assigned_scores).sum()
    else:
        raise ValueError(cfg.classification_loss_type)
    assigned_scores_sum = torch.clamp(assigned_scores.sum(), min=1.0)
    loss_cls = loss_cls / assigned_scores_sum

    # ---------------- box / dfl -------------------- #
    bbox_weight = assigned_scores[..., 0] * fg  # [B, L]
    assigned_s = assign.assigned_bboxes / stride[None]  # grid units
    iou_fn = {"giou": giou_loss, "ciou": ciou_loss}[cfg.regression_iou_loss_type]
    iou_elem = torch.where(fg, iou_fn(pred_bboxes, assigned_s), 0.0)
    loss_iou = (iou_elem * bbox_weight).sum() / assigned_scores_sum

    assigned_ltrb = bbox2distance(anchor_points_s[None], assigned_s, reg_max)
    dfl_elem = df_loss(pred_distri.reshape(b, l, 4, reg_max + 1), assigned_ltrb)[..., 0]
    dfl_elem = torch.where(fg, dfl_elem, 0.0)
    loss_dfl = (dfl_elem * bbox_weight).sum() / assigned_scores_sum

    # ------------- FLAME losses on fixed-size positive subset ------------- #
    flat_fg = fg.reshape(-1).to(torch.float32)
    sel = stable_topk_indices(flat_fg, min(cfg.max_positives, b * l))  # all ties: 0/1
    sel_valid = flat_fg[sel] > 0  # [P]
    img_idx = torch.div(sel, l, rounding_mode="floor")

    flame_sel = raw.flame_params.reshape(b * l, -1)[sel]  # [P, 413]
    gt_idx = assign.assigned_gt_index.reshape(-1)[sel]  # [P]
    boxes_img = assign.assigned_bboxes.reshape(-1, 4)[sel]  # [P, 4] pixels
    weight_sel = bbox_weight.reshape(-1)[sel]  # [P]

    gt_v3d = targets.gt_vertices_3d[img_idx, gt_idx]  # [P, V, 3]
    gt_v2d = targets.gt_vertices_2d[img_idx, gt_idx][..., :2]  # [P, K, 2]
    gt_rot = targets.gt_rotations[img_idx, gt_idx]  # [P, 3, 3]

    # Sanitise padding rows BEFORE any math: masking the loss afterwards does
    # not stop NaN/inf gradients of garbage rows (0 * inf = NaN).  Padding
    # rows get neutral FLAME params (identity 6DoF basis at [403:409], unit
    # scale) and identity GT rotations.
    neutral = torch.zeros(flame_sel.shape[-1], dtype=flame_sel.dtype, device=dev)
    neutral[[403, 407, 412]] = 1.0
    vmask = sel_valid[:, None]
    flame_sel = torch.where(vmask, flame_sel, neutral[None])
    boxes_img = torch.where(
        vmask, boxes_img, torch.tensor([0.0, 0.0, 8.0, 8.0], device=dev))
    gt_rot = torch.where(vmask[:, :, None], gt_rot,
                         torch.eye(3, dtype=gt_rot.dtype, device=dev))
    gt_v2d = torch.where(vmask[:, :, None], gt_v2d, 0.0)
    gt_v3d = torch.where(vmask[:, :, None], gt_v3d, 0.0)

    pred_v3d, pred_rot, pred_2d = reproject_spatial_vertices(flame_model, flame_sel,
                                                             to_2d=True)
    if cfg.indexes_subset is not None:
        subset = torch.as_tensor(np.asarray(cfg.indexes_subset), dtype=torch.int64,
                                 device=dev)
        pred_2d, gt_v2d = pred_2d[:, subset], gt_v2d[:, subset]
        pred_v3d, gt_v3d = pred_v3d[:, subset], gt_v3d[:, subset]

    area = torch.clamp(
        (boxes_img[:, 2] - boxes_img[:, 0]) * (boxes_img[:, 3] - boxes_img[:, 1]), min=0.0
    ) * 0.53

    kp_elem = oks_keypoint_loss(pred_2d, gt_v2d, area[:, None], cfg.oks_sigma)  # [P]
    v3d_elem = vertices_3d_loss(pred_v3d, gt_v3d, cfg.vertices_loss)  # [P, V, 3]
    rot_elem = rotation_loss(pred_rot, gt_rot, cfg.rotation_loss)  # [P]

    if cfg.rescale_pose_loss_with_assigned_score:
        w = weight_sel * sel_valid
        loss_pose = (kp_elem * w).sum() / assigned_scores_sum
        loss_v3d = (v3d_elem.mean((-2, -1)) * w).sum() / assigned_scores_sum
        loss_rot = (rot_elem * w).sum() / assigned_scores_sum
    else:
        loss_pose = _masked_mean(kp_elem, sel_valid)
        loss_v3d = _masked_mean(v3d_elem, sel_valid[:, None, None])
        loss_rot = _masked_mean(rot_elem, sel_valid)

    loss_cls = loss_cls * cfg.classification_loss_weight
    loss_iou = loss_iou * cfg.iou_loss_weight
    loss_dfl = loss_dfl * cfg.dfl_loss_weight
    loss_pose = loss_pose * cfg.pose_reg_loss_weight
    loss_v3d = loss_v3d * cfg.vertices_3d_loss_weight
    loss_rot = loss_rot * cfg.rotation_loss_weight
    total = loss_cls + loss_iou + loss_dfl + loss_pose + loss_v3d + loss_rot

    num_pos = fg.sum()
    components = {
        "loss_3d_rotation": loss_rot,
        "loss_cls": loss_cls,
        "loss_iou": loss_iou,
        "loss_dfl": loss_dfl,
        "loss_pose_reg": loss_pose,
        "loss_3d_vertices": loss_v3d,
        "loss": total,
        "num_pos": num_pos,
        "num_pos_dropped": torch.clamp(num_pos - sel_valid.sum(), min=0),
    }
    return total, components
