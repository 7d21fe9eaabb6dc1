"""Detection + FLAME regression heads with the DFL decode, in torch.

Counterpart of ``head_detector_tpu/models/heads.py``.  Per-anchor tensors are
``[B, A, C]`` (anchors of all scales concatenated, row-major per scale), the
layout the JAX package uses.  The FLAME globalisation indexes the packed
413-vector directly: translation is ``[409:412]`` and scale ``[412]`` in both
wire conventions.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.head_info import FLAME_CONSTS
from benchmark.reference.models.blocks import (
    BlockCfg,
    Conv2d,
    ConvBNAct,
    QARepVGGBlock,
    width_multiplier,
)
from benchmark.reference.models.presets import ArchCfg, HeadCfg

_TRANSLATION_START = 409
_SCALE_INDEX = 412

TOWERS = (
    "flame_shape_pred",
    "flame_expression_pred",
    "flame_rotation_pred",
    "flame_jaw_pred",
    "flame_translation_pred",
    "flame_scale_pred",
)


class DecodedPredictions(NamedTuple):
    boxes_xyxy: torch.Tensor  # [B, A, 4]
    scores: torch.Tensor  # [B, A, 1]
    flame_params: torch.Tensor  # [B, A, 413] (or [B, A, 0] with skip_flame)


class RawOutputs(NamedTuple):
    cls_score_list: torch.Tensor  # [B, A, 1] logits
    reg_distri_list: torch.Tensor  # [B, A, 4*(reg_max+1)]
    flame_params: torch.Tensor  # [B, A, 413]
    anchors: torch.Tensor  # [A, 4] grid-cell boxes in pixels
    anchor_points: torch.Tensor  # [A, 2] cell centers in pixels
    num_anchors_list: Tuple[int, ...]
    stride_tensor: torch.Tensor  # [A, 1]


def flame_vector(outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The six tower outputs (channels on dim 1, in ``TOWERS`` order) ->
    the packed 413-vector on dim 1, through the activation zoo: shape and
    expression ``tanh*3`` (zero-padded to 300/100), scale ``exp`` of the
    output clipped to +-15, over 0.05, the rest linear."""
    shape, expression, rotation, jaw, translation, scale = outputs

    def pad(t, width):
        pads = [0, 0] * (t.dim() - 2) + [0, width - t.shape[1]]
        return F.pad(t, pads)

    shape = pad(torch.tanh(shape) * 3, FLAME_CONSTS["shape"])
    expression = pad(torch.tanh(expression) * 3, FLAME_CONSTS["expression"])
    scale = torch.exp(torch.clamp(scale, -15.0, 15.0)) / 0.05
    return torch.cat([shape, expression, rotation, jaw, translation, scale], dim=1)


class FlameRegressionTower(nn.Module):
    """N QARepVGG blocks (no residual, learnable alpha) + 1x1 conv."""

    def __init__(self, in_channels: int, inter_channels: int, out_channels: int,
                 num_blocks: int, cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.num_blocks = num_blocks
        ch = in_channels
        for i in range(num_blocks):
            self.add_module(f"block{i}", QARepVGGBlock(
                ch, inter_channels, use_residual_connection=False, use_alpha=True, cfg=cfg))
            ch = inter_channels
        self.pred = Conv2d(ch, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return self.pred(x)


class YoloHeadsDFLHead(nn.Module):
    """Single-scale head: [B, C, H, W] -> (reg, cls, flame) NCHW maps.

    The FLAME towers are always built (they hold checkpoint weights); with
    ``skip_flame`` the forward leaves them out and emits a zero-width flame
    map, and ``ops/sparse_towers.py`` runs them at the kept anchors only.

    ``head.shared_stem``: one ConvBNAct ``stem`` to the wider of the two
    stem widths, then a bias-free 1x1 ``pose_stem`` / ``bbox_stem`` to the
    narrower one where they differ.  ``head.first_conv_group_size``: a
    grouped 3x3 ConvBNAct (``cls_conv_grouped`` / ``reg_conv_grouped``) before
    ``cls_conv`` / ``reg_conv``, ``bbox_ch // size`` groups (-1: one group;
    0: none)."""

    def __init__(self, in_channels: int, head: HeadCfg, skip_flame: bool = False,
                 cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.skip_flame = skip_flame
        self.num_blocks = head.flame_regression_blocks
        bbox_ch = width_multiplier(head.bbox_inter_channels, head.width_mult, 8)
        flame_ch = width_multiplier(head.flame_inter_channels, head.width_mult, 8)
        self.shared_stem = head.shared_stem
        if head.shared_stem:
            wide = max(bbox_ch, flame_ch)
            self.stem = ConvBNAct(in_channels, wide, cfg=cfg)
            self.pose_stem = Conv2d(wide, flame_ch, 1, bias=False) if wide != flame_ch else None
            self.bbox_stem = Conv2d(wide, bbox_ch, 1, bias=False) if wide != bbox_ch else None
        else:
            self.pose_stem = ConvBNAct(in_channels, flame_ch, cfg=cfg)
            self.bbox_stem = ConvBNAct(in_channels, bbox_ch, cfg=cfg)
        size = head.first_conv_group_size
        self.groups = 0 if size == 0 else 1 if size == -1 else bbox_ch // size
        if self.groups:
            self.cls_conv_grouped = ConvBNAct(bbox_ch, bbox_ch, 3, cfg=cfg, groups=self.groups)
            self.reg_conv_grouped = ConvBNAct(bbox_ch, bbox_ch, 3, cfg=cfg, groups=self.groups)
        self.cls_conv = ConvBNAct(bbox_ch, bbox_ch, 3, cfg=cfg)
        self.reg_conv = ConvBNAct(bbox_ch, bbox_ch, 3, cfg=cfg)
        self.cls_pred = Conv2d(bbox_ch, 1, 1, bias=True)
        self.reg_pred = Conv2d(bbox_ch, 4 * (head.reg_max + 1), 1, bias=True)
        transf = head.flame_transformation_inter_channels
        specs = (
            (head.flame_shape_inter_channels, head.flame_shape_out_channels),
            (head.flame_expression_inter_channels, head.flame_expression_out_channels),
            (transf, FLAME_CONSTS["rotation"]),
            (transf, FLAME_CONSTS["jaw"]),
            (transf, FLAME_CONSTS["translation"]),
            (transf, FLAME_CONSTS["scale"]),
        )
        for name, (inter, out) in zip(TOWERS, specs):
            self.add_module(
                name, FlameRegressionTower(flame_ch, inter, out, self.num_blocks, cfg=cfg)
            )

    def forward(self, x: torch.Tensor):
        if self.shared_stem:
            stem = self.stem(x)
            bbox_feat = stem if self.bbox_stem is None else self.bbox_stem(stem)
        else:
            bbox_feat = self.bbox_stem(x)
        cls_feat = reg_feat = bbox_feat
        if self.groups:
            cls_feat = self.cls_conv_grouped(cls_feat)
            reg_feat = self.reg_conv_grouped(reg_feat)
        cls_out = self.cls_pred(self.cls_conv(cls_feat))
        reg_out = self.reg_pred(self.reg_conv(reg_feat))
        if self.skip_flame:
            b, _, h, w = x.shape
            return reg_out, cls_out, reg_out.new_zeros((b, 0, h, w))
        if self.shared_stem:
            pose_feat = stem if self.pose_stem is None else self.pose_stem(stem)
        else:
            pose_feat = self.pose_stem(x)
        flame = flame_vector([getattr(self, name)(pose_feat) for name in TOWERS])
        return reg_out, cls_out, flame


def make_anchors(
    feat_shapes: Tuple[Tuple[int, int], ...],
    strides: Tuple[int, ...],
    grid_cell_scale: float = 5.0,
    grid_cell_offset: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...], np.ndarray]:
    """Anchor grids (numpy): anchors [A,4] pixel boxes of size
    ``grid_cell_scale*stride``, anchor_points [A,2] cell centers in grid
    units (+offset), num_anchors_list, stride_tensor [A,1]."""
    anchors, points, strides_out, counts = [], [], [], []
    for (h, w), stride in zip(feat_shapes, strides):
        sx = np.arange(w, dtype=np.float32) + grid_cell_offset
        sy = np.arange(h, dtype=np.float32) + grid_cell_offset
        gy, gx = np.meshgrid(sy, sx, indexing="ij")
        pts = np.stack([gx, gy], axis=-1).reshape(-1, 2)
        points.append(pts)
        half = grid_cell_scale * stride * 0.5
        center_px = pts * stride
        anchors.append(np.concatenate([center_px - half, center_px + half], axis=-1))
        strides_out.append(np.full((h * w, 1), stride, dtype=np.float32))
        counts.append(h * w)
    return (
        np.concatenate(anchors, 0),
        np.concatenate(points, 0),
        tuple(counts),
        np.concatenate(strides_out, 0),
    )


def globalize_flame(
    flame_rows: torch.Tensor,  # [..., K, 413] anchor-local params
    anchor_idx: torch.Tensor,  # [..., K] indices into the anchor axis
    anchor_points_px: torch.Tensor,  # [A, 2] cell centers in pixels
    stride_tensor: torch.Tensor,  # [A, 1]
) -> torch.Tensor:
    """translation.xy += anchor center (pixels); scale *= stride."""
    idx = anchor_idx.long()
    out = flame_rows.clone()
    out[..., _TRANSLATION_START : _TRANSLATION_START + 2] += anchor_points_px[idx].to(
        out.dtype
    )
    out[..., _SCALE_INDEX] *= stride_tensor[..., 0][idx].to(out.dtype)
    return out


class YoloHeadsNDFLHeads(nn.Module):
    """Three scale heads + DFL decode.  ``defer_globalization`` leaves the
    FLAME rows anchor-local; callers select rows (NMS) and then call
    :func:`globalize_flame`."""

    def __init__(self, arch: ArchCfg, in_channels: Sequence[int],
                 defer_globalization: bool = False, skip_flame: bool = False,
                 cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.arch = arch
        self.defer_globalization = defer_globalization
        self._constants_cache = {}
        for i, (ch, hcfg) in enumerate(zip(in_channels, arch.heads)):
            self.add_module(
                f"head{i + 1}",
                YoloHeadsDFLHead(ch, hcfg, skip_flame=skip_flame, cfg=cfg),
            )

    def _constants(self, feat_shapes: Tuple[Tuple[int, int], ...], device: torch.device):
        """(anchors [A,4], anchor_points [A,2] in grid units, num_anchors_list,
        stride_tensor [A,1], DFL bins [reg_max+1]) for these feature shapes on
        ``device``, made once.  A trace of a model that has run at its size
        holds them as plain constants, which ``torch.jit.load(map_location=
        ...)`` moves; tensors made in the traced forward would be pinned to
        the device it was traced on."""
        key = (feat_shapes, str(device))
        if key not in self._constants_cache:
            arch = self.arch
            anchors, points, counts, strides = make_anchors(
                feat_shapes, tuple(h.stride for h in arch.heads), arch.grid_cell_scale,
                arch.grid_cell_offset)
            bins = np.arange(arch.reg_max + 1, dtype=np.float32)
            self._constants_cache[key] = (
                torch.as_tensor(anchors, device=device), torch.as_tensor(points, device=device),
                counts, torch.as_tensor(strides, device=device),
                torch.as_tensor(bins, device=device))
        return self._constants_cache[key]

    def forward(self, feats: Sequence[torch.Tensor]):
        arch = self.arch
        reg_max = arch.reg_max
        b = feats[0].shape[0]
        cls_list: List[torch.Tensor] = []
        reg_list: List[torch.Tensor] = []
        flame_list: List[torch.Tensor] = []
        feat_shapes = []
        for i, feat in enumerate(feats):
            _, _, h, w = feat.shape
            feat_shapes.append((int(h), int(w)))  # sizes are tensors in a trace
            reg_out, cls_out, flame_out = getattr(self, f"head{i + 1}")(feat)

            def rows(t):
                return t.permute(0, 2, 3, 1).reshape(b, h * w, t.shape[1])

            reg_list.append(rows(reg_out))
            cls_list.append(rows(cls_out))
            flame_list.append(rows(flame_out))

        cls_scores = torch.cat(cls_list, dim=1)  # [B, A, 1]
        reg_distri = torch.cat(reg_list, dim=1)  # [B, A, 4*(m+1)]
        flame = torch.cat(flame_list, dim=1)  # [B, A, 413 or 0]

        anchors, anchor_points, counts, stride_tensor, proj = self._constants(
            tuple(feat_shapes), feats[0].device)
        a = reg_distri.shape[1]
        dist = reg_distri.reshape(b, a, 4, reg_max + 1).float()
        expected = torch.einsum("bakm,m->bak", torch.softmax(dist, dim=-1), proj)

        x1y1 = anchor_points[None] - expected[..., :2]
        x2y2 = anchor_points[None] + expected[..., 2:]
        pred_bboxes = torch.cat([x1y1, x2y2], dim=-1) * stride_tensor[None]
        pred_scores = torch.sigmoid(cls_scores.float())

        points_px = anchor_points * stride_tensor
        if not self.defer_globalization and flame.shape[-1]:
            # out of place, so that a trace holds no in-place op (onnx_export)
            t = _TRANSLATION_START
            flame = flame.float()
            flame = torch.cat([flame[..., :t], flame[..., t : t + 2] + points_px,
                               flame[..., t + 2 : _SCALE_INDEX],
                               flame[..., _SCALE_INDEX:] * stride_tensor], dim=-1)

        decoded = DecodedPredictions(
            boxes_xyxy=pred_bboxes, scores=pred_scores, flame_params=flame
        )
        raw = RawOutputs(
            cls_score_list=cls_scores.float(),
            reg_distri_list=reg_distri.float(),
            flame_params=flame,
            anchors=anchors,
            anchor_points=points_px,
            num_anchors_list=counts,
            stride_tensor=stride_tensor,
        )
        return decoded, raw
