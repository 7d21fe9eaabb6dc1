"""Post-prediction decode for validation: NMS + FLAME reprojection.

Counterpart of ``head_detector_tpu/post_prediction.py``: per image,
confidence filter -> top-k pre-NMS -> NMS -> keep post-NMS -> FLAME
reproject to 2D/3D vertices, then per-image ``YoloHeadsPredictions``.  The
batch is decoded on the device the predictions are on (the port's
``ops/nms.py``, float32 FLAME with TF32 off) and downloaded once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from head_detector_tpu_torch.device import exact_float32
from head_detector_tpu_torch.flame import FlameModel, reproject_spatial_vertices
from head_detector_tpu_torch.models.heads import DecodedPredictions
from head_detector_tpu_torch.ops.nms import batched_nms


@dataclasses.dataclass
class YoloHeadsPredictions:
    """Per-image predictions (host numpy)."""

    scores: np.ndarray  # [N]
    bboxes_xyxy: np.ndarray  # [N, 4]
    mm_params: np.ndarray  # [N, 413]
    predicted_3d_vertices: np.ndarray  # [N, V, 3]
    predicted_2d_vertices: np.ndarray  # [N, V, 2]


class YoloHeadsPostPredictionCallback:
    def __init__(
        self,
        flame_model: Optional[FlameModel] = None,
        confidence_threshold: float = 0.5,
        nms_iou_threshold: float = 0.7,
        pre_nms_max_predictions: int = 300,
        post_nms_max_predictions: int = 30,
        param_fusion: bool = False,
        fusion_iou: float = 0.7,
        device="cuda",
    ):
        """``flame_model`` decides the device of the decode; without one a
        model is made on ``device``."""
        self.flame_model = flame_model or FlameModel.from_assets(device=device)
        self.confidence_threshold = confidence_threshold
        self.nms_iou_threshold = nms_iou_threshold
        self.pre_nms_max_predictions = pre_nms_max_predictions
        self.post_nms_max_predictions = post_nms_max_predictions
        self.param_fusion = param_fusion
        self.fusion_iou = fusion_iou

    @torch.no_grad()
    def _decode(self, boxes, scores, flame_params):
        dev = self.flame_model.device
        with exact_float32():
            res = batched_nms(
                boxes.to(dev), scores.to(dev), flame_params.to(dev),
                confidence_threshold=self.confidence_threshold,
                iou_threshold=self.nms_iou_threshold,
                pre_nms_max=self.pre_nms_max_predictions,
                post_nms_max=self.post_nms_max_predictions,
                fuse_flame=self.param_fusion,
                fusion_iou=self.fusion_iou,
            )
            b, k, p = res.flame_params.shape
            verts3d, _, proj = reproject_spatial_vertices(
                self.flame_model, res.flame_params.reshape(b * k, p), to_2d=False)
        v = verts3d.shape[-2]
        return (res.boxes, res.scores, res.flame_params, verts3d.reshape(b, k, v, 3),
                proj[..., :2].reshape(b, k, v, 2), res.valid)

    def __call__(self, decoded: DecodedPredictions) -> List[YoloHeadsPredictions]:
        boxes, scores, params, verts3d, verts2d, valid = (
            x.cpu().numpy() for x in self._decode(
                decoded.boxes_xyxy, decoded.scores, decoded.flame_params))
        out: List[YoloHeadsPredictions] = []
        for i in range(boxes.shape[0]):
            keep = valid[i]
            out.append(YoloHeadsPredictions(
                scores=scores[i][keep],
                bboxes_xyxy=boxes[i][keep],
                mm_params=params[i][keep],
                predicted_3d_vertices=verts3d[i][keep],
                predicted_2d_vertices=verts2d[i][keep],
            ))
        return out
