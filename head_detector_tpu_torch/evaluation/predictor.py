"""The shared evaluation predictor idiom.

Counterpart of ``head_detector_tpu/evaluation/predictor.py``.  Every
reference eval script inlines the same flow: resize the longest side to the
image size (``INTER_LINEAR``) -> pad bottom/right with 127 -> forward ->
post-prediction callback (conf/iou thresholds) -> divide coordinates and
``flame.scale`` by the resize scale.  This is the training-checkpoint path:
the training-layout model (QARepVGG branches unfused, the FLAME towers dense
on every anchor) in eval mode, distinct from ``HeadDetector``'s deploy model.
The forward and the callback's decode run on ``device`` (float32 with TF32
off, or the bfloat16 compute dtype); one image a call.
"""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np
import torch

from head_detector_tpu_torch.device import exact_float32, resolve_device
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models import build_model, init_model
from head_detector_tpu_torch.post_prediction import (
    YoloHeadsPostPredictionCallback,
    YoloHeadsPredictions,
)
from head_detector_tpu_torch.weights import (
    count_leaves,
    flax_from_state_dict,
    load_variables,
    train_state_dict_from_flax,
)


class EvalPredictor:
    """``variables`` (a flax ``{params, batch_stats}`` tree in the training
    layout), else ``checkpoint`` (``weights.load_variables``), else random
    initialisation (``init_model``, seed 0, BatchNorm calibrated at the image
    size).  ``callback`` may be swapped between protocols: the forward does
    not depend on it."""

    def __init__(
        self,
        model_name: str = "yolo_heads_l",
        variables: Optional[dict] = None,
        checkpoint: Optional[str] = None,
        image_size: int = 640,
        confidence_threshold: float = 0.5,
        nms_iou_threshold: float = 0.7,
        pre_nms_max_predictions: int = 300,
        post_nms_max_predictions: int = 30,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.model = build_model(model_name, dtype=dtype, deploy=False).to(self.device)
        if variables is None and checkpoint:
            variables = load_variables(checkpoint)
        if variables is None:
            init_model(self.model, torch.Generator().manual_seed(0), (image_size, image_size))
            variables = flax_from_state_dict(self.model.state_dict())
        state, used = train_state_dict_from_flax(variables)
        total = count_leaves(variables)
        if used != total:
            raise ValueError(f"{checkpoint or 'variables'}: restored {used}/{total} leaves")
        self.model.load_state_dict(state, strict=True)
        self.model.eval()
        self.variables = variables
        self.flame = FlameModel.from_assets(device=self.device)
        self.callback = YoloHeadsPostPredictionCallback(
            flame_model=self.flame,
            confidence_threshold=confidence_threshold,
            nms_iou_threshold=nms_iou_threshold,
            pre_nms_max_predictions=pre_nms_max_predictions,
            post_nms_max_predictions=post_nms_max_predictions,
        )

    def preprocess(self, image: np.ndarray):
        """Longest side to the image size + bottom/right pad 127."""
        h, w = image.shape[:2]
        scale = min(self.image_size / h, self.image_size / w)
        new_h, new_w = int(h * scale + 0.5), int(w * scale + 0.5)
        resized = cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        padded = cv2.copyMakeBorder(
            resized, 0, self.image_size - new_h, 0, self.image_size - new_w,
            cv2.BORDER_CONSTANT, value=(127, 127, 127),
        )
        return padded, scale

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> YoloHeadsPredictions:
        """RGB uint8 image -> predictions in ORIGINAL image coordinates."""
        padded, scale = self.preprocess(image)
        x = torch.from_numpy(padded).to(self.device)
        x = (x.to(torch.float32) / 255.0).permute(2, 0, 1)[None].contiguous()
        with exact_float32():
            decoded, _ = self.model(x)
        pred = self.callback(decoded)[0]

        # back to original coordinates: boxes and 2D vertices divide by the
        # scale, and so do the FLAME translation and scale; the canonical 3D
        # vertices are scale-free
        pred.bboxes_xyxy = pred.bboxes_xyxy / scale
        pred.predicted_2d_vertices = pred.predicted_2d_vertices / scale
        mm = pred.mm_params.copy()
        mm[:, 409:412] /= scale  # translation
        mm[:, 412] /= scale  # scale
        pred.mm_params = mm
        return pred
