"""Model zoo: YoloHeads N/S/M/L in torch (deploy and training layouts)."""

from head_detector_tpu_torch.models.heads import (
    DecodedPredictions,
    RawOutputs,
    globalize_flame,
    make_anchors,
)
from head_detector_tpu_torch.models.presets import PRESETS, ArchCfg, get_arch
from head_detector_tpu_torch.models.yolo_heads import (
    YoloHeads,
    build_model,
    calibrate_batch_stats,
    init_model,
    param_count,
)

__all__ = [
    "ArchCfg",
    "PRESETS",
    "get_arch",
    "YoloHeads",
    "build_model",
    "calibrate_batch_stats",
    "init_model",
    "param_count",
    "DecodedPredictions",
    "RawOutputs",
    "globalize_flame",
    "make_anchors",
]
