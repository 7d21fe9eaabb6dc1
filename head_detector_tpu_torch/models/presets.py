"""Architecture presets for the four YoloHeads variants (N/S/M/L).

A copy of ``head_detector_tpu/models/presets.py`` (configuration data only,
transcribed there from the reference arch-param YAMLs); the module semantics
live in ``blocks.py`` / ``yolo_heads.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from head_detector_tpu_torch.head_info import FLAME_CONSTS


@dataclasses.dataclass(frozen=True)
class StageCfg:
    out_channels: int
    num_blocks: int
    hidden_channels: int
    concat_intermediates: bool


@dataclasses.dataclass(frozen=True)
class NeckStageCfg:
    out_channels: int
    num_blocks: int
    hidden_channels: int
    width_mult: float = 1.0
    depth_mult: float = 1.0
    reduce_channels: bool = True  # up stages only; ignored by down stages


@dataclasses.dataclass(frozen=True)
class HeadCfg:
    stride: int
    bbox_inter_channels: int
    flame_inter_channels: int
    flame_regression_blocks: int
    flame_shape_inter_channels: int = 128
    flame_expression_inter_channels: int = 64
    flame_shape_out_channels: int = 64
    flame_expression_out_channels: int = 32
    flame_transformation_inter_channels: int = 16
    shared_stem: bool = False
    width_mult: float = 1.0
    first_conv_group_size: int = 0
    reg_max: int = 16


@dataclasses.dataclass(frozen=True)
class ArchCfg:
    """Full structural description of one YoloHeads variant."""

    name: str
    stem_channels: int
    stages: Tuple[StageCfg, ...]
    spp_channels: int
    neck_up: Tuple[NeckStageCfg, NeckStageCfg]
    neck_down: Tuple[NeckStageCfg, NeckStageCfg]
    heads: Tuple[HeadCfg, HeadCfg, HeadCfg]
    spp_k: Tuple[int, ...] = (5, 9, 13)
    num_classes: int = sum(FLAME_CONSTS.values())  # 413 FLAME params
    reg_max: int = 16
    bn_eps: float = 1e-6
    bn_momentum: float = 0.03
    grid_cell_scale: float = 5.0
    grid_cell_offset: float = 0.5


def _heads(
    strides=(8, 16, 32),
    bbox=(128, 256, 512),
    flame_inter=256,
    blocks=3,
    shape_inter=256,
    expr_inter=128,
    shape_out=128,
    expr_out=64,
    transf_inter=32,
    width_mult=1.0,
) -> Tuple[HeadCfg, HeadCfg, HeadCfg]:
    return tuple(
        HeadCfg(
            stride=s,
            bbox_inter_channels=b,
            flame_inter_channels=flame_inter if isinstance(flame_inter, int) else flame_inter[i],
            flame_regression_blocks=blocks,
            flame_shape_inter_channels=shape_inter,
            flame_expression_inter_channels=expr_inter,
            flame_shape_out_channels=shape_out,
            flame_expression_out_channels=expr_out,
            flame_transformation_inter_channels=transf_inter,
            width_mult=width_mult,
        )
        for i, (s, b) in enumerate(zip(strides, bbox))
    )


YOLO_HEADS_L = ArchCfg(
    name="yolo_heads_l",
    stem_channels=48,
    stages=(
        StageCfg(96, 2, 96, True),
        StageCfg(192, 3, 128, True),
        StageCfg(384, 5, 256, True),
        StageCfg(768, 2, 512, True),
    ),
    spp_channels=768,
    neck_up=(
        NeckStageCfg(192, 4, 128, reduce_channels=True),
        NeckStageCfg(96, 4, 128, reduce_channels=True),
    ),
    neck_down=(
        NeckStageCfg(192, 4, 128),
        NeckStageCfg(384, 4, 256),
    ),
    heads=_heads(),
    bn_momentum=0.03,
)

YOLO_HEADS_M = ArchCfg(
    name="yolo_heads_m",
    stem_channels=48,
    stages=(
        StageCfg(96, 2, 64, True),
        StageCfg(192, 3, 128, True),
        StageCfg(384, 5, 256, True),
        StageCfg(768, 2, 384, False),
    ),
    spp_channels=768,
    neck_up=(
        NeckStageCfg(192, 2, 192, reduce_channels=True),
        NeckStageCfg(96, 3, 64, reduce_channels=True),
    ),
    neck_down=(
        NeckStageCfg(192, 2, 192),
        NeckStageCfg(384, 3, 256),
    ),
    heads=_heads(
        bbox=(256, 256, 256),
        blocks=2,
        shape_inter=128,
        expr_inter=64,
        shape_out=64,
        expr_out=32,
        transf_inter=16,
        width_mult=0.75,
    ),
    bn_momentum=0.1,
)

YOLO_HEADS_S = ArchCfg(
    name="yolo_heads_s",
    stem_channels=48,
    stages=(
        StageCfg(96, 2, 32, False),
        StageCfg(192, 3, 64, False),
        StageCfg(384, 5, 96, False),
        StageCfg(768, 2, 192, False),
    ),
    spp_channels=768,
    neck_up=(
        NeckStageCfg(192, 2, 64, reduce_channels=True),
        NeckStageCfg(96, 2, 48, reduce_channels=True),
    ),
    neck_down=(
        NeckStageCfg(192, 2, 64),
        NeckStageCfg(384, 2, 64),
    ),
    heads=_heads(
        bbox=(128, 256, 512),
        flame_inter=(128, 512, 512),
        blocks=2,
        shape_inter=128,
        expr_inter=64,
        shape_out=64,
        expr_out=32,
        transf_inter=16,
        width_mult=0.75,
    ),
    bn_momentum=0.1,
)

YOLO_HEADS_N = ArchCfg(
    name="yolo_heads_n",
    stem_channels=32,
    stages=(
        StageCfg(64, 2, 32, False),
        StageCfg(128, 3, 48, False),
        StageCfg(256, 4, 64, False),
        StageCfg(512, 2, 128, False),
    ),
    spp_channels=512,
    neck_up=(
        NeckStageCfg(128, 2, 48, reduce_channels=True),
        NeckStageCfg(64, 2, 32, reduce_channels=True),
    ),
    neck_down=(
        NeckStageCfg(128, 2, 48),
        NeckStageCfg(256, 2, 48),
    ),
    heads=_heads(
        bbox=(256, 256, 256),
        flame_inter=(128, 512, 512),
        blocks=2,
        width_mult=0.33,
    ),
    bn_momentum=0.03,
)

PRESETS = {
    "yolo_heads_n": YOLO_HEADS_N,
    "yolo_heads_s": YOLO_HEADS_S,
    "yolo_heads_m": YOLO_HEADS_M,
    "yolo_heads_l": YOLO_HEADS_L,
    # short aliases matching the HF-hub model names used by the reference
    # HeadDetector (detector.py:25: "vgg_heads_l" etc.)
    "vgg_heads_n": YOLO_HEADS_N,
    "vgg_heads_s": YOLO_HEADS_S,
    "vgg_heads_m": YOLO_HEADS_M,
    "vgg_heads_l": YOLO_HEADS_L,
}


def get_arch(name: str) -> ArchCfg:
    key = name.lower()
    if key not in PRESETS:
        raise KeyError(f"Unknown arch {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[key]
