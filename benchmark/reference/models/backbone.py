"""NStageBackbone: YoloNAS stem + 4 stages + SPP context module.

Counterpart of ``head_detector_tpu/models/backbone.py``: emits feature maps
at strides 4, 8, 16 and 32 (stage1, stage2, stage3, context_module).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from benchmark.reference.models.blocks import SPP, BlockCfg, YoloNASStage, YoloNASStem
from benchmark.reference.models.presets import ArchCfg


class NStageBackbone(nn.Module):
    def __init__(self, arch: ArchCfg, in_channels: int = 3, s2d_stem: bool = False,
                 cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.stem = YoloNASStem(in_channels, arch.stem_channels, s2d=s2d_stem, cfg=cfg)
        ch = arch.stem_channels
        for i, st in enumerate(arch.stages):
            self.add_module(
                f"stage{i + 1}",
                YoloNASStage(ch, st.out_channels, st.num_blocks,
                             hidden_channels=st.hidden_channels,
                             concat_intermediates=st.concat_intermediates,
                             cfg=cfg),
            )
            ch = st.out_channels
        self.num_stages = len(arch.stages)
        self.context_module = SPP(ch, arch.spp_channels, k=arch.spp_k, cfg=cfg)
        self.out_channels = tuple(st.out_channels for st in arch.stages[:3]) + (
            arch.spp_channels,
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"stage{i + 1}")(x)
            outs.append(x)
        return outs[0], outs[1], outs[2], self.context_module(outs[-1])
