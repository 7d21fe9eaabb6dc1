"""YoloNASPANNeckWithC2: 2-up / 2-down PAN over four backbone levels.

Counterpart of ``head_detector_tpu/models/neck.py``: the first up stage fuses
(c5, c4, c3), the second (x, c3, c2); the down path uses the up stages'
pre-upsample intermediates as skips.  Emits (p3, p4, p5) at strides 8/16/32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from head_detector_tpu_torch.models.blocks import BlockCfg, YoloNASDownStage, YoloNASUpStage
from head_detector_tpu_torch.models.presets import ArchCfg


class YoloNASPANNeckWithC2(nn.Module):
    def __init__(self, arch: ArchCfg, in_channels: Sequence[int], cfg: BlockCfg = BlockCfg()):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        up1, up2 = arch.neck_up
        down1, down2 = arch.neck_down

        def up(c, chans):
            return YoloNASUpStage(chans, c.out_channels, c.num_blocks,
                                  hidden_channels=c.hidden_channels,
                                  width_mult=c.width_mult, depth_mult=c.depth_mult,
                                  reduce_channels=c.reduce_channels, cfg=cfg)

        def down(c, chans):
            return YoloNASDownStage(chans, c.out_channels, c.num_blocks,
                                    hidden_channels=c.hidden_channels,
                                    width_mult=c.width_mult,
                                    depth_mult=c.depth_mult, cfg=cfg)

        self.neck1 = up(up1, (c5, c4, c3))
        n1 = self.neck1.out_channels
        self.neck2 = up(up2, (n1, c3, c2))
        n2 = self.neck2.out_channels
        self.neck3 = down(down1, (n2, n2))
        self.neck4 = down(down2, (self.neck3.out_channels, n1))
        self.out_channels = (n2, self.neck3.out_channels, self.neck4.out_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        c2, c3, c4, c5 = inputs
        x_n1_inter, x = self.neck1([c5, c4, c3])
        x_n2_inter, p3 = self.neck2([x, c3, c2])
        p4 = self.neck3([p3, x_n2_inter])
        p5 = self.neck4([p4, x_n1_inter])
        return p3, p4, p5
