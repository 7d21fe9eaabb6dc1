"""YOLO-NAS building blocks in torch (NCHW), deploy layout only.

Counterpart of ``head_detector_tpu/models/blocks.py``.  Every QARepVGG block
is its structurally re-parameterised form, one 3x3 conv with bias
(``rbr_reparam``) + ReLU; ``weights.py`` folds training checkpoints into it.
Module and attribute names follow the flax scope names, so a flax path
``a/b/conv/kernel`` is the torch key ``a.b.conv.weight``.  Inference only:
BatchNorm layers run on their running statistics (call ``.eval()``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def width_multiplier(value: int, factor: float, divisor: int = 8) -> int:
    """Channel scaling (SG ``modules.utils.width_multiplier`` semantics)."""
    return int(np.ceil(value * factor / divisor) * divisor)


def _num_blocks(num_blocks: int, depth_mult: float) -> int:
    return max(round(num_blocks * depth_mult), 1) if num_blocks > 1 else num_blocks


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + optional ReLU (SG ``ConvBNReLU``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, use_act: bool = True, eps: float = 1e-6):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding=kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=eps)
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_act else x


class QARepVGGBlock(nn.Module):
    """Deploy-form QARepVGG block: one 3x3 conv (+bias) and ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 use_act: bool = True):
        super().__init__()
        self.rbr_reparam = nn.Conv2d(in_channels, out_channels, 3, stride, padding=1,
                                     bias=True)
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.rbr_reparam(x)
        return F.relu(y) if self.use_act else y


class YoloNASBottleneck(nn.Module):
    """Two QARepVGG blocks with a residual add when shapes allow."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = QARepVGGBlock(in_channels, out_channels)
        self.cv2 = QARepVGGBlock(out_channels, out_channels)
        self.residual = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.residual else y


class YoloNASCSPLayer(nn.Module):
    """Cross-stage-partial layer over YoloNASBottlenecks; with
    ``concat_intermediates`` every bottleneck output joins the final concat."""

    def __init__(self, in_channels: int, out_channels: int, num_bottlenecks: int,
                 hidden_channels: Optional[int] = None,
                 concat_intermediates: bool = False, expansion: float = 0.5,
                 eps: float = 1e-6):
        super().__init__()
        hidden = hidden_channels or int(out_channels * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, eps=eps)
        self.conv2 = ConvBNAct(in_channels, hidden, eps=eps)
        self.num_bottlenecks = num_bottlenecks
        for i in range(num_bottlenecks):
            self.add_module(f"bottleneck{i}", YoloNASBottleneck(hidden, hidden))
        self.concat_intermediates = concat_intermediates
        merged = hidden * ((num_bottlenecks + 2) if concat_intermediates else 2)
        self.conv3 = ConvBNAct(merged, out_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        bypass = self.conv2(x)
        outs = [h]
        for i in range(self.num_bottlenecks):
            h = getattr(self, f"bottleneck{i}")(h)
            outs.append(h)
        merged = outs + [bypass] if self.concat_intermediates else [h, bypass]
        return self.conv3(torch.cat(merged, dim=1))


class SPP(nn.Module):
    """Spatial pyramid pooling (stride-1 max pools, -inf padded)."""

    def __init__(self, in_channels: int, out_channels: int,
                 k: Tuple[int, ...] = (5, 9, 13), eps: float = 1e-6):
        super().__init__()
        hidden = in_channels // 2
        self.k = tuple(k)
        self.cv1 = ConvBNAct(in_channels, hidden, eps=eps)
        self.cv2 = ConvBNAct(hidden * (len(self.k) + 1), out_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        pools = [x] + [F.max_pool2d(x, ks, stride=1, padding=ks // 2) for ks in self.k]
        return self.cv2(torch.cat(pools, dim=1))


class YoloNASStem(nn.Module):
    """Stride-2 QARepVGG stem."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = QARepVGGBlock(in_channels, out_channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class YoloNASStage(nn.Module):
    """Stride-2 downsample block + CSP layer."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int,
                 hidden_channels: Optional[int] = None,
                 concat_intermediates: bool = False, eps: float = 1e-6):
        super().__init__()
        self.downsample = QARepVGGBlock(in_channels, out_channels, stride=2)
        self.blocks = YoloNASCSPLayer(out_channels, out_channels, num_blocks,
                                      hidden_channels=hidden_channels,
                                      concat_intermediates=concat_intermediates,
                                      eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class YoloNASUpStage(nn.Module):
    """PAN top-down stage: 1x1 reduce -> 2x transposed-conv upsample -> concat
    with (reduced) skip(s) -> CSP.  Returns ``(x_inter, x)``; ``x_inter`` is
    the pre-upsample tensor the down path consumes.  With three inputs the
    second skip is also downsampled 2x."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, num_blocks: int,
                 hidden_channels: Optional[int] = None, width_mult: float = 1.0,
                 depth_mult: float = 1.0, reduce_channels: bool = False,
                 eps: float = 1e-6):
        super().__init__()
        out_ch = width_multiplier(out_channels, width_mult, 8)
        self.out_channels = out_ch
        self.reduce_channels = reduce_channels
        self.three = len(in_channels) == 3
        x_ch, skip_chs = in_channels[0], list(in_channels[1:])
        if reduce_channels:
            if self.three:
                self.reduce_skip1 = ConvBNAct(skip_chs[0], out_ch, eps=eps)
                self.reduce_skip2 = ConvBNAct(skip_chs[1], out_ch, eps=eps)
            else:
                self.reduce_skip = ConvBNAct(skip_chs[0], out_ch, eps=eps)
            skip_chs = [out_ch] * len(skip_chs)
        if self.three:
            self.downsample = ConvBNAct(skip_chs[1], out_ch, 3, stride=2, eps=eps)
            skip_chs[1] = out_ch
        self.conv = ConvBNAct(x_ch, out_ch, eps=eps)
        self.upsample = nn.ConvTranspose2d(out_ch, out_ch, 2, stride=2, bias=True)
        concat_ch = out_ch + sum(skip_chs)
        if reduce_channels:
            self.reduce_after_concat = ConvBNAct(concat_ch, out_ch, eps=eps)
            concat_ch = out_ch
        self.blocks = YoloNASCSPLayer(concat_ch, out_ch, _num_blocks(num_blocks, depth_mult),
                                      hidden_channels=hidden_channels, eps=eps)

    def forward(self, inputs: Sequence[torch.Tensor]):
        if self.three:
            x, skip1, skip2 = inputs
            if self.reduce_channels:
                skip1 = self.reduce_skip1(skip1)
                skip2 = self.reduce_skip2(skip2)
            skips = [skip1, self.downsample(skip2)]
        else:
            x, skip = inputs
            if self.reduce_channels:
                skip = self.reduce_skip(skip)
            skips = [skip]
        x_inter = self.conv(x)
        x = torch.cat([self.upsample(x_inter), *skips], dim=1)
        if self.reduce_channels:
            x = self.reduce_after_concat(x)
        return x_inter, self.blocks(x)


class YoloNASDownStage(nn.Module):
    """PAN bottom-up stage: stride-2 3x3 conv -> concat skip -> CSP."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, num_blocks: int,
                 hidden_channels: Optional[int] = None, width_mult: float = 1.0,
                 depth_mult: float = 1.0, eps: float = 1e-6):
        super().__init__()
        x_ch, skip_ch = in_channels
        out_ch = width_multiplier(out_channels, width_mult, 8)
        self.out_channels = out_ch
        self.conv = ConvBNAct(x_ch, out_ch // 2, 3, stride=2, eps=eps)
        self.blocks = YoloNASCSPLayer(out_ch // 2 + skip_ch, out_ch,
                                      _num_blocks(num_blocks, depth_mult),
                                      hidden_channels=hidden_channels, eps=eps)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        x, skip = inputs
        return self.blocks(torch.cat([self.conv(x), skip], dim=1))
