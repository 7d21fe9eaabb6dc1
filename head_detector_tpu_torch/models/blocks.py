"""YOLO-NAS building blocks in torch (NCHW), deploy and training layouts.

Counterpart of ``head_detector_tpu/models/blocks.py``.  With
``BlockCfg.deploy`` (the default) every QARepVGG block is its structurally
re-parameterised form, one 3x3 conv with bias (``rbr_reparam``) + ReLU, and
``weights.py`` folds training checkpoints into it.  Without it the blocks
have the training layout: a 3x3 conv + BatchNorm branch, a 1x1 conv with
bias (scaled by a learnable ``alpha`` in the FLAME towers), the identity
where shapes allow, then ``post_bn``.  Module and attribute names follow the
flax scope names, so a flax path ``a/b/conv/kernel`` is the torch key
``a.b.conv.weight``.

Compute dtype, as flax threads it: the activations carry it, every
convolution casts its weight and bias to the input's dtype in the forward
(the parameters stay as they are stored: float32 in the training layout),
and BatchNorm computes in float32 before it rounds to the input's dtype.
BatchNorm follows flax in training too (:class:`BatchNorm2d`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """Knobs every block shares: BatchNorm epsilon and momentum (torch
    convention, the fraction of the new batch statistic) and the layout."""

    eps: float = 1e-6
    momentum: float = 0.03
    deploy: bool = True


def width_multiplier(value: int, factor: float, divisor: int = 8) -> int:
    """Channel scaling (SG ``modules.utils.width_multiplier`` semantics)."""
    return int(np.ceil(value * factor / divisor) * divisor)


def _num_blocks(num_blocks: int, depth_mult: float) -> int:
    return max(round(num_blocks * depth_mult), 1) if num_blocks > 1 else num_blocks


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype: weight and bias are
    cast to it in the forward (a no-op where they are stored so)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's semantics.

    Eval: normalise by the running statistics.  Training: normalise by the
    batch's mean and biased variance and update the running statistics as
    flax does, ``new = m * old + (1 - m) * batch`` with the flax momentum
    ``m = 1 - momentum`` and the *biased* batch variance (``nn.BatchNorm2d``
    would store the unbiased one).  The batch statistics come out of the
    same ``F.batch_norm`` call through scratch buffers at momentum 1."""

    def __init__(self, num_features: int, eps: float = 1e-6, momentum: float = 0.03):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum
        with torch.no_grad():
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(
                keep * self.running_var + (1.0 - keep) * (var * ((n - 1) / n)))
        return y


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + optional ReLU (SG ``ConvBNReLU``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, use_act: bool = True, cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding=kernel_size // 2, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=cfg.eps, momentum=cfg.momentum)
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_act else x


class QARepVGGBlock(nn.Module):
    """QARepVGG block.  Deploy: one 3x3 conv (+bias) and ReLU.  Training:
    ``relu(post_bn(bn(conv3x3(x)) + alpha * conv1x1(x) [+ x]))``, the
    identity only when ``use_residual_connection`` and the shapes allow."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 use_act: bool = True, use_residual_connection: bool = True,
                 use_alpha: bool = False, cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.use_act = use_act
        self.deploy = cfg.deploy
        if self.deploy:
            self.rbr_reparam = Conv2d(in_channels, out_channels, 3, stride, padding=1,
                                      bias=True)
            return
        self.branch_3x3_conv = Conv2d(in_channels, out_channels, 3, stride, padding=1,
                                      bias=False)
        self.branch_3x3_bn = BatchNorm2d(out_channels, eps=cfg.eps, momentum=cfg.momentum)
        self.branch_1x1 = Conv2d(in_channels, out_channels, 1, stride, bias=True)
        self.alpha = nn.Parameter(torch.ones(())) if use_alpha else None
        self.identity = (use_residual_connection and in_channels == out_channels
                         and stride == 1)
        self.post_bn = BatchNorm2d(out_channels, eps=cfg.eps, momentum=cfg.momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            y = self.rbr_reparam(x)
        else:
            y1 = self.branch_1x1(x)
            if self.alpha is not None:
                y1 = y1 * self.alpha.to(y1.dtype)
            y = self.branch_3x3_bn(self.branch_3x3_conv(x)) + y1
            if self.identity:
                y = y + x
            y = self.post_bn(y)
        return F.relu(y) if self.use_act else y


class YoloNASBottleneck(nn.Module):
    """Two QARepVGG blocks with a residual add when shapes allow."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.cv1 = QARepVGGBlock(in_channels, out_channels, cfg=cfg)
        self.cv2 = QARepVGGBlock(out_channels, out_channels, cfg=cfg)
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
                 cfg: BlockCfg = BlockCfg()):
        super().__init__()
        hidden = hidden_channels or int(out_channels * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, cfg=cfg)
        self.conv2 = ConvBNAct(in_channels, hidden, cfg=cfg)
        self.num_bottlenecks = num_bottlenecks
        for i in range(num_bottlenecks):
            self.add_module(f"bottleneck{i}", YoloNASBottleneck(hidden, hidden, cfg=cfg))
        self.concat_intermediates = concat_intermediates
        merged = hidden * ((num_bottlenecks + 2) if concat_intermediates else 2)
        self.conv3 = ConvBNAct(merged, out_channels, cfg=cfg)

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
                 k: Tuple[int, ...] = (5, 9, 13), cfg: BlockCfg = BlockCfg()):
        super().__init__()
        hidden = in_channels // 2
        self.k = tuple(k)
        self.cv1 = ConvBNAct(in_channels, hidden, cfg=cfg)
        self.cv2 = ConvBNAct(hidden * (len(self.k) + 1), out_channels, cfg=cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        pools = [x] + [F.max_pool2d(x, ks, stride=1, padding=ks // 2) for ks in self.k]
        return self.cv2(torch.cat(pools, dim=1))


class YoloNASStem(nn.Module):
    """Stride-2 QARepVGG stem."""

    def __init__(self, in_channels: int, out_channels: int, cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.conv = QARepVGGBlock(in_channels, out_channels, stride=2,
                                  use_residual_connection=False, cfg=cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class YoloNASStage(nn.Module):
    """Stride-2 downsample block + CSP layer."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int,
                 hidden_channels: Optional[int] = None,
                 concat_intermediates: bool = False, cfg: BlockCfg = BlockCfg()):
        super().__init__()
        self.downsample = QARepVGGBlock(in_channels, out_channels, stride=2,
                                        use_residual_connection=False, cfg=cfg)
        self.blocks = YoloNASCSPLayer(out_channels, out_channels, num_blocks,
                                      hidden_channels=hidden_channels,
                                      concat_intermediates=concat_intermediates,
                                      cfg=cfg)

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
                 cfg: BlockCfg = BlockCfg()):
        super().__init__()
        out_ch = width_multiplier(out_channels, width_mult, 8)
        self.out_channels = out_ch
        self.reduce_channels = reduce_channels
        self.three = len(in_channels) == 3
        x_ch, skip_chs = in_channels[0], list(in_channels[1:])
        if reduce_channels:
            if self.three:
                self.reduce_skip1 = ConvBNAct(skip_chs[0], out_ch, cfg=cfg)
                self.reduce_skip2 = ConvBNAct(skip_chs[1], out_ch, cfg=cfg)
            else:
                self.reduce_skip = ConvBNAct(skip_chs[0], out_ch, cfg=cfg)
            skip_chs = [out_ch] * len(skip_chs)
        if self.three:
            self.downsample = ConvBNAct(skip_chs[1], out_ch, 3, stride=2, cfg=cfg)
            skip_chs[1] = out_ch
        self.conv = ConvBNAct(x_ch, out_ch, cfg=cfg)
        self.upsample = ConvTranspose2d(out_ch, out_ch, 2, stride=2, bias=True)
        concat_ch = out_ch + sum(skip_chs)
        if reduce_channels:
            self.reduce_after_concat = ConvBNAct(concat_ch, out_ch, cfg=cfg)
            concat_ch = out_ch
        self.blocks = YoloNASCSPLayer(concat_ch, out_ch, _num_blocks(num_blocks, depth_mult),
                                      hidden_channels=hidden_channels, cfg=cfg)

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
                 depth_mult: float = 1.0, cfg: BlockCfg = BlockCfg()):
        super().__init__()
        x_ch, skip_ch = in_channels
        out_ch = width_multiplier(out_channels, width_mult, 8)
        self.out_channels = out_ch
        self.conv = ConvBNAct(x_ch, out_ch // 2, 3, stride=2, cfg=cfg)
        self.blocks = YoloNASCSPLayer(out_ch // 2 + skip_ch, out_ch,
                                      _num_blocks(num_blocks, depth_mult),
                                      hidden_channels=hidden_channels, cfg=cfg)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        x, skip = inputs
        return self.blocks(torch.cat([self.conv(x), skip], dim=1))
