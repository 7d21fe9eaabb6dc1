"""YoloHeads: backbone -> neck -> heads, in torch, deploy or training layout.

Counterpart of ``head_detector_tpu/models/yolo_heads.py``.  Input is NCHW
float in [0, 1] (already letterboxed), spatial dims multiples of 32.

``dtype`` is the compute dtype, threaded as flax threads it: the input is
cast to it and every convolution computes in it (``blocks.Conv2d``),
BatchNorm keeps float32 statistics and computes in float32 before it rounds
to ``dtype``, and the DFL decode and the score sigmoid run in float32.  This
is not ``torch.autocast``, whose op lists are another policy.  The deploy
layout stores its convolutions' weights in ``dtype``; the training layout
keeps every parameter float32 (the master weights) and casts in the forward.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from head_detector_tpu_torch.models.backbone import NStageBackbone
from head_detector_tpu_torch.models.blocks import BatchNorm2d, BlockCfg
from head_detector_tpu_torch.models.heads import YoloHeadsNDFLHeads
from head_detector_tpu_torch.models.neck import YoloNASPANNeckWithC2
from head_detector_tpu_torch.models.presets import ArchCfg, get_arch

_CLS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class YoloHeads(nn.Module):
    def __init__(self, arch: ArchCfg, defer_globalization: bool = False,
                 skip_flame: bool = False, dtype: torch.dtype = torch.float32,
                 deploy: bool = True):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.deploy = deploy
        cfg = BlockCfg(eps=arch.bn_eps, momentum=arch.bn_momentum, deploy=deploy)
        self.backbone = NStageBackbone(arch, cfg=cfg)
        self.neck = YoloNASPANNeckWithC2(arch, self.backbone.out_channels, cfg=cfg)
        self.heads = YoloHeadsNDFLHeads(
            arch, self.neck.out_channels,
            defer_globalization=defer_globalization, skip_flame=skip_flame, cfg=cfg,
        )
        if deploy:
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    m.to(dtype)

    def forward(self, images: torch.Tensor, return_feats: bool = False):
        """:param images: [B, 3, H, W] float in [0, 1].
        :param return_feats: also return the neck pyramid (p3, p4, p5), which
            the sparse FLAME towers consume.
        :return: (DecodedPredictions, RawOutputs[, (p3, p4, p5)])"""
        if images.shape[2] % 32 or images.shape[3] % 32:
            raise ValueError(
                f"Input spatial dims must be divisible by 32, got {tuple(images.shape)}"
            )
        c2, c3, c4, c5 = self.backbone(images.to(self.dtype))
        p3, p4, p5 = self.neck([c2, c3, c4, c5])
        decoded, raw = self.heads([p3, p4, p5])
        if return_feats:
            return decoded, raw, (p3, p4, p5)
        return decoded, raw


def build_model(name_or_arch, defer_globalization: bool = False,
                skip_flame: bool = False, dtype: torch.dtype = torch.float32,
                deploy: bool = True) -> YoloHeads:
    """The model for a preset name or an ``ArchCfg``.  Deploy layout: weights
    from ``weights.state_dict_from_flax`` (``load_state_dict`` rounds the
    convolutions' float32 weights to ``dtype``).  Training layout
    (``deploy=False``): weights from :func:`init_model` or
    ``weights.train_state_dict_from_flax``."""
    arch = name_or_arch if isinstance(name_or_arch, ArchCfg) else get_arch(name_or_arch)
    return YoloHeads(arch, defer_globalization=defer_globalization, skip_flame=skip_flame,
                     dtype=dtype, deploy=deploy)


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal of variance 1/fan_in truncated to two
    standard deviations (the stddev corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def calibrate_batch_stats(model: YoloHeads, sample: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of one batch: a
    train-mode forward with momentum 1, which writes the batch statistics
    verbatim (``new = 0 * old + 1 * batch``).  Fresh running stats (mean 0,
    var 1) normalise nothing, and the branch sums of ~30 QARepVGG blocks
    then grow until the heads saturate.  The model is left in eval mode."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    model.train()
    try:
        model(sample)
    finally:
        for m, momentum in zip(norms, momenta):
            m.momentum = momentum
        model.eval()


def init_model(model: YoloHeads, generator: torch.Generator,
               image_size: Tuple[int, int] = (640, 640), batch: int = 1,
               calibrate: bool = True) -> YoloHeads:
    """Initialise ``model`` in place with flax's initialisers, drawn from
    ``generator`` (a CPU ``torch.Generator``): lecun-normal convolution
    kernels (fan-in over the kernel's taps and input channels, transposed
    convolutions included), zero biases, the classifier's bias at the focal
    prior ``-log((1 - 0.01) / 0.01)``, unit BatchNorm scales, QARepVGG
    ``alpha`` 1.  Then, with ``calibrate``, the running statistics of one
    batch of ``max(batch, 8)`` uniform images drawn from the same generator
    (:func:`calibrate_batch_stats`).  Returns the model, in eval mode."""
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            if isinstance(m, nn.ConvTranspose2d):  # [in, out, kh, kw]
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:  # [out, in / groups, kh, kw]
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            _lecun_normal_(w, fan_in, generator)
            with torch.no_grad():
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.fill_(_CLS_PRIOR_BIAS if name.endswith("cls_pred") else 0.0)
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()
    for name, p in model.named_parameters():
        if name.endswith("alpha"):
            with torch.no_grad():
                p.fill_(1.0)
    model.eval()
    if calibrate:
        device = next(model.parameters()).device
        sample = torch.rand((max(batch, 8), 3) + tuple(image_size), generator=generator)
        calibrate_batch_stats(model, sample.to(device))
    return model

