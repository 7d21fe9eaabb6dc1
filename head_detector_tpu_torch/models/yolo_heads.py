"""YoloHeads: backbone -> neck -> heads, in torch (deploy layout).

Counterpart of ``head_detector_tpu/models/yolo_heads.py``.  Input is NCHW
float in [0, 1] (already letterboxed), spatial dims multiples of 32.

``dtype`` is the compute dtype, threaded as flax threads it: the input and
every convolution's kernel and bias are in ``dtype`` (the weights are stored
so), BatchNorm keeps float32 statistics and computes in float32 before it
rounds to ``dtype``, and the DFL decode and the score sigmoid run in
float32.  This is not ``torch.autocast``, whose op lists are another policy.
"""

from __future__ import annotations

import torch
from torch import nn

from head_detector_tpu_torch.models.backbone import NStageBackbone
from head_detector_tpu_torch.models.heads import YoloHeadsNDFLHeads
from head_detector_tpu_torch.models.neck import YoloNASPANNeckWithC2
from head_detector_tpu_torch.models.presets import ArchCfg, get_arch


class YoloHeads(nn.Module):
    def __init__(self, arch: ArchCfg, defer_globalization: bool = False,
                 skip_flame: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.backbone = NStageBackbone(arch)
        self.neck = YoloNASPANNeckWithC2(arch, self.backbone.out_channels)
        self.heads = YoloHeadsNDFLHeads(
            arch, self.neck.out_channels,
            defer_globalization=defer_globalization, skip_flame=skip_flame,
        )
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
                skip_flame: bool = False, dtype: torch.dtype = torch.float32) -> YoloHeads:
    """The deploy-layout model for a preset name or an ``ArchCfg``; weights
    come from ``weights.state_dict_from_flax`` (``load_state_dict`` rounds
    the convolutions' float32 weights to ``dtype``)."""
    arch = name_or_arch if isinstance(name_or_arch, ArchCfg) else get_arch(name_or_arch)
    return YoloHeads(arch, defer_globalization=defer_globalization, skip_flame=skip_flame,
                     dtype=dtype)
