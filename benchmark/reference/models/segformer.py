"""SegFormer's MiT encoder feeding the YoloHeads NDFL heads: the plain float32
reference of the port's ``SegFormerYoloHeads``.

The MiT of Xie et al., "SegFormer" (NeurIPS 2021), as NVlabs/SegFormer's
``mix_transformer.py`` builds ``mit_b5`` (embed dims 64/128/320/512, depths
3/6/40/3, heads 1/2/5/8, spatial-reduction ratios 8/4/2/1, Mix-FFN ratio 4,
overlapping patch embeds 7/3/3/3 at strides 4/2/2/2): four stages of an
overlapping patch embed (a padded strided convolution, then a LayerNorm over
the tokens), pre-norm blocks of efficient self-attention (keys and values
from the tokens reduced ``sr`` x ``sr`` by a strided convolution and a
LayerNorm) and Mix-FFN (Linear, depthwise 3x3, GELU, Linear), each with its
residual, and a LayerNorm.  Stages 2-4 (strides 8/16/32) feed
``heads.YoloHeadsNDFLHeads`` in the training layout, as VGGHeads's
``SegFormerYoloHeads`` does.  Input: NCHW float32 in [0, 1].

Every product is a ``torch.matmul`` or an ``F.conv2d`` on float32 operands,
so ``precision.rounded_products(..., matmuls=True)`` reaches each of them;
run it with TF32 off (``precision.set_float32(False)``).  State-dict names
are the port's training-layout names (``backbone.stage3_block7.attn.q.weight``),
so one state dict loads into both.

Where it departs from the published MiT or from the port, one line each:

- LayerNorm's variance in two passes, E[(x - E[x])^2], as the published ``nn.LayerNorm``; the port takes E[x^2] - E[x]^2 clipped at 0, as flax does.
- the scores scaled by ``head_dim ** -0.5``, as published; the port divides by ``sqrt(head_dim)`` rounded to its compute dtype.
- every LayerNorm at epsilon 1e-6, as the port; the published patch-embed and ``sr`` LayerNorms take ``nn.LayerNorm``'s 1e-5.
- GELU in its tanh form, as the port; the published ``nn.GELU`` is the exact one.
- keys and values from two Linears ``k`` and ``v``, as the port; the published ``kv`` is one Linear of twice the width, the same function.
- no dropout and no stochastic depth, as the port; the published ``mit_b5`` trains with a drop-path rate of 0.1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.models.blocks import BlockCfg, Conv2d
from benchmark.reference.models.heads import YoloHeadsNDFLHeads
from benchmark.reference.models.presets import ArchCfg

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MiTCfg:
    embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 6, 40, 3)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    patch_strides: Tuple[int, ...] = (4, 2, 2, 2)
    patch_pads: Tuple[int, ...] = (3, 1, 1, 1)
    mlp_ratio: int = 4


def mit_from_dict(mit: dict) -> MiTCfg:
    """A configuration file's ``mit`` group -> ``MiTCfg``."""
    return MiTCfg(**{k: tuple(v) if isinstance(v, list) else v for k, v in mit.items()})


class Linear(nn.Linear):
    """``x @ weight.T + bias``, the product through ``torch.matmul``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.t()) + self.bias


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, its variance in two passes."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


def tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, C] -> NCHW."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, stride: int, pad: int):
        super().__init__()
        self.proj = Conv2d(in_channels, dim, patch, stride, padding=pad, bias=True)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        return self.norm(tokens(x)), x.shape[2], x.shape[3]


class EfficientSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.head_dim, self.sr_ratio = heads, dim // heads, sr_ratio
        self.q = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio, bias=True)
            self.sr_norm = LayerNorm(dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        kv = self.sr_norm(tokens(self.sr(image(x, h, w)))) if self.sr_ratio > 1 else x
        m = kv.shape[1]

        def split(t, rows):  # [B, rows, C] -> [B, heads, rows, head_dim]
            return t.reshape(b, rows, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.q(x), n), split(self.k(kv), m), split(self.v(kv), m)
        scores = torch.matmul(q, k.transpose(-2, -1)) * self.head_dim ** -0.5
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int):
        super().__init__()
        hidden = dim * mlp_ratio
        self.fc1 = Linear(dim, hidden)
        self.dwconv = Conv2d(hidden, hidden, 3, padding=1, groups=hidden, bias=True)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        y = self.dwconv(image(self.fc1(x), h, w))
        return self.fc2(tokens(F.gelu(y, approximate="tanh")))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientSelfAttention(dim, heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.ffn(self.norm2(x), h, w)


class MiTBackbone(nn.Module):
    """The four stage outputs, NCHW, at strides 4, 8, 16 and 32."""

    def __init__(self, cfg: MiTCfg):
        super().__init__()
        self.cfg = cfg
        in_ch = 3
        for s, dim in enumerate(cfg.embed_dims):
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_ch, dim, cfg.patch_sizes[s], cfg.patch_strides[s], cfg.patch_pads[s]))
            for blk in range(cfg.depths[s]):
                self.add_module(f"stage{s + 1}_block{blk}", MiTBlock(
                    dim, cfg.num_heads[s], cfg.sr_ratios[s], cfg.mlp_ratio))
            self.add_module(f"norm{s + 1}", LayerNorm(dim))
            in_ch = dim

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for s in range(len(self.cfg.embed_dims)):
            t, h, w = getattr(self, f"patch_embed{s + 1}")(x)
            for blk in range(self.cfg.depths[s]):
                t = getattr(self, f"stage{s + 1}_block{blk}")(t, h, w)
            x = image(getattr(self, f"norm{s + 1}")(t), h, w)
            outs.append(x)
        return outs


class SegFormerYoloHeads(nn.Module):
    """MiT -> stages 2-4 -> the NDFL heads of ``arch`` (training layout)
    -> ``(DecodedPredictions, RawOutputs)``."""

    def __init__(self, mit: MiTCfg, arch: ArchCfg):
        super().__init__()
        self.backbone = MiTBackbone(mit)
        cfg = BlockCfg(eps=arch.bn_eps, momentum=arch.bn_momentum, deploy=False)
        self.heads = YoloHeadsNDFLHeads(arch, mit.embed_dims[1:], cfg=cfg)

    def forward(self, images: torch.Tensor):
        return self.heads(self.backbone(images)[1:])


def build_model(mit: MiTCfg, arch: ArchCfg, state: Optional[Dict[str, torch.Tensor]],
                device, train: bool = False) -> SegFormerYoloHeads:
    """The float32 network on ``device``, with ``state`` loaded when given."""
    net = SegFormerYoloHeads(mit, arch).to(device)
    if state is not None:
        net.load_state_dict(state, strict=True)
    return net.train(train)
