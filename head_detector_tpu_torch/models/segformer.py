"""SegFormer (MiT) backbone feeding the YoloHeads NDFL heads, in torch.

Counterpart of ``head_detector_tpu/models/segformer.py``: a MiT-B5
hierarchical transformer encoder (overlap patch embeds; efficient
self-attention with spatial-reduction ratios 8/4/2/1 and heads 1/2/5/8;
Mix-FFN with a depthwise 3x3; embed dims 64/128/320/512, depths 3/6/40/3),
whose last three stages (strides 8/16/32) drive the training-layout heads of
the L preset.

Module names follow the flax scopes (``backbone.stage3_block7.attn.q``), so
``weights.train_state_dict_from_flax`` carries a flax tree leaf by leaf.
Inside a stage the activations are tokens ``[B, N, C]``; the patch-embed,
``sr`` and ``dwconv`` convolutions and the stage outputs are NCHW.

Numerics follow flax: every ``Linear``, convolution and ``LayerNorm``
computes in the model dtype from float32 master weights; :class:`LayerNorm`
takes its statistics in float32 as ``E[x^2] - E[x]^2`` clipped at 0
(epsilon 1e-6) and rounds to the dtype at the end; the GELU is the tanh
approximation; attention is two explicit matmuls in the dtype around a
float32 softmax, as the JAX einsums are.

Under a profiler session (``profiling.py``) each block's attention records
the span ``mit.attention`` and adds the query-key pairs it scores, ``b *
heads * n * m`` with ``m`` the tokens after the spatial reduction, to the
counter ``mit.attention_pairs``; each block's Mix-FFN records ``mit.ffn``.
Both spans hold the forward's enqueue on the host and close before the
block's residual add.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from head_detector_tpu_torch.models.blocks import BlockCfg, Conv2d
from head_detector_tpu_torch.models.heads import YoloHeadsNDFLHeads
from head_detector_tpu_torch.models.presets import YOLO_HEADS_L, ArchCfg
from head_detector_tpu_torch.profiling import count, span


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


MIT_B5 = MiTCfg()
MIT_B0 = MiTCfg(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2))


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype (flax ``Dense`` with
    ``dtype``): weight and bias are cast to it in the forward."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the last axis: float32 statistics with
    ``var = max(E[x^2] - E[x]^2, 0)``, ``(x - mean) * rsqrt(var + eps) *
    scale + bias`` in float32, rounded to the input's dtype at the end."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> tokens [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def _image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tokens [B, H*W, C] -> NCHW."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


class OverlapPatchEmbed(nn.Module):
    """Strided convolution (padded, so patches overlap) + LayerNorm:
    NCHW -> (tokens, H', W')."""

    def __init__(self, in_channels: int, dim: int, patch: int, stride: int, pad: int):
        super().__init__()
        self.proj = Conv2d(in_channels, dim, patch, stride, padding=pad, bias=True)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        h, w = x.shape[2], x.shape[3]
        return self.norm(_tokens(x)), h, w


class EfficientSelfAttention(nn.Module):
    """Multi-head attention whose keys and values come from the tokens
    reduced ``sr_ratio`` x ``sr_ratio`` by a strided convolution."""

    def __init__(self, dim: int, heads: int, sr_ratio: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.sr_ratio = sr_ratio
        # sqrt(head_dim) rounded in the compute dtype, as the JAX package takes
        # it; on the CPU, so that the model also builds on the meta device
        self.scale = float(torch.tensor(float(self.head_dim), dtype=dtype, device="cpu").sqrt())
        self.q = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio, bias=True)
            self.sr_norm = LayerNorm(dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        with span("mit.attention"):
            b, n, c = x.shape
            q = self.q(x).reshape(b, n, self.heads, self.head_dim).transpose(1, 2)
            kv = x
            if self.sr_ratio > 1:
                kv = self.sr_norm(_tokens(self.sr(_image(x, h, w))))
            m = kv.shape[1]
            count("mit.attention_pairs", b * self.heads * n * m)
            k = self.k(kv).reshape(b, m, self.heads, self.head_dim).permute(0, 2, 3, 1)
            v = self.v(kv).reshape(b, m, self.heads, self.head_dim).transpose(1, 2)
            attn = torch.matmul(q, k) / self.scale  # [B, heads, N, M]
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
            return self.proj(out)


class MixFFN(nn.Module):
    """Linear -> depthwise 3x3 -> GELU (tanh) -> Linear."""

    def __init__(self, dim: int, mlp_ratio: int):
        super().__init__()
        hidden = dim * mlp_ratio
        self.fc1 = Linear(dim, hidden)
        self.dwconv = Conv2d(hidden, hidden, 3, padding=1, groups=hidden, bias=True)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        with span("mit.ffn"):
            y = self.dwconv(_image(self.fc1(x), h, w))
            return self.fc2(_tokens(F.gelu(y, approximate="tanh")))


class MiTBlock(nn.Module):
    """Pre-norm transformer block: attention and Mix-FFN residuals."""

    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientSelfAttention(dim, heads, sr_ratio, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.ffn(self.norm2(x), h, w)


class MiTBackbone(nn.Module):
    """Four stages of patch embed -> blocks -> LayerNorm; returns the four
    stage outputs NCHW (strides 4, 8, 16, 32)."""

    def __init__(self, cfg: MiTCfg = MIT_B5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        in_ch = 3
        for s in range(4):
            dim = cfg.embed_dims[s]
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_ch, dim, cfg.patch_sizes[s], cfg.patch_strides[s], cfg.patch_pads[s]))
            for blk in range(cfg.depths[s]):
                self.add_module(f"stage{s + 1}_block{blk}", MiTBlock(
                    dim, cfg.num_heads[s], cfg.sr_ratios[s], cfg.mlp_ratio, dtype=dtype))
            self.add_module(f"norm{s + 1}", LayerNorm(dim))
            in_ch = dim

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for s in range(4):
            tokens, h, w = getattr(self, f"patch_embed{s + 1}")(x)
            for blk in range(self.cfg.depths[s]):
                tokens = getattr(self, f"stage{s + 1}_block{blk}")(tokens, h, w)
            x = _image(getattr(self, f"norm{s + 1}")(tokens), h, w)
            outs.append(x)
        return outs


class SegFormerYoloHeads(nn.Module):
    """MiT backbone -> stages 2-4 -> ``YoloHeadsNDFLHeads`` in the training
    layout (the stride-4 stage is dropped, as the reference's forward drops
    it).  ``arch`` donates the heads and their BatchNorm settings (the L
    preset by default); ``dtype`` is the compute dtype.  Input: NCHW float in
    [0, 1]; output ``(DecodedPredictions, RawOutputs)``."""

    def __init__(self, mit: MiTCfg = MIT_B5, arch: Optional[ArchCfg] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mit = mit
        self.arch = arch or YOLO_HEADS_L
        self.dtype = dtype
        self.backbone = MiTBackbone(mit, dtype=dtype)
        cfg = BlockCfg(eps=self.arch.bn_eps, momentum=self.arch.bn_momentum, deploy=False)
        self.heads = YoloHeadsNDFLHeads(self.arch, mit.embed_dims[1:], cfg=cfg)

    def forward(self, images: torch.Tensor):
        stages = self.backbone(images.to(self.dtype))
        return self.heads(stages[1:])

