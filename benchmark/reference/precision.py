"""Precision settings of the reference and of its controls.

The reference computes in float32 with TF32 off.  A control is the
reference computed one step below the precision a configuration states:
TF32 for float32 (``tf32_products``: each convolution's and matmul's
float32 operands rounded to TF32's 10-bit mantissa, on the CPU as on the
card), float8 e4m3 for bfloat16
(``fp8_convolutions``: each convolution's input and weight rounded to e4m3
at a per-tensor scale; ``round_e4m3`` for a tensor that the configuration
emits in bfloat16).  The gradient passes each rounding unchanged.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

E4M3_MAX = 448.0


def set_float32(tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at the scale that maps its largest
    magnitude to the format's largest, as float32; the gradient is the
    identity."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax() / E4M3_MAX, min=1e-30)
    q = (xf / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return (xf + (q - xf).detach()).to(x.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (float32's exponent, a 10-bit mantissa; to the
    nearest, ties away from zero), as float32; the gradient is the identity."""
    xf = x.float().contiguous()
    bits = (xf.view(torch.int32) + 0x1000) & -0x2000
    return (xf + (bits.view(torch.float32) - xf).detach()).to(x.dtype)


@contextlib.contextmanager
def rounded_products(rounding, matmuls: bool = False):
    """Inside the block every ``F.conv2d`` / ``F.conv_transpose2d`` (and with
    ``matmuls`` every ``torch.matmul`` / ``torch.einsum``) takes its float32
    operands through ``rounding``."""
    saved = [(F, "conv2d"), (F, "conv_transpose2d")]
    if matmuls:
        saved += [(torch, "matmul"), (torch, "einsum")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in saved]

    def rounded(fn):
        def call(*args, **kwargs):
            args = [rounding(a) if isinstance(a, torch.Tensor) and a.dtype == torch.float32
                    else a for a in args]
            return fn(*args, **kwargs)
        return call

    for owner, name, fn in saved:
        setattr(owner, name, rounded(fn))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def fp8_convolutions():
    """Every convolution in the block on e4m3-rounded inputs and weights."""
    return rounded_products(round_e4m3)


def tf32_products():
    """Every convolution and matmul in the block on TF32-rounded operands."""
    return rounded_products(round_tf32, matmuls=True)
