"""Letterbox preprocessing on the device: lanczos4 resize + pad + normalize.

Counterpart of ``head_detector_tpu/ops/letterbox.py``: aspect-preserving
resize of the longest side to ``image_size`` with cv2's INTER_LANCZOS4
kernel, expressed as the same two dense resampling matrices (rows, then
columns), a clip to [0, 255], constant padding with 127, then ``/ 255``.
Output layout is NHWC, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.nn import functional as F


@functools.lru_cache(maxsize=32)
def _lanczos4_weights(src: int, dst: int) -> np.ndarray:
    """Dense [dst, src] resampling matrix with cv2's INTER_LANCZOS4 kernel
    (8-tap Lanczos a=4, border-clamped, weights normalised)."""
    scale = src / dst
    w = np.zeros((dst, src), np.float32)
    xs = (np.arange(dst) + 0.5) * scale - 0.5
    for i, center in enumerate(xs):
        left = int(np.floor(center)) - 3
        taps = np.arange(left, left + 8)
        t = taps - center
        with np.errstate(invalid="ignore", divide="ignore"):
            lz = np.sinc(t) * np.sinc(t / 4.0)
        lz[np.abs(t) >= 4] = 0.0
        lz = lz / lz.sum()
        np.add.at(w[i], np.clip(taps, 0, src - 1), lz.astype(np.float32))
    return w


class LetterboxSpec(NamedTuple):
    pad_left: int
    pad_top: int
    scale: float
    new_w: int
    new_h: int


def letterbox_spec(h: int, w: int, image_size: int = 640) -> LetterboxSpec:
    """Geometry of the letterbox for an h x w input."""
    if h > w:
        new_h, new_w = image_size, int(w * image_size / h)
    else:
        new_h, new_w = int(h * image_size / w), image_size
    scale = image_size / max(h, w)
    return LetterboxSpec(
        pad_left=(image_size - new_w) // 2,
        pad_top=(image_size - new_h) // 2,
        scale=scale,
        new_w=new_w,
        new_h=new_h,
    )


def letterbox_batch(images: torch.Tensor, image_size: int = 640) -> torch.Tensor:
    """Same-size batch: uint8 [B, H, W, C] -> float32 [B, S, S, C] on the
    images' device."""
    b, h, w, c = images.shape
    spec = letterbox_spec(h, w, image_size)
    dev = images.device
    wy = torch.as_tensor(_lanczos4_weights(h, spec.new_h), device=dev)
    wx = torch.as_tensor(_lanczos4_weights(w, spec.new_w), device=dev)
    imgs = images.to(torch.float32)
    imgs = torch.einsum("oh,bhwc->bowc", wy, imgs)
    imgs = torch.einsum("ow,bhwc->bhoc", wx, imgs)
    imgs = imgs.clamp(0.0, 255.0)
    pad_w = image_size - spec.new_w
    pad_h = image_size - spec.new_h
    imgs = F.pad(
        imgs,
        (0, 0, spec.pad_left, pad_w - spec.pad_left, spec.pad_top, pad_h - spec.pad_top),
        value=127.0,
    )
    return imgs / 255.0


def letterbox(
    image: torch.Tensor, image_size: int = 640
) -> Tuple[torch.Tensor, Tuple[int, int], float]:
    """uint8 HWC image -> (float32 [1, S, S, 3], (pad_l, pad_t), scale)."""
    spec = letterbox_spec(image.shape[0], image.shape[1], image_size)
    return letterbox_batch(image[None], image_size), (spec.pad_left, spec.pad_top), spec.scale
