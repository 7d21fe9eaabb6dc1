"""Batched bilinear warps on the device.

Counterpart of ``head_detector_tpu/ops/warp.py``:

* ``affine_warp``: all crops of an image in one gather; for each output
  pixel the source is ``inv_matrix @ [x, y, 1]``, bilinearly interpolated,
  ``fill_value`` outside the image (cv2's INTER_LINEAR + BORDER_CONSTANT);
* ``scaled_crops_matmul``: axis-aligned crops as two matrix products with
  hat-function weights (separable bilinear resampling, edge-clamped);
* ``rotate_crops_matmul``: a rotation about each crop's centre as an exact
  quarter-turn and three shears, each shear a per-line fractional shift
  done in the frequency domain by matrix products against a DFT basis;
* ``aligned_crops_matmul``: an expanded axis-aligned crop, then the rotation.

The operations and their order are the reference's, in float32 (TF32 off),
so the results agree to float32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from head_detector_tpu_torch.device import exact_float32, resolve_device


def invert_affine(mat: np.ndarray) -> np.ndarray:
    """Invert [..., 2, 3] forward affine matrices (dst = M @ [src, 1])."""
    mat = np.asarray(mat, np.float64)
    a = mat[..., :2, :2]
    t = mat[..., :2, 2]
    inv_a = np.linalg.inv(a)
    inv_t = -np.einsum("...ij,...j->...i", inv_a, t)
    return np.concatenate([inv_a, inv_t[..., None]], axis=-1).astype(np.float32)


def affine_warp(
    image: torch.Tensor,  # [H, W, C] float or uint8
    inv_matrices: torch.Tensor,  # [N, 2, 3] dst -> src
    out_h: int,
    out_w: int,
    fill_value: float = 0.0,
) -> torch.Tensor:
    """Warp one image into N crops: [N, out_h, out_w, C] float32."""
    h, w = image.shape[0], image.shape[1]
    img = image.to(torch.float32)
    dev = img.device
    inv = inv_matrices.to(device=dev, dtype=torch.float32)

    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev),
                            indexing="ij")  # [out_h, out_w]
    a = inv[:, :, :2, None, None]  # [N, 2, 2, 1, 1]
    t = inv[:, :, 2, None, None]  # [N, 2, 1, 1]
    sx = a[:, 0, 0] * gx + a[:, 0, 1] * gy + t[:, 0]
    sy = a[:, 1, 0] * gx + a[:, 1, 1] * gy + t[:, 1]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def sample(yi, xi):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        vals = img[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(inside[..., None], vals, fill_value)

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def scaled_crops_matmul(
    image: torch.Tensor,  # [H, W, C]
    boxes_xyxy: torch.Tensor,  # [N, 4]
    out_size: int = 256,
) -> torch.Tensor:
    """Axis-aligned bilinear crops [N, out_size, out_size, C] (edge-clamped):
    ``W_y @ image @ W_x^T`` with ``W[i, s] = max(0, 1 - |src(i) - s|)``."""
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    boxes = boxes_xyxy.to(device=dev, dtype=torch.float32)

    def weights(lo, hi, src_len):  # [N, out_size, src_len]
        scale = (hi - lo) / out_size
        steps = torch.arange(out_size, device=dev, dtype=torch.float32)
        centers = lo[:, None] + (steps + 0.5) * scale[:, None] - 0.5
        centers = torch.clamp(centers, 0.0, src_len - 1.0)
        grid = torch.arange(src_len, dtype=torch.float32, device=dev)
        return torch.clamp(1.0 - torch.abs(centers[..., None] - grid), min=0.0)

    wy = weights(boxes[:, 1], boxes[:, 3], h)
    wx = weights(boxes[:, 0], boxes[:, 2], w)
    img = image.to(torch.float32)
    with exact_float32():
        rows = torch.einsum("nih,hwc->niwc", wy, img)  # [N, S, W, C]
        return torch.einsum("njw,niwc->nijc", wx, rows)  # [N, S, S, C]


def _shear_lines(img: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Resample every line (n, l) of ``img`` [N, L, S, C] at ``x +
    offsets[n, l]`` (bilinear, zero outside): a per-line translation is a
    Toeplitz operator, so it is applied as real DFT -> multiply by the
    two-tap kernel's transform -> inverse DFT, all matrix products, on lines
    zero-padded to 2S so the circular wrap lands in the padding."""
    n, l, s, c = img.shape
    dev = img.device
    p = 2 * s
    freqs = np.arange(p // 2 + 1)
    w_np = 2.0 * np.pi * freqs / p  # [F]
    ang = np.outer(np.arange(p), w_np)  # [P, F]
    # inverse basis with the Hermitian doubling (nu = 0 and Nyquist once)
    hermitian = np.ones(p // 2 + 1)
    hermitian[1:-1] = 2.0

    def basis(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    cosb, sinb = basis(np.cos(ang)), basis(np.sin(ang))
    icos = basis((np.cos(ang) * hermitian[None]).T / p)  # [F, P]
    isin = basis((np.sin(ang) * hermitian[None]).T / p)
    w = basis(w_np)

    lines = img.permute(0, 1, 3, 2).reshape(n * l * c, s).to(torch.float32)
    lines = torch.nn.functional.pad(lines, (0, p - s))
    o = offsets[:, :, None].expand(n, l, c).reshape(n * l * c)
    o = torch.clamp(o, -float(s), float(s))  # out-of-range lines read only zeros
    k = torch.floor(o)
    f = (o - k)[:, None]

    with exact_float32():
        re = lines @ cosb  # [M, F]
        im = -(lines @ sinb)
        pk = k[:, None] * w[None, :]
        kr = (1.0 - f) * torch.cos(pk) + f * torch.cos(pk + w[None, :])
        ki = (1.0 - f) * torch.sin(pk) + f * torch.sin(pk + w[None, :])
        rre = re * kr - im * ki
        rim = re * ki + im * kr
        out = rre @ icos - rim @ isin  # [M, P]
    out = out[:, :s].reshape(n, l, c, s)
    return out.permute(0, 1, 3, 2).to(img.dtype)


def rotate_crops_matmul(crops: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """Rotate square crops [N, S, S, C] about their centres by ``angles_deg``
    [N] (counter-clockwise, cv2's convention): the nearest quarter turn
    exactly, then ``ShearX(-tan(t/2)) . ShearY(sin t) . ShearX(-tan(t/2))``
    for the residual |t| <= 45 degrees; pixels from outside are zero."""
    n, s = crops.shape[0], crops.shape[1]
    dev = crops.device
    t = torch.deg2rad(angles_deg.to(device=dev, dtype=torch.float32))
    rel = torch.arange(s, dtype=torch.float32, device=dev) - (s - 1) / 2.0  # [S]

    q = torch.round(t / (np.pi / 2.0))
    t = t - q * (np.pi / 2.0)
    qm = torch.remainder(q.to(torch.int32), 4)[:, None, None, None]
    c0 = crops.to(torch.float32)
    c1 = torch.rot90(c0, 1, dims=(1, 2))
    c2 = torch.rot90(c0, 2, dims=(1, 2))
    c3 = torch.rot90(c0, 3, dims=(1, 2))
    crops = torch.where(qm == 0, c0, torch.where(qm == 1, c1, torch.where(qm == 2, c2, c3)))

    alpha = -torch.tan(t / 2.0)  # x-shear: source offset per y
    beta = torch.sin(t)  # y-shear: source offset per x

    def shear_x(img, factor):  # rows are the lines
        return _shear_lines(img, factor[:, None] * rel[None, :])

    def shear_y(img, factor):  # columns are the lines
        out = _shear_lines(img.transpose(1, 2), factor[:, None] * rel[None, :])
        return out.transpose(1, 2)

    out = shear_x(crops, alpha)
    out = shear_y(out, beta)
    return shear_x(out, alpha)


def aligned_crops_matmul(
    image: torch.Tensor,  # [H, W, C]
    boxes_xyxy: torch.Tensor,  # [N, 4]
    angles_deg: torch.Tensor,  # [N] roll per box
    out_size: int = 256,
    margin: float = 1.5,
) -> torch.Tensor:
    """Roll-aligned square crops: the box grown to a square of ``margin``
    times its long side (>= sqrt(2) keeps the corners), cropped by
    :func:`scaled_crops_matmul`, then rotated by :func:`rotate_crops_matmul`."""
    boxes = boxes_xyxy.to(device=image.device, dtype=torch.float32)
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    half = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]) * (margin / 2)
    big = torch.stack([cx - half, cy - half, cx + half, cy + half], dim=1)
    return rotate_crops_matmul(scaled_crops_matmul(image, big, out_size=out_size), angles_deg)


def warp_like_cv2(
    image: np.ndarray, forward_mat: np.ndarray, dsize: Tuple[int, int], device="cuda"
) -> np.ndarray:
    """``cv2.warpAffine(image, M, dsize)`` (INTER_LINEAR, BORDER_CONSTANT 0)
    for one crop, on ``device``; dsize is (width, height)."""
    dev = resolve_device(device)
    inv = torch.as_tensor(invert_affine(np.asarray(forward_mat)[None]), device=dev)
    out = affine_warp(torch.as_tensor(image, device=dev), inv, dsize[1], dsize[0])
    out = out[0].cpu().numpy()
    if image.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out
