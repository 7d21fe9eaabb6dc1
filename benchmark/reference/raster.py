"""Plain z-buffer rasterizer and PNCC composite of the reference.

Frozen copies of the port's plain torch versions (``ops/rasterize.py``
``rasterize_zbuffer_plain`` / ``pncc_render_plain``, ``pncc.py``
``compute_ncc_color_codes``): the yardstick of the port's CUDA kernel and
the renderer of the benchmark's scenes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_DEPTH = -1e8
_EMPTY = torch.iinfo(torch.int64).min  # key of a pixel no triangle covers
_LOW_MASK = 0xFFFFFFFF
_CANDIDATES_PER_CHUNK = 1 << 22


def _triangle_setup(tv: torch.Tensor):
    """Per-triangle terms of the weight formula; ``tv`` is [..., 3, 3]."""
    p0, p1, p2 = tv[..., 0, :2], tv[..., 1, :2], tv[..., 2, :2]
    v0 = p2 - p0
    v1 = p1 - p0
    v0x, v0y, v1x, v1y = v0[..., 0], v0[..., 1], v1[..., 0], v1[..., 1]
    dot00 = v0x * v0x + v0y * v0y
    dot01 = v0x * v1x + v0y * v1y
    dot11 = v1x * v1x + v1y * v1y
    deno = dot00 * dot11 - dot01 * dot01
    degenerate = deno <= 1e-6 * dot00 * dot11
    inver = torch.where(
        degenerate, torch.zeros_like(deno), 1.0 / torch.where(degenerate, 1.0, deno)
    )
    return {
        "p0x": p0[..., 0], "p0y": p0[..., 1],
        "v0x": v0x, "v0y": v0y, "v1x": v1x, "v1y": v1y,
        "dot00": dot00, "dot01": dot01, "dot11": dot11,
        "inver": inver, "degenerate": degenerate,
    }


def _point_weights(s, px: torch.Tensor, py: torch.Tensor):
    """(w0, w1, w2) at pixels (px, py) for per-pixel triangle terms ``s``."""
    v2x = px - s["p0x"]
    v2y = py - s["p0y"]
    dot02 = s["v0x"] * v2x + s["v0y"] * v2y
    dot12 = s["v1x"] * v2x + s["v1y"] * v2y
    u = (s["dot11"] * dot02 - s["dot01"] * dot12) * s["inver"]
    v = (s["dot00"] * dot12 - s["dot01"] * dot02) * s["inver"]
    return 1.0 - u - v, v, u


def _depth_key(depth: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Signed int64 key ordered like (depth, -tri): the unsigned key of the
    CUDA kernel minus 2**63."""
    bits = (depth + 0.0).view(torch.int32)  # + 0.0 maps -0 to +0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return ordered * (1 << 32) + (_LOW_MASK - tri.to(torch.int64))


def rasterize_zbuffer_plain(
    vertices: torch.Tensor,  # [N, V, 3] float32 (x, y, depth) in pixels
    triangles: torch.Tensor,  # [F, 3] int
    colors: torch.Tensor,  # [V, 3] float32
    height: int,
    width: int,
    reverse: bool = False,
):
    """Plain torch version: returns (color [N, H, W, 3], hit [N, H, W])."""
    n = vertices.shape[0]
    nf = triangles.shape[0]
    dev = vertices.device
    hw = height * width
    keys = torch.full((n * hw,), _EMPTY, dtype=torch.int64, device=dev)
    tri = triangles.to(device=dev, dtype=torch.int64)
    tv = vertices.to(torch.float32)[:, tri]  # [N, F, 3, 3]
    setup = {k: v.reshape(-1) for k, v in _triangle_setup(tv).items()}  # [N*F]

    if n * nf:
        xs, ys = tv[..., 0], tv[..., 1]
        x0 = torch.ceil(xs.amin(-1)).clamp(min=0.0).reshape(-1)
        x1 = torch.floor(xs.amax(-1)).clamp(max=width - 1.0).reshape(-1)
        y0 = torch.ceil(ys.amin(-1)).clamp(min=0.0).reshape(-1)
        y1 = torch.floor(ys.amax(-1)).clamp(max=height - 1.0).reshape(-1)
        live = ((x0 <= x1) & (y0 <= y1) & ~setup["degenerate"]).nonzero()[:, 0]
        x0, y0 = x0[live].to(torch.int64), y0[live].to(torch.int64)
        bw = x1[live].to(torch.int64) - x0 + 1
        counts = bw * (y1[live].to(torch.int64) - y0 + 1)
        cum = counts.cumsum(0)
        start = 0
        while start < live.numel():
            base = int(cum[start - 1]) if start else 0
            end = int(torch.searchsorted(cum, base + _CANDIDATES_PER_CHUNK, right=True))
            end = max(end, start + 1)
            c = counts[start:end]
            owner = torch.repeat_interleave(torch.arange(end - start, device=dev), c)
            offs = torch.arange(owner.numel(), device=dev) - (cum[start:end] - c - base)[owner]
            owner = owner + start
            px = x0[owner] + offs % bw[owner]
            py = y0[owner] + offs // bw[owner]
            pair = live[owner]  # head * F + triangle
            s = {k: v[pair] for k, v in setup.items()}
            w0, w1, w2 = _point_weights(s, px.to(torch.float32), py.to(torch.float32))
            corners = tv.reshape(-1, 3, 3)[pair, :, 2]
            depth = w0 * corners[:, 0] + w1 * corners[:, 1] + w2 * corners[:, 2]
            ok = (w0 > 0) & (w1 > 0) & (w2 > 0) & (depth > NEG_DEPTH)
            head = pair // nf
            pix = head * hw + py * width + px
            keys.scatter_reduce_(
                0, pix[ok], _depth_key(depth[ok], (pair % nf)[ok]), reduce="amax"
            )
            start = end

    keys = keys.reshape(n, height, width)
    if reverse:
        keys = keys.flip(1)
    hit = keys != _EMPTY
    canvas = torch.zeros((n, height, width, 3), dtype=torch.float32, device=dev)
    head, row, col = hit.nonzero(as_tuple=True)
    win = _LOW_MASK - (keys[head, row, col] & _LOW_MASK)
    src_row = (height - 1 - row) if reverse else row
    s = {k: v[head * nf + win] for k, v in setup.items()}
    w0, w1, w2 = _point_weights(s, col.to(torch.float32), src_row.to(torch.float32))
    corner = tri[win]  # [P, 3]
    cols = colors.to(device=dev, dtype=torch.float32)
    canvas[head, row, col] = (
        w0[:, None] * cols[corner[:, 0]]
        + w1[:, None] * cols[corner[:, 1]]
        + w2[:, None] * cols[corner[:, 2]]
    )
    return canvas, hit


def pncc_render_plain(
    vertices: torch.Tensor,  # [N, V, 3] float32
    triangles: torch.Tensor,  # [F, 3] int
    colors: torch.Tensor,  # [V, 3] float32
    height: int,
    width: int,
) -> torch.Tensor:
    """Plain torch version of ``pncc_render``: ``rasterize_zbuffer_plain``,
    then the composite in mesh order."""
    out = torch.zeros((height, width, 3), dtype=torch.uint8, device=vertices.device)
    if vertices.shape[0] == 0:
        return out
    canvas, hit = rasterize_zbuffer_plain(vertices, triangles, colors, height, width)
    for i in range(vertices.shape[0]):
        c8 = (255.0 * canvas[i]).to(torch.int32).to(torch.uint8)  # float32 product, truncated
        replace = hit[i] & (c8.sum(-1, dtype=torch.int32) != 0)
        out[replace] = c8[replace]
    return out


def compute_ncc_color_codes(
    template_face: np.ndarray, subset_indexes: Optional[np.ndarray] = None
) -> np.ndarray:
    """Min-max normalise template coords to unit RGB (min/max over the subset,
    each with an initial value of 0, as the reference does)."""
    if not isinstance(template_face, np.ndarray):
        raise ValueError(
            f"Argument template_face must be a numpy array, got type {type(template_face)}"
        )
    if len(template_face.shape) != 2 or template_face.shape[1] != 3:
        raise ValueError(
            f"Argument template_face must have shape [N,3], got shape {template_face.shape}"
        )
    if subset_indexes is not None and not isinstance(subset_indexes, np.ndarray):
        raise ValueError(
            f"Argument subset_indexes must be a numpy array, got type {type(subset_indexes)}"
        )
    sub = template_face[subset_indexes] if subset_indexes is not None else template_face
    u_min = sub.min(axis=0, keepdims=True, initial=0)
    u_max = sub.max(axis=0, keepdims=True, initial=0)
    return (template_face - u_min) / (u_max - u_min)
