"""Synthetic head scenes: the image half of the JAX package's
``SyntheticHeadsDataset._make_sample`` with ``render=True``.

The same seeded draws in the same order give the same heads (1..max_heads
random FLAME heads on a dim noise background), decoded with the port's
``reproject_spatial_vertices`` and drawn with the port's rasterizer, all
heads in one launch with a z-buffer each, composited in head order.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.device import resolve_device
from head_detector_tpu_torch.flame import FlameModel, reproject_spatial_vertices
from head_detector_tpu_torch.ops.rasterize import rasterize_zbuffer
from head_detector_tpu_torch.pncc import compute_ncc_color_codes


def scene_params(seed: int, index: int, size: int = 640, max_heads: int = 3):
    """(FLAME params [n, 413] float32, the RandomState after drawing them)."""
    rng = np.random.RandomState(seed * 100003 + index)
    n = rng.randint(1, max_heads + 1)
    params = rng.randn(n, 413).astype(np.float32) * 0.1
    params[:, 409] = rng.uniform(0.2 * size, 0.8 * size, n)  # tx
    params[:, 410] = rng.uniform(0.2 * size, 0.8 * size, n)  # ty
    params[:, 411] = 0.0
    params[:, 412] = rng.uniform(0.2 * size, 0.6 * size, n)  # scale (pixels)
    return params, rng


@functools.lru_cache(maxsize=None)
def scene_tables(device: torch.device):
    """(triangles [F, 3] int32, colors [V, 3] float32) of the full FLAME mesh
    on ``device``, made once per device: the same tensors go to the rasterizer
    in every call, so it checks the table's index range once."""
    assets = load_flame_assets()
    colors = compute_ncc_color_codes(assets.v_template.astype(np.float64))
    return (torch.as_tensor(assets.faces.astype(np.int32), device=device),
            torch.as_tensor(colors.astype(np.float32), device=device))


def scene_vertices(params: np.ndarray, flame_model: FlameModel) -> torch.Tensor:
    """[n, V, 3] projected meshes of the scene's heads, depth facing the
    camera like the PNCC path."""
    _, _, proj = reproject_spatial_vertices(
        flame_model, torch.as_tensor(params, device=flame_model.device), to_2d=False
    )
    verts = proj.clone()
    verts[:, :, 2] *= -1
    return verts


def render_scene(
    seed: int,
    index: int,
    size: int = 640,
    max_heads: int = 3,
    device="cuda",
    flame_model: Optional[FlameModel] = None,
) -> np.ndarray:
    """uint8 [size, size, 3] scene ``index`` of the dataset seeded ``seed``."""
    dev = resolve_device(device)
    flame_model = flame_model or FlameModel.from_assets(device=dev)
    params, rng = scene_params(seed, index, size, max_heads)
    image = (rng.rand(size, size, 3) * 60 + 40).astype(np.uint8)

    triangles, colors = scene_tables(dev)
    canvas, hit = rasterize_zbuffer(
        scene_vertices(params, flame_model), triangles, colors, height=size, width=size
    )
    canvas, hit = canvas.cpu().numpy(), hit.cpu().numpy()
    for i in range(len(params)):
        image = np.where(
            hit[i][..., None],
            np.clip(canvas[i] * 255.0, 0, 255).astype(np.uint8),
            image,
        )
    return image
