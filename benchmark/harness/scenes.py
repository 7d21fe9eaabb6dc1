"""The benchmark's one traffic generator: rendered scenes of FLAME heads.

A frozen copy of the port's synthetic scenes (``train/dataset.py``
``scene_params`` / ``render_scene`` / ``SyntheticHeadsDataset``): 1 to
``max_heads`` random FLAME heads a scene, placed and sized in proportion to
the canvas, drawn in head order over a dim noise background with NCC
colours.  The draws are keyed by ``(seed, index)`` through numpy's seed
sequence, so any whole seed works and a scene does not depend on the others;
the backgrounds come from one generator on the device.  The meshes are
decoded by the reference's FLAME model and drawn by its plain z-buffer, so
no change to the port's renderer can move the inputs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from benchmark.reference.assets_io import load_flame_assets
from benchmark.reference.flame import FlameModel, reproject_spatial_vertices
from benchmark.reference.raster import compute_ncc_color_codes, rasterize_zbuffer_plain

HEADS_PER_RASTER_CALL = 32


def scene_params(seed: int, index: int, size: int, max_heads: int) -> np.ndarray:
    """FLAME params [n, 413] float32 of scene ``index``."""
    rng = np.random.default_rng([int(seed), int(index)])
    n = int(rng.integers(1, max_heads + 1))
    params = rng.standard_normal((n, 413)).astype(np.float32) * 0.1
    params[:, 409] = rng.uniform(0.2 * size, 0.8 * size, n)  # tx
    params[:, 410] = rng.uniform(0.2 * size, 0.8 * size, n)  # ty
    params[:, 411] = 0.0
    params[:, 412] = rng.uniform(0.2 * size, 0.6 * size, n)  # scale (pixels)
    return params


class Scenes:
    """``count`` scenes of ``size`` px: uint8 images [count, size, size, 3]
    on ``device`` and, per scene, its heads' params and decoded meshes."""

    def __init__(self, seed: int, count: int, size: int, max_heads: int, device):
        device = torch.device(device)
        self.size = size
        self.params: List[np.ndarray] = [scene_params(seed, i, size, max_heads)
                                         for i in range(count)]
        flame = FlameModel.from_assets(device=device)
        flat = torch.as_tensor(np.concatenate(self.params), device=device)
        with torch.no_grad():
            canonical, rotations, projected = reproject_spatial_vertices(flame, flat,
                                                                         to_2d=False)
        self.canonical, self.rotations, self.projected = canonical, rotations, projected
        counts = [len(p) for p in self.params]
        self.first = np.concatenate([[0], np.cumsum(counts)]).astype(int)

        gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
        background = torch.rand((count, size, size, 3), generator=gen, device=device)
        self.images = (background * 60 + 40).to(torch.uint8)
        self._draw(device)

    def _draw(self, device) -> None:
        """Each scene's heads over its background, in head order (a later
        head covers an earlier one where both hit, as the port's scenes)."""
        assets = load_flame_assets()
        triangles = torch.as_tensor(assets.faces.astype(np.int32), device=device)
        colors = torch.as_tensor(
            compute_ncc_color_codes(assets.v_template.astype(np.float64)).astype(np.float32),
            device=device)
        facing = self.projected.clone()
        facing[:, :, 2] *= -1
        total = facing.shape[0]
        owner = np.repeat(np.arange(len(self.params)), np.diff(self.first))
        for start in range(0, total, HEADS_PER_RASTER_CALL):
            stop = min(start + HEADS_PER_RASTER_CALL, total)
            canvas, hit = rasterize_zbuffer_plain(facing[start:stop], triangles, colors,
                                                  self.size, self.size)
            c8 = torch.clamp(canvas * 255.0, 0, 255).to(torch.uint8)
            for j in range(stop - start):
                image = self.images[owner[start + j]]
                image[hit[j]] = c8[j][hit[j]]

    def __len__(self) -> int:
        return len(self.params)

    def heads(self, index: int) -> slice:
        return slice(self.first[index], self.first[index + 1])

    def host_images(self) -> np.ndarray:
        return self.images.cpu().numpy()

    def targets(self, indices, max_boxes: int):
        """Padded GT of scenes ``indices`` (as ``collate_samples`` pads the
        synthetic samples after ``sanitize_sample``): float32 tensors on the
        scenes' device, (boxes [B, N, 4] xyxy, vertices_2d [B, N, V, 3],
        vertices_3d [B, N, V, 3], rotations [B, N, 3, 3], mask [B, N, 1])."""
        dev = self.images.device
        b, v, s = len(indices), self.projected.shape[1], self.size
        boxes = torch.zeros((b, max_boxes, 4), device=dev)
        v2d = torch.zeros((b, max_boxes, v, 3), device=dev)
        v3d = torch.zeros((b, max_boxes, v, 3), device=dev)
        rot = torch.eye(3, device=dev).repeat(b, max_boxes, 1, 1)
        mask = torch.zeros((b, max_boxes, 1), device=dev)
        for i, index in enumerate(indices):
            sl = self.heads(index)
            proj = self.projected[sl][:, :, :2]
            n = min(proj.shape[0], max_boxes)
            proj = proj[:n]
            lo, hi = proj.amin(1), proj.amax(1)
            boxes[i, :n, :2] = torch.clamp(lo, 0, s)
            boxes[i, :n, 2:] = torch.clamp(hi, 0, s)
            inside = ((proj >= 0) & (proj < s)).all(-1)
            v2d[i, :n, :, :2] = proj
            v2d[i, :n, :, 2] = inside.to(torch.float32)
            v3d[i, :n] = self.canonical[sl][:n]
            rot[i, :n] = self.rotations[sl][:n]
            mask[i, :n] = 1.0
        return boxes, v2d, v3d, rot, mask


def batches(scenes: Scenes, batch: int, max_boxes: int) -> List[Tuple[torch.Tensor, tuple]]:
    """The scenes cut into whole batches of (uint8 images, targets)."""
    out = []
    for start in range(0, len(scenes) - batch + 1, batch):
        idx = list(range(start, start + batch))
        out.append((scenes.images[start:start + batch], scenes.targets(idx, max_boxes)))
    return out
