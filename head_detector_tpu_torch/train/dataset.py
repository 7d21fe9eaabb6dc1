"""Synthetic head scenes and the training collate.

Counterpart of ``head_detector_tpu/train/dataset.py``'s
``SyntheticHeadsDataset``, ``collate_samples`` and the flat collate pair.
The same seeded draws in the same order give the same heads (1..max_heads
random FLAME heads on a dim noise background), decoded with the port's
``reproject_spatial_vertices`` on the dataset's device and, with
``render=True``, drawn with the port's rasterizer: all heads of a scene in
one ``rasterize_zbuffer`` launch with a z-buffer each, composited in head
order on the host.  The samples are host numpy; ``__getitem__`` is called
from loader threads (``runner._Prefetcher``), so every table it shares is
made under a lock.  ``DAD3DHeadsDataset`` (the on-disk VGGHeads format) is
not ported.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.device import resolve_device
from head_detector_tpu_torch.flame import FlameModel, reproject_spatial_vertices
from head_detector_tpu_torch.ops.rasterize import rasterize_zbuffer
from head_detector_tpu_torch.pncc import compute_ncc_color_codes
from head_detector_tpu_torch.train.loss import Targets
from head_detector_tpu_torch.train.mesh_sample import MeshEstimationSample


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


_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()


def scene_tables(device: torch.device):
    """(triangles [F, 3] int32, colors [V, 3] float32) of the full FLAME mesh
    on ``device``, made once per device (under a lock: loader threads ask
    for it at once): the same tensors go to the rasterizer in every call, so
    it checks the table's index range once."""
    device = torch.device(device)
    with _TABLES_LOCK:
        if device not in _TABLES:
            assets = load_flame_assets()
            colors = compute_ncc_color_codes(assets.v_template.astype(np.float64))
            _TABLES[device] = (
                torch.as_tensor(assets.faces.astype(np.int32), device=device),
                torch.as_tensor(colors.astype(np.float32), device=device))
        return _TABLES[device]


def scene_vertices(params: np.ndarray, flame_model: FlameModel) -> torch.Tensor:
    """[n, V, 3] projected meshes of the scene's heads, depth facing the
    camera like the PNCC path."""
    _, _, proj = reproject_spatial_vertices(
        flame_model, torch.as_tensor(params, device=flame_model.device), to_2d=False
    )
    return _camera_facing(proj)


def _camera_facing(proj: torch.Tensor) -> torch.Tensor:
    verts = proj.clone()
    verts[:, :, 2] *= -1
    return verts


def _draw_heads(image: np.ndarray, verts: torch.Tensor) -> np.ndarray:
    """The heads ``verts`` [n, V, 3] (camera-facing depth) drawn over
    ``image`` in head order: one launch, one download."""
    size_h, size_w = image.shape[:2]
    triangles, colors = scene_tables(verts.device)
    canvas, hit = rasterize_zbuffer(verts, triangles, colors, height=size_h, width=size_w)
    canvas, hit = canvas.cpu().numpy(), hit.cpu().numpy()
    for i in range(verts.shape[0]):
        image = np.where(
            hit[i][..., None],
            np.clip(canvas[i] * 255.0, 0, 255).astype(np.uint8),
            image,
        )
    return image


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
    return _draw_heads(image, scene_vertices(params, flame_model))


class SyntheticHeadsDataset:
    """Procedural dataset: random FLAME heads as GT.  ``render=False`` pairs
    the GT with noise images; ``render=True`` rasterizes every head's mesh
    (NCC colors) onto the image with the port's kernel, a learnable task.
    Rendered samples are cached (they are deterministic in (seed, index)),
    so epochs after the first do not render again."""

    def __init__(self, flame_model: Optional[FlameModel] = None, image_size: int = 640,
                 length: int = 1024, max_heads: int = 3, seed: int = 0,
                 render: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.flame_model = flame_model or FlameModel.from_assets(device=self.device)
        self.image_size = image_size
        self.length = length
        self.max_heads = max_heads
        self.seed = seed
        self.render = render
        self._cache: dict = {}

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> MeshEstimationSample:
        index = int(index)
        if self.render and index in self._cache:
            return self._cache[index]
        sample = self._make_sample(index)
        if self.render:
            self._cache[index] = sample
        return sample

    def _make_sample(self, index: int) -> MeshEstimationSample:
        s = self.image_size
        params, rng = scene_params(self.seed, index, s, self.max_heads)
        n = params.shape[0]
        verts_t, rots_t, proj_t = reproject_spatial_vertices(
            self.flame_model, torch.as_tensor(params, device=self.flame_model.device),
            to_2d=False)
        verts, rots, proj = (x.cpu().numpy() for x in (verts_t, rots_t, proj_t))

        joints = np.concatenate(
            [proj[..., :2], np.ones((n, proj.shape[1], 1), np.float32)], axis=-1)
        x1, y1 = proj[..., 0].min(1), proj[..., 1].min(1)
        x2, y2 = proj[..., 0].max(1), proj[..., 1].max(1)
        bboxes = np.stack([x1, y1, x2 - x1, y2 - y1], axis=1).astype(np.float32)

        image = (rng.rand(s, s, 3) * 60 + 40).astype(np.uint8)  # dim background
        if self.render:
            image = _draw_heads(image, _camera_facing(proj_t))

        return MeshEstimationSample(
            image=image,
            vertices_2d=joints,
            vertices_3d=verts,
            rotation_matrix=rots,
            areas=bboxes[:, 2] * bboxes[:, 3],
            bboxes_xywh=bboxes,
            is_crowd=np.zeros(n, bool),
        ).sanitize_sample()


# --------------------------------------------------------------------------- #
# Collate
# --------------------------------------------------------------------------- #


def collate_samples(samples: Sequence[MeshEstimationSample],
                    max_boxes: int) -> Tuple[np.ndarray, Targets]:
    """Stack the images and pad every image's GT to ``max_boxes`` -> (uint8
    images [B, H, W, 3], ``Targets`` of float32 numpy arrays)."""
    b = len(samples)
    k = samples[0].vertices_2d.shape[1] if len(samples[0].vertices_2d) else 5023
    v = samples[0].vertices_3d.shape[1] if len(samples[0].vertices_3d) else 5023

    images = np.stack([s.image for s in samples])
    gt_bboxes = np.zeros((b, max_boxes, 4), np.float32)
    gt_v2d = np.zeros((b, max_boxes, k, 3), np.float32)
    gt_v3d = np.zeros((b, max_boxes, v, 3), np.float32)
    gt_rot = np.tile(np.eye(3, dtype=np.float32), (b, max_boxes, 1, 1))
    mask = np.zeros((b, max_boxes, 1), np.float32)

    for i, s in enumerate(samples):
        n = min(len(s.bboxes_xywh), max_boxes)
        if n == 0:
            continue
        xywh = s.bboxes_xywh[:n]
        gt_bboxes[i, :n, 0] = xywh[:, 0]
        gt_bboxes[i, :n, 1] = xywh[:, 1]
        gt_bboxes[i, :n, 2] = xywh[:, 0] + xywh[:, 2]
        gt_bboxes[i, :n, 3] = xywh[:, 1] + xywh[:, 3]
        gt_v2d[i, :n] = s.vertices_2d[:n]
        gt_v3d[i, :n] = s.vertices_3d[:n]
        gt_rot[i, :n] = s.rotation_matrix[:n]
        mask[i, :n] = 1.0

    return images, Targets(gt_bboxes=gt_bboxes, gt_vertices_2d=gt_v2d,
                           gt_vertices_3d=gt_v3d, gt_rotations=gt_rot, pad_gt_mask=mask)


def flat_collate_tensors_with_batch_index(tensors: Sequence[np.ndarray]) -> np.ndarray:
    """Concat per-image tensors with a leading batch-index column (the
    reference's flat wire format)."""
    out = []
    for i, t in enumerate(tensors):
        idx = np.full(t.shape[:-1] + (1,), i, t.dtype)
        out.append(np.concatenate([idx, t], axis=-1))
    return np.concatenate(out, axis=0) if out else np.zeros((0, 1))


def undo_flat_collate_tensors_with_batch_index(flat: np.ndarray,
                                               batch_size: int) -> List[np.ndarray]:
    first_col = flat.reshape(flat.shape[0], -1)[:, 0]
    return [flat[first_col == i][..., 1:] for i in range(batch_size)]



