"""PNCC (Projected Normalized Coordinate Code) rendering.

Counterpart of ``head_detector_tpu/pncc.py``: per head, flip z, rasterize the
head_w_ears triangle subset colored by the min-max-normalised template
coordinates, and composite the nonzero pixels onto an accumulating canvas.

All heads of an image render in ONE ``pncc_render`` call, each with its own
z-buffer, and are composited in head order on the rendering device with the
reference's rule ``mask = current.sum(2) != 0`` (a hit pixel whose uint8
color is 0 does not overwrite an earlier head); one uint8 canvas comes back
to the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.device import resolve_device
from head_detector_tpu_torch.head_info import HeadMetadata
from head_detector_tpu_torch.ops.rasterize import pncc_render, rasterize_zbuffer


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


class PNCCProcessor:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        assets = load_flame_assets()
        self.indices = assets.head_w_ears_indices
        inside = np.isin(assets.faces, self.indices).all(axis=1)
        self.triangles = assets.faces[inside].astype(np.int32)
        self.colors = compute_ncc_color_codes(
            assets.v_template.astype(np.float64), self.indices
        )
        self._triangles = torch.as_tensor(self.triangles, device=self.device)
        self._colors = torch.as_tensor(
            self.colors.astype(np.float32), device=self.device
        )

    def _camera_facing(self, heads: List[HeadMetadata]) -> torch.Tensor:
        """[N, V, 3] meshes with the depth flipped (on a copy of each head)."""
        verts = np.stack([np.asarray(h.vertices_3d, np.float32) for h in heads])
        verts[:, :, 2] *= -1
        return torch.as_tensor(verts, device=self.device)

    def render(self, heads: List[HeadMetadata], height: int, width: int):
        """The float canvases, all heads in one launch ->
        (canvas [N, H, W, 3], hit [N, H, W]) numpy."""
        canvas, hit = rasterize_zbuffer(
            self._camera_facing(heads), self._triangles, self._colors,
            height=height, width=width,
        )
        return canvas.cpu().numpy(), hit.cpu().numpy()

    def __call__(self, image: np.ndarray, heads: List[HeadMetadata]) -> np.ndarray:
        if not heads:
            return np.zeros_like(image)
        rgb = pncc_render(
            self._camera_facing(heads), self._triangles, self._colors,
            height=image.shape[0], width=image.shape[1],
        ).cpu().numpy()
        pncc_image = np.zeros_like(image)
        pncc_image[..., :3] = rgb
        return pncc_image
