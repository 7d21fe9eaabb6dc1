"""HeadMesh: FLAME decode helper with the DAD projection convention.

Counterpart of ``head_detector_tpu/evaluation/head_mesh.py`` over the port's
``FlameModel`` (float32, TF32 off, on the model's device):
``reprojected_vertices`` uses ``scale' = clamp(scale + 1, 1e-8)``,
``translation.z = 0`` and ``(v + 1)/2 * image_size``;
``adjust_3dmm_to_paddings`` shifts translation by ``2 * pad / image_size``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from head_detector_tpu_torch.device import exact_float32
from head_detector_tpu_torch.flame import FlameModel, flame_vertices
from head_detector_tpu_torch.head_info import FLAME_CONSTS, FlameParams


class HeadMesh:
    def __init__(
        self,
        flame_config: Optional[Dict[str, int]] = None,
        image_size: int = 256,
        flame_model: Optional[FlameModel] = None,
        device="cuda",
    ):
        """``flame_model`` decides the device; without one a model is made
        on ``device``.  Only the packed layout of ``FLAME_CONSTS`` exists."""
        if flame_config is not None and dict(flame_config) != FLAME_CONSTS:
            raise ValueError("the port's FlameParams has the FLAME_CONSTS layout only")
        self.flame_constants = FLAME_CONSTS
        self.flame = flame_model or FlameModel.from_assets(device=device)
        self._image_size = image_size

    def flame_params(self, params_3dmm: torch.Tensor) -> FlameParams:
        return FlameParams.from_3dmm(params_3dmm)

    def vertices_3d(self, params_3dmm: torch.Tensor, zero_rotation: bool = False) -> torch.Tensor:
        p = self.flame_params(params_3dmm)
        with exact_float32():
            return flame_vertices(self.flame, p, zero_rot=zero_rotation)

    def reprojected_vertices(self, params_3dmm: torch.Tensor, to_2d: bool = True) -> torch.Tensor:
        p = self.flame_params(params_3dmm)
        with exact_float32():
            verts = flame_vertices(self.flame, p, zero_rot=False)
        scale = torch.clamp(p.scale[:, None] + 1.0, min=1e-8)
        verts = verts * scale
        translation = p.translation.clone()
        translation[..., 2] = 0.0
        verts = verts + translation[:, None]
        projected = (verts + 1.0) / 2.0 * self._image_size
        return projected[..., :2] if to_2d else projected

    def adjust_3dmm_to_paddings(
        self, params_3dmm: torch.Tensor, paddings: List[int]
    ) -> torch.Tensor:
        """paddings = [pad_top, pad_bottom, pad_left, pad_right]; positive
        when the image grew, negative when cropped."""
        p = self.flame_params(params_3dmm)
        shift = torch.tensor([[paddings[2], paddings[0], 0.0]], dtype=params_3dmm.dtype,
                             device=params_3dmm.device)
        p.translation = p.translation + shift * 2.0 / self._image_size
        return p.to_3dmm_tensor()
