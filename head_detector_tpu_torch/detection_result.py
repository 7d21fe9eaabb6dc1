"""PredictionResult: the detector's per-image output, its PNCC render,
drawings, roll-aligned head crops and OBJ export.

Counterpart of ``head_detector_tpu/detection_result.py``.  PNCC processors
are shared per device; the mesh saver is shared by all results.  The OBJ
writer is the Python one (float64 through ``"%.8f"``, 1-based faces, the
face block rendered once), byte-identical to the reference's.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List

import numpy as np
import torch

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.draw_utils import (
    draw_2d_landmarks,
    draw_3d_landmarks,
    draw_bboxes,
    draw_pose,
)
from head_detector_tpu_torch.head_info import HeadMetadata
from head_detector_tpu_torch.utils import (
    extend_bbox,
    extend_to_rect,
    refined_head_bbox,
    vertically_align,
)

DRAW_MAPPING = {
    "landmarks": [draw_3d_landmarks],
    "points": [draw_2d_landmarks],
    "pose": [draw_pose],
    "full": [draw_bboxes, draw_3d_landmarks],
    "bbox": [draw_bboxes],
}
MAX_YAW = 60


class MeshSaver:
    """OBJ writer: ``v %.8f %.8f %.8f`` lines in float64, then the mesh's
    faces as 1-based ``f a b c`` lines (rendered once, shared by every file)."""

    def __init__(self) -> None:
        triangles = load_flame_assets().faces.astype(np.int64) + 1
        self._faces_block = "".join("f %d %d %d\n" % tuple(face) for face in triangles)

    def __call__(self, vertices: np.ndarray, output_path: str) -> None:
        self.save_many(np.asarray(vertices, np.float64)[None], [output_path])

    def save_many(self, vertices: np.ndarray, paths: list) -> None:
        """Write vertices[i] and the face block to paths[i]."""
        for verts, path in zip(np.asarray(vertices, np.float64), paths):
            body = ("v %.8f %.8f %.8f\n" * len(verts)) % tuple(verts.ravel())
            with open(path, "w") as f:
                f.write(body)
                f.write(self._faces_block)


_PNCC: Dict[str, object] = {}


def _pncc_processor(device: torch.device):
    key = str(device)
    if key not in _PNCC:
        from head_detector_tpu_torch.pncc import PNCCProcessor

        _PNCC[key] = PNCCProcessor(device=device)
    return _PNCC[key]


@functools.lru_cache(maxsize=1)
def _mesh_saver() -> MeshSaver:
    return MeshSaver()


class PredictionResult:
    def __init__(self, original_image: np.ndarray, heads: List[HeadMetadata],
                 device="cuda"):
        self.original_image = original_image
        self.heads = heads
        self.device = torch.device(device)

    @property
    def pncc_processor(self):
        return _pncc_processor(self.device)

    @property
    def mesh_saver(self) -> MeshSaver:
        return _mesh_saver()

    def draw(self, method: str = "full") -> np.ndarray:
        """A copy of the image with every head drawn by ``method`` (a key of
        ``DRAW_MAPPING``)."""
        image = self.original_image.copy()
        for head in self.heads:
            for draw_method in DRAW_MAPPING[method]:
                image = draw_method(image, head)
        return image

    def get_pncc(self) -> np.ndarray:
        """PNCC map of all heads, rendered on the detector's device."""
        return self.pncc_processor(self.original_image, self.heads)

    def get_aligned_heads(self) -> List[np.ndarray]:
        """One square crop per head, the image rotated by the head's roll
        about its skull centre first unless |yaw| >= 60 degrees."""
        head_images = []
        for head in self.heads:
            head_image = self.original_image.copy()
            vertices = head.vertices_3d
            if np.abs(head.head_pose.yaw) < MAX_YAW:
                head_image, vertices = vertically_align(
                    head_image, vertices, head.flame_params, head.head_pose.roll
                )
            box = refined_head_bbox(vertices)
            x, y, w, h = extend_to_rect(extend_bbox([box.x, box.y, box.w, box.h], offset=0.1))
            head_images.append(head_image[y : y + h, x : x + w])
        return head_images

    def save_meshes(self, save_folder: str) -> None:
        """``head_<i>.obj`` in ``save_folder`` for every head."""
        os.makedirs(save_folder, exist_ok=True)
        self.mesh_saver.save_many(
            [head.vertices_3d for head in self.heads],
            [os.path.join(save_folder, f"head_{i}.obj") for i in range(len(self.heads))],
        )

    def __repr__(self) -> str:
        return (
            f"PredictionResult(original_image={self.original_image.shape}, "
            f"num heads={len(self.heads)})"
        )
