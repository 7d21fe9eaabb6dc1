"""MeshEstimationSample: one image + its per-head mesh annotations (host numpy).

A copy of ``head_detector_tpu/train/mesh_sample.py`` (the port imports
nothing of the JAX package).

Functional spec: reference ``yolo_head_training/yolo_head/mesh_sample.py:14-153``
(slots, ``sanitize_sample`` visibility zeroing + bbox clamping, and the
filter_by_* helpers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MeshEstimationSample:
    """
    :param image:           [H, W, 3] uint8
    :param vertices_2d:     [N, K, 3] (x, y, visibility) projected vertices
    :param vertices_3d:     [N, V, 3] canonical 3D vertices
    :param rotation_matrix: [N, 3, 3]
    :param areas:           [N]
    :param bboxes_xywh:     [N, 4]
    :param is_crowd:        [N] bool
    """

    image: np.ndarray
    vertices_2d: np.ndarray
    vertices_3d: np.ndarray
    rotation_matrix: np.ndarray
    areas: Optional[np.ndarray]
    bboxes_xywh: Optional[np.ndarray]
    is_crowd: Optional[np.ndarray]
    additional_samples: Optional[list] = None

    def compute_area_if_needed(self) -> None:
        if self.areas is None:
            self.areas = self.bboxes_xywh[:, 2] * self.bboxes_xywh[:, 3]

    def sanitize_sample(self) -> "MeshEstimationSample":
        """Zero visibility of out-of-image vertices; clamp bboxes to the image
        and rescale areas by the visible fraction (ref mesh_sample.py)."""
        image_height, image_width = self.image.shape[:2]

        outside = (
            (self.vertices_2d[:, :, 0] < 0)
            | (self.vertices_2d[:, :, 0] >= image_width)
            | (self.vertices_2d[:, :, 1] < 0)
            | (self.vertices_2d[:, :, 1] >= image_height)
        )
        v2d = self.vertices_2d.copy()
        v2d[outside, 2] = 0
        self.vertices_2d = v2d

        if self.bboxes_xywh is not None and len(self.bboxes_xywh):
            self.compute_area_if_needed()
            xywh = self.bboxes_xywh
            x1 = np.clip(xywh[:, 0], 0, image_width)
            y1 = np.clip(xywh[:, 1], 0, image_height)
            x2 = np.clip(xywh[:, 0] + xywh[:, 2], 0, image_width)
            y2 = np.clip(xywh[:, 1] + xywh[:, 3], 0, image_height)
            clipped = np.stack([x1, y1, x2 - x1, y2 - y1], axis=1)
            raw_area = np.clip(xywh[:, 2] * xywh[:, 3], 1e-6, None)
            clipped_area = clipped[:, 2] * clipped[:, 3]
            self.areas = self.areas * clipped_area / raw_area
            self.bboxes_xywh = clipped
        return self

    def _select(self, keep: np.ndarray) -> "MeshEstimationSample":
        self.vertices_2d = self.vertices_2d[keep]
        self.vertices_3d = self.vertices_3d[keep]
        self.rotation_matrix = self.rotation_matrix[keep]
        if self.areas is not None:
            self.areas = self.areas[keep]
        if self.bboxes_xywh is not None:
            self.bboxes_xywh = self.bboxes_xywh[keep]
        if self.is_crowd is not None:
            self.is_crowd = self.is_crowd[keep]
        return self

    def filter_by_mask(self, mask: np.ndarray) -> "MeshEstimationSample":
        return self._select(np.asarray(mask, bool))

    def filter_by_visible_joints(self, min_visible: int) -> "MeshEstimationSample":
        keep = (self.vertices_2d[:, :, 2] > 0).sum(-1) >= min_visible
        return self._select(keep)

    def filter_by_bbox_area(self, min_bbox_area: float) -> "MeshEstimationSample":
        if self.bboxes_xywh is None or len(self.bboxes_xywh) == 0:
            return self
        keep = self.bboxes_xywh[:, 2] * self.bboxes_xywh[:, 3] >= min_bbox_area
        return self._select(keep)

    def filter_by_pose_area(self, min_area: float) -> "MeshEstimationSample":
        self.compute_area_if_needed()
        return self._select(self.areas >= min_area)
