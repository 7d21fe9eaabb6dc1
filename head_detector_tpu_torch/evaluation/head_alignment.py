"""All heads of an image -> roll-aligned square crops in one warp on the
result's device.

Counterpart of ``head_detector_tpu/evaluation/head_alignment.py``
(``_head_crop_matrix``, ``aligned_heads_batched``): per head one forward
affine (rotate by the roll about the skull centre, then map the extended
square head box to ``out_size``), all of them applied by one
``affine_warp``.  The command-line tool comes with the evaluation slice.
"""

from __future__ import annotations

import cv2
import numpy as np
import torch

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.detection_result import MAX_YAW, PredictionResult
from head_detector_tpu_torch.ops.warp import affine_warp, invert_affine
from head_detector_tpu_torch.utils import extend_bbox, extend_to_rect, flame_params_skull_center


def _head_crop_matrix(head, image: np.ndarray, out_size: int) -> np.ndarray:
    """Forward affine [2, 3] from the original image to the aligned crop."""
    roll = head.head_pose.roll if abs(head.head_pose.yaw) < MAX_YAW else 0.0
    center = flame_params_skull_center(head.flame_params, image)
    rot = cv2.getRotationMatrix2D((float(center[0]), float(center[1])), roll, 1.0)

    # bbox of the head vertices in the rotated frame
    pts = np.take(head.vertices_3d[:, :2], load_flame_assets().head_indices, axis=0)
    pts_h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
    rpts = pts_h @ rot.T
    x, y = rpts[:, 0].min(), rpts[:, 1].min()
    w, h = rpts[:, 0].max() - x, rpts[:, 1].max() - y
    bx, by, bw, bh = extend_to_rect(extend_bbox(np.array([x, y, w, h]), offset=0.1))

    s = out_size / max(bw, 1)
    post = np.array([[s, 0, -bx * s], [0, s, -by * s]], np.float64)
    rot3 = np.vstack([rot, [0, 0, 1]])
    return (post @ rot3).astype(np.float32)


def aligned_heads_batched(result: PredictionResult, out_size: int = 256) -> np.ndarray:
    """All heads -> [N, out_size, out_size, 3] float32 crops, one warp on
    ``result.device``."""
    if not result.heads:
        return np.zeros((0, out_size, out_size, 3), np.float32)
    mats = np.stack(
        [_head_crop_matrix(h, result.original_image, out_size) for h in result.heads]
    )
    dev = result.device
    crops = affine_warp(
        torch.as_tensor(np.ascontiguousarray(result.original_image), device=dev),
        torch.as_tensor(invert_affine(mats), device=dev),
        out_size,
        out_size,
    )
    return crops.cpu().numpy()
