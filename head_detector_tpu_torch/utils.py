"""Host geometry for the aligned-crop API: bbox algebra, the skull centre,
and the roll alignment with cv2.

Counterpart of ``head_detector_tpu/utils.py``.  Per-head host math only;
the assets are read on first use (``load_flame_assets`` caches them).
"""

from __future__ import annotations

from typing import Tuple, Union

import cv2
import numpy as np

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.head_info import Bbox, FlameParams

# the reference's letterbox size, used by the skull centre whatever the
# detector's own image size
IMAGE_SIZE = 640


def refined_head_bbox(vertices: np.ndarray) -> Bbox:
    """Tight integer bbox over the head-subset vertices."""
    points = np.take(np.asarray(vertices), load_flame_assets().head_indices, axis=0)
    x, y = int(points[:, 0].min()), int(points[:, 1].min())
    x1, y1 = int(points[:, 0].max()), int(points[:, 1].max())
    return Bbox(x=x, y=y, w=x1 - x, h=y1 - y)


def extend_bbox(
    bbox: np.ndarray, offset: Union[Tuple[float, ...], float] = 0.1
) -> np.ndarray:
    """Grow an xywh bbox by a fraction of its size per side: ``offset`` is
    one fraction, ``(w, h)`` fractions, or ``(left, right, top, bottom)``."""
    x, y, w, h = bbox
    if isinstance(offset, tuple):
        if len(offset) == 4:
            left, right, top, bottom = offset
        else:
            w_off, h_off = offset
            left = right = w_off
            top = bottom = h_off
    else:
        left = right = top = bottom = offset
    return np.array(
        [x - w * left, y - h * top, w * (1.0 + right + left), h * (1.0 + top + bottom)]
    ).astype("int32")


def extend_to_rect(bbox: np.ndarray) -> np.ndarray:
    """Grow the short side symmetrically to make the bbox square."""
    x, y, w, h = bbox
    if w > h:
        diff = w - h
        return np.array([x, y - diff // 2, w, w])
    diff = h - w
    return np.array([x - diff // 2, y, h, h])


def flame_params_skull_center(
    flame_params: FlameParams, image: np.ndarray
) -> Tuple[int, int]:
    """Skull centre in original-image coordinates, by the reference's
    formula: the translation over the 640 px letterbox scale, minus the
    FULL pad (not the half pad the letterbox puts on each side)."""
    h, w = image.shape[:2]
    scale = IMAGE_SIZE / max(h, w)
    if h > w:
        new_h, new_w = IMAGE_SIZE, int(w * IMAGE_SIZE / h)
    else:
        new_h, new_w = int(h * IMAGE_SIZE / w), IMAGE_SIZE
    pad_w = IMAGE_SIZE - new_w
    pad_h = IMAGE_SIZE - new_h
    center = np.asarray(flame_params.translation).reshape(-1)[:2] / scale
    return int(center[0] - pad_w), int(center[1] - pad_h)


def get_rotation_mat(
    img: np.ndarray, img_center: Tuple[int, int], angle: Union[float, int]
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """cv2 rotation matrix about ``img_center`` with the bounds grown to
    hold the whole rotated image."""
    height, width = img.shape[:2]
    rotation_mat = cv2.getRotationMatrix2D(
        (float(img_center[0]), float(img_center[1])), float(angle), 1.0
    )
    abs_cos = abs(rotation_mat[0, 0])
    abs_sin = abs(rotation_mat[0, 1])
    bound_w = int(height * abs_sin + width * abs_cos)
    bound_h = int(height * abs_cos + width * abs_sin)
    rotation_mat[0, 2] += bound_w / 2 - img_center[0]
    rotation_mat[1, 2] += bound_h / 2 - img_center[1]
    return rotation_mat, (bound_w, bound_h)


def vertically_align(
    img: np.ndarray, vertices: np.ndarray, flame_params: FlameParams, roll: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate the image and the vertices by the roll about the skull centre."""
    skull_center = flame_params_skull_center(flame_params, img)
    rot_mat, bounds = get_rotation_mat(img, skull_center, roll)
    vertical_img = cv2.warpAffine(img, rot_mat, bounds, flags=cv2.INTER_LINEAR)
    pts = np.hstack([vertices[:, :2], np.ones((vertices.shape[0], 1))])
    return vertical_img, pts @ rot_mat.T
