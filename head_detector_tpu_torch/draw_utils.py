"""Host visualisation: landmark dots, the mesh wireframe, pose axes, boxes.

Counterpart of ``head_detector_tpu/draw_utils.py``, byte for byte: dots are
one numpy disk-stencil scatter over all landmarks, the wireframe one
``cv2.polylines`` call over the triangle list.  Nothing here touches a
device.
"""

from __future__ import annotations

from math import sqrt
from typing import Optional, Tuple

import cv2
import numpy as np

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.head_info import HeadMetadata

POINT_COLOR = (255, 255, 255)

# pose axes: x red, y green, z blue (BGR tuples, as the reference draws them)
_AXIS_COLORS = ((0, 0, 255), (0, 255, 0), (255, 0, 0))


def _disk_stencil(radius: int) -> np.ndarray:
    """(K, 2) (dy, dx) offsets of the filled disk |d| <= radius."""
    span = np.arange(-radius, radius + 1)
    dy, dx = np.meshgrid(span, span, indexing="ij")
    keep = dy * dy + dx * dx <= radius * radius
    return np.stack([dy[keep], dx[keep]], axis=1)


def draw_points(
    image: np.ndarray, points: np.ndarray, color: Optional[Tuple[int, int, int]] = None
) -> np.ndarray:
    """Stamp a dot at every point; the radius is 0.1% of the short image
    side, at least 1 px."""
    if color is None:
        color = POINT_COLOR
    h, w = image.shape[:2]
    radius = max(1, int(min(h, w) * 0.001))
    pts = np.rint(np.asarray(points, np.float64)[:, :2]).astype(np.int64)
    if pts.size == 0:
        return image
    pix = (pts[:, None, ::-1] + _disk_stencil(radius)[None, :, :]).reshape(-1, 2)
    inb = (pix[:, 0] >= 0) & (pix[:, 0] < h) & (pix[:, 1] >= 0) & (pix[:, 1] < w)
    pix = pix[inb]
    image[pix[:, 0], pix[:, 1]] = np.asarray(color, image.dtype)
    return image


def draw_2d_landmarks(image: np.ndarray, head: HeadMetadata) -> np.ndarray:
    """Face-subset landmark dots."""
    return draw_points(image, head.vertices_3d[load_flame_assets().face_indices, :2])


def draw_3d_landmarks(image: np.ndarray, head: HeadMetadata) -> np.ndarray:
    """Red mesh wireframe of the drawing triangles + head-subset dots."""
    assets = load_flame_assets()
    projected = np.asarray(head.vertices_3d[:, :2], np.float64)
    wires = np.rint(projected[np.asarray(assets.triangles, np.int64)]).astype(np.int32)
    cv2.polylines(
        image, list(wires[:, :, None, :]), isClosed=True,
        color=(0, 0, 255), thickness=1,
    )
    return draw_points(image, projected[assets.head_indices])


def draw_pose(image: np.ndarray, head: HeadMetadata) -> np.ndarray:
    """Three arrowed pose axes from the roll/pitch/yaw angles, anchored at
    the bbox centre, sqrt(bbox area)/4 long, 3% of sqrt(area) thick."""
    rpy = head.head_pose
    bbox = head.bbox
    side = sqrt(bbox.w * bbox.h)
    center = np.array([bbox.x + bbox.w // 2, bbox.y + bbox.h // 2], np.float64)

    p, y, r = np.deg2rad([rpy.pitch, -rpy.yaw, rpy.roll])
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    cr, sr = np.cos(r), np.sin(r)
    # rows: image-plane (x, y) of the rotated head-frame X / Y / Z axes
    axes = np.array(
        [
            [cy * cr, cp * sr + cr * sp * sy],
            [-cy * sr, cp * cr - sp * sy * sr],
            [sy, -cy * sp],
        ]
    )
    tips = np.rint(center + (side // 4) * axes).astype(int)

    origin = (int(center[0]), int(center[1]))
    thickness = max(1, int(side * 0.03))
    for tip, axis_color in zip(tips, _AXIS_COLORS):
        cv2.arrowedLine(image, origin, (tip[0], tip[1]), axis_color, thickness)
    return image


def draw_bboxes(image: np.ndarray, head: HeadMetadata) -> np.ndarray:
    """2 px blue box."""
    x, y, w, h = head.bbox
    cv2.rectangle(image, (x, y), (x + w, y + h), (255, 0, 0), 2)
    return image
