"""3DMM-space rotation/alignment math (2D homogeneous helpers + FLAME-param
rotation around the skull center).

The port's numpy/cv2 copy of ``head_detector_tpu/evaluation/
transforms3dmm.py`` (reference ``evaluation/transforms.py:16-178``): vertically
align a head by rotating both the image (cv2 warp with grown bounds) and the
packed FLAME params: the translation is remapped through the 2D rotation
matrix (in the DAD (t+1)/2*size convention) and the 6DoF rotation is
pre-multiplied by an in-plane roll matrix.
"""

from __future__ import annotations

from typing import Tuple, Union

import cv2
import numpy as np
import torch

from head_detector_tpu_torch.head_info import RPY, FlameParams
from head_detector_tpu_torch.ops.rotation import rot_mat_from_6dof

NORMALIZED_IMAGE_SIZE = 1024
DISTANCE_OUTER_EYES_CORNERS_NORMALIZED = 116
LEYE_INDEX_3D = 2437
REYE_INDEX_3D = 1175
SKULL_CENTER_LEFT_END_IDX = 567
SKULL_CENTER_RIGHT_END_IDX = 1962


def homogeneous_matrix_2d(mat: np.ndarray) -> np.ndarray:
    if mat.shape == (2, 2):
        mat = np.concatenate((mat, np.array([[0.0], [0.0]])), -1)
    return np.concatenate((mat, np.array([[0.0, 0.0, 1.0]])))


def get_scale_matrix(sx: float, sy: Union[float, None] = None) -> np.ndarray:
    sy = sy if sy else sx
    return np.array([[sx, 0.0, 0.0], [0.0, sy, 0.0]])


def get_translation_matrix(tx: float, ty: Union[float, None] = None) -> np.ndarray:
    ty = ty if ty is not None else tx
    return np.array([[1.0, 0.0, tx], [0.0, 1.0, ty]])


def get_scale(vertices: np.ndarray) -> float:
    return DISTANCE_OUTER_EYES_CORNERS_NORMALIZED / np.linalg.norm(
        vertices[LEYE_INDEX_3D] - vertices[REYE_INDEX_3D]
    )


def get_skull_center(vertices: np.ndarray) -> np.ndarray:
    return (vertices[SKULL_CENTER_LEFT_END_IDX] + vertices[SKULL_CENTER_RIGHT_END_IDX]) / 2


def euler_angles_to_rotation_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(roll) @ Ry(yaw) @ Rx(pitch), radians (ref transforms.py)."""
    theta = (pitch, yaw, roll)
    rx = np.array([[1, 0, 0],
                   [0, np.cos(theta[0]), -np.sin(theta[0])],
                   [0, np.sin(theta[0]), np.cos(theta[0])]])
    ry = np.array([[np.cos(theta[1]), 0, np.sin(theta[1])],
                   [0, 1, 0],
                   [-np.sin(theta[1]), 0, np.cos(theta[1])]])
    rz = np.array([[np.cos(theta[2]), -np.sin(theta[2]), 0],
                   [np.sin(theta[2]), np.cos(theta[2]), 0],
                   [0, 0, 1]])
    return rz @ ry @ rx


def flame_params_skull_center(flame_params: FlameParams, img_size: int) -> Tuple[int, int]:
    center = (np.asarray(flame_params.translation)[0, :2] + 1.0) / 2.0 * img_size
    return int(center[0]), int(center[1])


def get_rotation_mat(img: np.ndarray, img_center: Tuple[int, int], angle: float):
    height, width = img.shape[:2]
    rot = cv2.getRotationMatrix2D(
        (float(img_center[0]), float(img_center[1])), float(angle), 1.0
    )
    abs_cos, abs_sin = abs(rot[0, 0]), abs(rot[0, 1])
    bound_w = int(height * abs_sin + width * abs_cos)
    bound_h = int(height * abs_cos + width * abs_sin)
    rot[0, 2] += bound_w / 2 - img_center[0]
    rot[1, 2] += bound_h / 2 - img_center[1]
    return rot, (bound_w, bound_h)


def rotate_3dmm_translation(
    flame_params: FlameParams, skull_center: Tuple[int, int],
    rotation_mat: np.ndarray, img_size: int,
) -> None:
    tx, ty = skull_center
    new_x, new_y = rotation_mat @ [tx, ty, 1]
    t = np.asarray(flame_params.translation).copy()
    t[0, 0] = new_x / img_size * 2 - 1
    t[0, 1] = new_y / img_size * 2 - 1
    flame_params.translation = t


def rotate_3dmm_rotation_6dof(flame_params: FlameParams, orig_mat: np.ndarray) -> None:
    rotation6 = torch.as_tensor(np.asarray(flame_params.rotation, np.float32))
    roll_mat = rot_mat_from_6dof(rotation6)[0].numpy()
    mat = orig_mat.astype(np.float32) @ roll_mat
    rotation = np.asarray(flame_params.rotation).copy()
    rotation[0, :] = np.concatenate([mat.T[0], mat.T[1]], -1)
    flame_params.rotation = rotation


def rotate_3dmm(
    flame_params: FlameParams, skull_center: Tuple[int, int],
    rotation_mat: np.ndarray, rpy: RPY, img_size: int,
) -> FlameParams:
    rotate_3dmm_translation(flame_params, skull_center, rotation_mat, img_size)
    orig = euler_angles_to_rotation_matrix(rpy.roll * np.pi / 180, 0, 0)
    rotate_3dmm_rotation_6dof(flame_params, orig)
    return flame_params


def vertically_align(
    img: np.ndarray, flame_params: FlameParams, rpy: RPY, img_size: int
) -> Tuple[np.ndarray, FlameParams]:
    """Rotate image and 3DMM params together so the head is upright."""
    skull_center = flame_params_skull_center(flame_params, img_size)
    rot_mat, bounds = get_rotation_mat(img, skull_center, -rpy.roll)
    vertical_img = cv2.warpAffine(img, rot_mat, bounds, flags=cv2.INTER_LINEAR)
    vertical_params = rotate_3dmm(flame_params, skull_center, rot_mat, rpy, img_size)
    return vertical_img, vertical_params
