"""DAD-3DHeads benchmark metrics.

Counterpart of ``head_detector_tpu/evaluation/dad_metrics.py``:

* NME-2D over 68 landmarks, normalised by sqrt(bbox wh), x100,
* Z_n depth-ordering accuracy (top-5 nearest neighbours),
* rotation error ``||I - R_pred @ R_gt^T||_F``,
* angle error: axis-angle degrees of the relative rotation, 180-wrapped,
* Chamfer distance of the Procrustes-7-landmark-aligned predicted mesh
  (kaolin's one-directional chamfer, weights (1.0, 0.0)), with the GT scaled
  so inter-eye distance = 20 ("standard size").

Everything is host numpy but the chamfer distance, which runs in float32 on
the device its inputs are on (or on ``device``): the [N, M] distances
(5,023^2 floats, 100 MB) from the coordinate differences and a row
minimum.

:func:`get_68_landmark_indices` uses the official FLAME static embedding when
``HDT_FLAME_EMBEDDING_PATH`` names one, otherwise the shipped
``head_detector_tpu/assets/flame_indices/landmarks_68.npy`` (read by path),
otherwise a uniform spread over the face region.
"""

from __future__ import annotations

import functools
import os
import pickle
from typing import Tuple

import numpy as np
import torch

from head_detector_tpu_torch.assets_io import ASSET_DIR, load_flame_assets

SEVEN_LMK_INDICES = np.array([36, 39, 42, 45, 33, 48, 54])  # of the 68 set
LEFT_EYE_68, RIGHT_EYE_68 = 36, 45


def nme_2d(pred_lmks: np.ndarray, gt_lmks: np.ndarray, bbox_wh: Tuple[float, float]) -> float:
    """Mean L2 over landmarks / sqrt(w*h) * 100."""
    err = np.linalg.norm(pred_lmks[..., :2] - gt_lmks[..., :2], axis=-1).mean()
    return float(err / np.sqrt(bbox_wh[0] * bbox_wh[1]) * 100.0)


def calc_zn(pred_landmarks: np.ndarray, gt_landmarks: np.ndarray, top_k: int = 5) -> float:
    """Depth-ordering accuracy over ``[B, N, 3]`` landmark sets: for each
    point and each of its ``top_k`` nearest GT neighbours, whether the
    prediction orders their depths as the GT does."""
    results = []
    for sl in range(gt_landmarks.shape[0]):
        gt = gt_landmarks[sl]
        pred = pred_landmarks[sl]
        d = np.linalg.norm(gt[:, None] - gt[None, :], axis=-1)
        # the reference sorts along dim 0 (columns): neighbours of column j
        order = np.argsort(d, axis=0)
        neigh = order[1 : top_k + 1].T  # [N, top_k]
        gt_ge = gt[:, 2][:, None] >= gt[:, 2][neigh]
        pr_ge = pred[:, 2][:, None] >= pred[:, 2][neigh]
        results.append((gt_ge == pr_ge).mean())
    return float(np.mean(results))


def rotation_frobenius_error(pred_R: np.ndarray, gt_R: np.ndarray) -> float:
    """||I - R_pred R_gt^T||_F."""
    rel = pred_R @ np.swapaxes(gt_R, -1, -2)
    eye = np.eye(3, dtype=rel.dtype)
    return float(np.linalg.norm(eye - rel, axis=(-2, -1)).mean())


def rotation_angle_error_deg(pred_R: np.ndarray, gt_R: np.ndarray) -> float:
    """Axis-angle magnitude of the relative rotation, degrees, 180-wrapped."""
    rel = pred_R @ np.swapaxes(gt_R, -1, -2)
    tr = np.trace(rel, axis1=-2, axis2=-1)
    ang = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1.0, 1.0)))
    ang = np.where(ang > 180.0, 360.0 - ang, ang)
    return float(np.mean(ang))


def procrustes_align(
    source_points: np.ndarray,
    source_lmks: np.ndarray,
    target_lmks: np.ndarray,
    with_scale: bool = True,
) -> np.ndarray:
    """Umeyama rigid(+scale) alignment of ``source_points`` using landmark
    correspondences."""
    mu_s = source_lmks.mean(0)
    mu_t = target_lmks.mean(0)
    sc = source_lmks - mu_s
    tc = target_lmks - mu_t
    cov = tc.T @ sc / len(source_lmks)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    if with_scale:
        var_s = (sc**2).sum() / len(source_lmks)
        scale = (d * s.diagonal()).sum() / var_s
    else:
        scale = 1.0
    t = mu_t - scale * (r @ mu_s)
    return scale * (source_points @ r.T) + t


def _chamfer_one_sided(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean_{p in a} min_{q in b} ||p - q||^2 (kaolin chamfer w=(1,0)).

    The [N, M] distances come from the coordinate differences
    (``torch.cdist`` without its matrix-product mode).  The reference
    expands them as ``|p|^2 + |q|^2 - 2 p.q`` (one matrix product), which
    cancels to a float32 floor that grows with |p|^2 and depends on the
    product's summation order: 4.4e-4 with torch's CPU matrix product for a
    mesh ~100 units from the origin against itself, where XLA's CPU product
    happens to give 0."""
    d = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist")
    return (d.amin(dim=1) ** 2).mean()


def chamfer_distance(gt_points, pred_points, device=None) -> float:
    """One-directional chamfer gt->pred (the reference's weights (1.0,
    0.0)), in float32 on the device of tensor inputs, or on ``device`` (the
    CPU by default) for numpy ones."""
    dev = (gt_points.device if isinstance(gt_points, torch.Tensor)
           else torch.device(device or "cpu"))
    a = torch.as_tensor(gt_points, dtype=torch.float32, device=dev)
    b = torch.as_tensor(pred_points, dtype=torch.float32, device=dev)
    return float(_chamfer_one_sided(a, b))


def scale_gt_to_standard(
    vertices: np.ndarray, lmks68: np.ndarray, inter_eye: float = 20.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Scale so the inter-eye (outer corners) distance equals ``inter_eye``."""
    d = np.linalg.norm(lmks68[LEFT_EYE_68] - lmks68[RIGHT_EYE_68])
    factor = inter_eye / max(d, 1e-9)
    return vertices * factor, lmks68 * factor


@functools.lru_cache(maxsize=1)
def get_68_landmark_indices() -> np.ndarray:
    """68 landmark vertex indices, in iBUG order.

    Priority:

    1. ``HDT_FLAME_EMBEDDING_PATH`` — the official FLAME static embedding
       (nearest-vertex of each barycentric point; contour padded from the
       face boundary).
    2. The shipped ``flame_indices/landmarks_68.npy`` — a deterministic
       iBUG-68 layout derived from the 191-keypoint semantic regions.
    3. A uniform spread over the face-region subset.
    """
    path = os.environ.get("HDT_FLAME_EMBEDDING_PATH")
    assets = load_flame_assets()
    if path and os.path.isfile(path):
        with open(path, "rb") as f:
            emb = pickle.load(f, encoding="latin1")
        lmk_face_idx = np.asarray(emb["lmk_face_idx"], np.int64)
        lmk_b = np.asarray(emb["lmk_b_coords"], np.float64)
        faces = assets.faces[lmk_face_idx]  # [51, 3]
        # nearest corner by barycentric weight
        corner = lmk_b.argmax(axis=1)
        static = faces[np.arange(len(faces)), corner]
        # pad the 17 contour landmarks with face-boundary vertices
        contour = assets.face_indices[
            np.linspace(0, len(assets.face_indices) - 1, 17).astype(int)
        ]
        return np.concatenate([contour, static]).astype(np.int64)
    shipped = os.path.join(ASSET_DIR, "flame_indices", "landmarks_68.npy")
    if os.path.isfile(shipped):
        return np.load(shipped).astype(np.int64)
    face = assets.face_indices
    return face[np.linspace(0, len(face) - 1, 68).astype(int)].astype(np.int64)


def get_7_landmarks_from_68(lmks68: np.ndarray) -> np.ndarray:
    return lmks68[SEVEN_LMK_INDICES]
