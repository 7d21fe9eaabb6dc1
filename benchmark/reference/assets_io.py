"""FLAME model assets: loading, and the deterministic synthetic basis.

Counterpart of ``head_detector_tpu/assets_io.py``.  The arrays are read from
the JAX package's ``assets/`` directory by path (nothing of that package is
imported).  No FLAME pickle ships, so the deformation basis is the same
seeded synthetic one, built with identical numpy calls so that it matches
bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
from typing import Optional

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSET_DIR = os.path.join(REPO_ROOT, "head_detector_tpu", "assets")

NUM_VERTICES = 5023
NUM_JOINTS = 5
NUM_SHAPE = 300
NUM_EXPRESSION = 100
NUM_BETAS = NUM_SHAPE + NUM_EXPRESSION
NUM_POSE_BASIS = (NUM_JOINTS - 1) * 9  # 36
PARENTS = np.array([-1, 0, 1, 1, 1], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class FlameAssets:
    """Immutable bundle of all arrays needed for FLAME decoding + rendering."""

    v_template: np.ndarray  # [V, 3] float32
    shapedirs: np.ndarray  # [V, 3, 400] float32
    posedirs: np.ndarray  # [36, V*3] float32
    j_regressor: np.ndarray  # [J, V] float32
    parents: np.ndarray  # [J] int64, parents[0] == -1
    lbs_weights: np.ndarray  # [V, J] float32
    faces: np.ndarray  # [F, 3] int32, full head topology
    face_indices: np.ndarray  # [2094] int32
    head_indices: np.ndarray  # [2470] int32
    head_w_ears_indices: np.ndarray  # [3457] int32
    triangles: np.ndarray  # drawing subset from triangles.txt [T, 3] int32
    synthetic_basis: bool  # True when the deformation basis is the fallback


def _load_index(name: str) -> np.ndarray:
    arr = np.load(os.path.join(ASSET_DIR, "flame_indices", name), allow_pickle=True)[()]
    return np.asarray(arr).reshape(-1).astype(np.int32)


def _synthetic_basis(v_template: np.ndarray, rng_seed: int = 20240722):
    """Deterministic, smooth stand-in FLAME basis (same draws, same order
    and same float64 arithmetic as the JAX package's)."""
    rng = np.random.RandomState(rng_seed)
    v = v_template.astype(np.float64)  # [V, 3]
    vc = v - v.mean(0, keepdims=True)

    # blendshape basis: smooth random Fourier features of vertex position
    n_feat = 64
    freqs = rng.normal(scale=6.0, size=(3, n_feat))
    phases = rng.uniform(0, 2 * np.pi, size=(n_feat,))
    feats = np.sin(vc @ freqs + phases)  # [V, n_feat]
    mix_shape = rng.normal(scale=1.0, size=(n_feat, 3, NUM_BETAS))
    shapedirs = np.einsum("vf,fck->vck", feats, mix_shape)
    rms = np.sqrt((shapedirs**2).mean(axis=(0, 1), keepdims=True))
    shapedirs = shapedirs / (rms + 1e-12) * 2e-3
    shapedirs[..., :NUM_SHAPE] *= 2.0

    # pose-corrective basis, stored [36, V*3]
    mix_pose = rng.normal(scale=1.0, size=(n_feat, 3, NUM_POSE_BASIS))
    posedirs_v = np.einsum("vf,fck->vck", feats, mix_pose)
    rms_p = np.sqrt((posedirs_v**2).mean(axis=(0, 1), keepdims=True))
    posedirs_v = posedirs_v / (rms_p + 1e-12) * 5e-4
    posedirs = posedirs_v.reshape(-1, NUM_POSE_BASIS).T.copy()

    # joints placed on the template
    y_min, y_max = v[:, 1].min(), v[:, 1].max()
    x_mid = np.median(v[:, 0])
    joint_centers = np.array(
        [
            [x_mid, 0.35 * y_min + 0.65 * y_max, np.median(v[:, 2])],  # global/skull
            [x_mid, y_min + 0.15 * (y_max - y_min), np.median(v[:, 2])],  # neck
            [x_mid, y_min + 0.35 * (y_max - y_min), v[:, 2].max() * 0.6],  # jaw
            [x_mid - 0.03, 0.2 * y_min + 0.8 * y_max, v[:, 2].max() * 0.7],  # l eye
            [x_mid + 0.03, 0.2 * y_min + 0.8 * y_max, v[:, 2].max() * 0.7],  # r eye
        ]
    )
    d2 = ((v[:, None, :] - joint_centers[None, :, :]) ** 2).sum(-1)  # [V, J]

    jr = np.exp(-d2.T / (2 * 0.02**2))  # [J, V]
    jr = jr / jr.sum(axis=1, keepdims=True)

    logits = -d2 / (2 * 0.05**2)
    logits[:, 0] += 2.0
    w = np.exp(logits - logits.max(axis=1, keepdims=True))
    lbs_weights = w / w.sum(axis=1, keepdims=True)

    return (
        shapedirs.astype(np.float32),
        posedirs.astype(np.float32),
        jr.astype(np.float32),
        lbs_weights.astype(np.float32),
    )


def _find_real_pkl(flame_path: Optional[str]) -> Optional[str]:
    candidates = [
        flame_path,
        os.environ.get("HDT_FLAME_MODEL_PATH"),
        os.path.join(REPO_ROOT, "head_detector_tpu", "generic_model.pkl"),
    ]
    for c in candidates:
        if c and os.path.isfile(c) and os.path.getsize(c) > 1_000_000:
            return c
    return None


@functools.lru_cache(maxsize=2)
def load_flame_assets(flame_path: Optional[str] = None) -> FlameAssets:
    """Load the asset bundle (cached): a real FLAME pickle when one is found,
    else the synthetic basis on the shipped template."""
    v_template = np.load(os.path.join(ASSET_DIR, "v_template.npy")).astype(np.float32)
    faces = np.load(os.path.join(ASSET_DIR, "full_faces.npy")).astype(np.int32)
    triangles = np.loadtxt(
        os.path.join(ASSET_DIR, "triangles.txt"), delimiter=","
    ).astype(np.int32)

    real = _find_real_pkl(flame_path)
    if real is not None:
        with open(real, "rb") as f:
            data = pickle.load(f, encoding="latin1")

        def _np(x):
            if hasattr(x, "todense"):
                x = np.asarray(x.todense())
            return np.asarray(x, dtype=np.float64)

        shapedirs = _np(data["shapedirs"]).astype(np.float32)
        num_pose_basis = _np(data["posedirs"]).shape[-1]
        posedirs = (
            _np(data["posedirs"]).reshape(-1, num_pose_basis).T.astype(np.float32)
        )
        j_regressor = _np(data["J_regressor"]).astype(np.float32)
        lbs_weights = _np(data["weights"]).astype(np.float32)
        v_template = _np(data["v_template"]).astype(np.float32)
        faces = np.asarray(data["f"], dtype=np.int32)
        synthetic = False
    else:
        shapedirs, posedirs, j_regressor, lbs_weights = _synthetic_basis(v_template)
        synthetic = True

    return FlameAssets(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        parents=PARENTS.copy(),
        lbs_weights=lbs_weights,
        faces=faces,
        face_indices=_load_index("face.npy"),
        head_indices=_load_index("head_indices.npy"),
        head_w_ears_indices=_load_index("head_w_ears.npy"),
        triangles=triangles,
        synthetic_basis=synthetic,
    )


@functools.lru_cache(maxsize=4)
def load_keypoint_indices(count: int = 445) -> np.ndarray:
    """The ``count``-keypoint vertex set: the region files of
    ``assets/face_keypoints/keypoints_<count>`` concatenated in name order
    (a file holding a dict of sub-regions contributes them in key order)."""
    base = os.path.join(ASSET_DIR, "face_keypoints", f"keypoints_{count}")
    parts = []
    for name in sorted(os.listdir(base)):
        arr = np.load(os.path.join(base, name), allow_pickle=True)
        value = arr[()] if arr.dtype == object else arr
        if isinstance(value, dict):
            for key in sorted(value):
                parts.append(np.asarray(value[key]).reshape(-1).astype(np.int32))
        else:
            parts.append(np.asarray(value).reshape(-1).astype(np.int32))
    return np.concatenate(parts)


def get_indices() -> dict:
    """Named vertex subsets: ``head``, ``face``, ``face_w_ears`` and
    ``keypoint_445``."""
    assets = load_flame_assets()
    return {
        "head": assets.head_indices,
        "face": assets.face_indices,
        "face_w_ears": assets.head_w_ears_indices,
        "keypoint_445": load_keypoint_indices(445),
    }
