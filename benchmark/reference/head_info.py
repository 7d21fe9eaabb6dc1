"""Core data contracts: FLAME parameter layout, bbox/pose tuples, head metadata.

Counterpart of ``head_detector_tpu/head_info.py``.  The 413-float FLAME wire
vector keeps the reference's asymmetry between the two conversions:

* ``FlameParams.from_3dmm`` slices ``[shape(300), expression(100), jaw(3),
  rotation(6), eyeballs(0), neck(0), translation(3), scale(1)]``;
* ``FlameParams.to_3dmm_tensor`` concatenates ``[shape, expression, rotation,
  jaw, eyeballs, neck, translation, scale]``.

So ``from_3dmm(to_3dmm(p))`` swaps three floats between the rotation and jaw
fields; every consumer goes through the same pair, so the mapping stays
self-consistent end to end.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from typing import Dict

import numpy as np
import torch

Bbox = namedtuple("Bbox", ["x", "y", "w", "h"])
RPY = namedtuple("RPY", ["roll", "pitch", "yaw"])

FLAME_CONSTS: Dict[str, int] = {
    "shape": 300,
    "expression": 100,
    "rotation": 6,
    "jaw": 3,
    "eyeballs": 0,
    "neck": 0,
    "translation": 3,
    "scale": 1,
}

NUM_FLAME_PARAMS = sum(FLAME_CONSTS.values())  # 413
NUM_VERTICES = 5023
NUM_FACES = 9976


@dataclasses.dataclass
class FlameParams:
    """A batch of decomposed FLAME parameter groups ([N, C] numpy arrays or
    torch tensors; all operations are slicing and concatenation)."""

    shape: np.ndarray
    expression: np.ndarray
    rotation: np.ndarray
    translation: np.ndarray
    scale: np.ndarray
    jaw: np.ndarray
    eyeballs: np.ndarray
    neck: np.ndarray

    @classmethod
    def from_3dmm(cls, tensor_3dmm) -> "FlameParams":
        """Slice a packed ``[N, 413]`` wire tensor: shape, expression,
        **jaw, rotation**, eyeballs, neck, translation, scale."""
        if tensor_3dmm.shape[1] != NUM_FLAME_PARAMS:
            raise ValueError(
                f"3DMM vector has {tensor_3dmm.shape[1]} parameters; "
                f"expected {NUM_FLAME_PARAMS}."
            )
        fields = {}
        i = 0
        for name in ("shape", "expression", "jaw", "rotation", "eyeballs", "neck",
                     "translation", "scale"):
            fields[name] = tensor_3dmm[:, i : i + FLAME_CONSTS[name]]
            i += FLAME_CONSTS[name]
        return cls(**fields)

    def to_3dmm_tensor(self):
        """Concatenate back to the wire format: shape, expression,
        **rotation, jaw**, eyeballs, neck, translation, scale."""
        parts = [
            self.shape,
            self.expression,
            self.rotation,
            self.jaw,
            self.eyeballs,
            self.neck,
            self.translation,
            self.scale,
        ]
        if isinstance(self.shape, torch.Tensor):
            return torch.cat(parts, dim=1)
        return np.concatenate(parts, axis=1)


@dataclasses.dataclass
class HeadMetadata:
    """Per-head detection output."""

    bbox: Bbox
    score: float
    flame_params: FlameParams
    vertices_3d: np.ndarray
    head_pose: RPY
