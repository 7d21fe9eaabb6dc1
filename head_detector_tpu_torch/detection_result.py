"""PredictionResult: the detector's per-image output and its PNCC render.

Counterpart of ``head_detector_tpu/detection_result.py``.  This slice ports
``get_pncc``; ``draw``, ``get_aligned_heads`` and ``save_meshes`` come in a
later slice.  PNCC processors are shared per device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from head_detector_tpu_torch.head_info import HeadMetadata

_PNCC: Dict[str, object] = {}


def _pncc_processor(device: torch.device):
    key = str(device)
    if key not in _PNCC:
        from head_detector_tpu_torch.pncc import PNCCProcessor

        _PNCC[key] = PNCCProcessor(device=device)
    return _PNCC[key]


class PredictionResult:
    def __init__(self, original_image: np.ndarray, heads: List[HeadMetadata],
                 device="cuda"):
        self.original_image = original_image
        self.heads = heads
        self.device = torch.device(device)

    @property
    def pncc_processor(self):
        return _pncc_processor(self.device)

    def get_pncc(self) -> np.ndarray:
        """PNCC map of all heads, rendered on the detector's device."""
        return self.pncc_processor(self.original_image, self.heads)

    def __repr__(self) -> str:
        return (
            f"PredictionResult(original_image={self.original_image.shape}, "
            f"num heads={len(self.heads)})"
        )
