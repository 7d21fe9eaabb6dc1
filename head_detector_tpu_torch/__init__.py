"""head_detector_tpu_torch — the PyTorch/CUDA port of head_detector_tpu.

Same public surface as the JAX package, for an NVIDIA H100: one forward pass
over an RGB image gives, for every head, a box, a score, 413 FLAME
parameters and a 5,023-vertex mesh, and ``PredictionResult.get_pncc``
renders the meshes with a hand-written CUDA rasterizer.  Entry points take
``device="cuda"`` by default and raise when CUDA is absent; tests pass
``device="cpu"``, where the plain torch versions of the kernels run.

This package imports torch, never jax or head_detector_tpu; it reads the
JAX package's asset files and the checkpoints by path.
"""

from head_detector_tpu_torch.head_info import (
    FLAME_CONSTS,
    RPY,
    Bbox,
    FlameParams,
    HeadMetadata,
)

__version__ = "0.1.0"

_LAZY = {
    "FlameModel": "head_detector_tpu_torch.flame",
    "fused_project_vertices": "head_detector_tpu_torch.flame",
    "reproject_spatial_vertices": "head_detector_tpu_torch.flame",
    "HeadDetector": "head_detector_tpu_torch.detector",
    "PredictionResult": "head_detector_tpu_torch.detection_result",
    "PNCCProcessor": "head_detector_tpu_torch.pncc",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Bbox", "RPY", "FLAME_CONSTS", "FlameParams", "HeadMetadata", *_LAZY]
