"""Evaluation harness of the port: DAD-3DHeads / AFLW2000+BIWI / FDDB / WIDER
protocols, their metrics, and the batched aligned crops.

Counterpart of ``head_detector_tpu/evaluation``; the same exports, loaded on
first use.
"""

_LAZY = {
    "EvalPredictor": "head_detector_tpu_torch.evaluation.predictor",
    "calc_zn": "head_detector_tpu_torch.evaluation.dad_metrics",
    "chamfer_distance": "head_detector_tpu_torch.evaluation.dad_metrics",
    "procrustes_align": "head_detector_tpu_torch.evaluation.dad_metrics",
    "rotation_frobenius_error": "head_detector_tpu_torch.evaluation.dad_metrics",
    "rotation_angle_error_deg": "head_detector_tpu_torch.evaluation.dad_metrics",
    "nme_2d": "head_detector_tpu_torch.evaluation.dad_metrics",
    "coco_map": "head_detector_tpu_torch.evaluation.detection_ap",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_LAZY)
