"""Competitor baselines on FDDB: insightface SCRFD and img2pose.

Counterpart of ``head_detector_tpu/evaluation/evaluate_competitors.py``
(reference ``evaluation/evaluate_fddb_if.py:37-170`` and
``evaluate_fddb_i2p.py:42-193``): a third-party face detector runs over the
FDDB label set and is scored with the COCO-mAP protocol of
:mod:`evaluate_fddb` (``read_fddb_annotations``, ``coco_map``).

Any ``detector(image RGB uint8) -> (boxes_xyxy [N, 4], scores [N])`` callable
goes through :func:`evaluate_external_detector`.  The competitors' own
networks need their packages and weights (``img2pose``, ``insightface``),
which are not part of this repository: their makers raise ``RuntimeError``
when the package is absent.

Usage: ``python -m head_detector_tpu_torch.evaluation.evaluate_competitors
--data-dir FDDB [--competitor scrfd|img2pose] [--weights-dir DIR]``
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Tuple

import cv2
import numpy as np

from head_detector_tpu_torch.evaluation.detection_ap import coco_map
from head_detector_tpu_torch.evaluation.evaluate_fddb import read_fddb_annotations


def evaluate_external_detector(
    data_dir: str,
    detector: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
) -> dict:
    """COCO mAP of ``detector`` over the FDDB layout in ``data_dir``
    (``label.txt``, images under ``images/`` or the directory itself)."""
    annotations = read_fddb_annotations(data_dir)
    preds, gts = [], []
    for rel_path, boxes in annotations.items():
        image = cv2.imread(os.path.join(data_dir, "images", rel_path))
        if image is None:
            image = cv2.imread(os.path.join(data_dir, rel_path))
        if image is None:
            continue
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        p_boxes, p_scores = detector(image)
        preds.append((np.asarray(p_boxes, np.float64), np.asarray(p_scores)))
        gts.append(np.asarray(boxes, np.float64).reshape(-1, 4))
    result = coco_map(preds, gts)
    print(f"[fddb-competitor] {result}")
    return result


def load_img2pose_artifacts(weights_dir: str) -> dict:
    """The img2pose artifact set (reference ``evaluate_fddb_i2p.py:45-61``):
    the 68-point 3D reference (``reference_3d_68_points_trans.npy`` [68, 3])
    and the WIDER pose statistics (``WIDER_train_pose_{mean,stddev}_v1.npy``,
    6 values each), shape-checked so that a wrong file fails here."""
    paths = {
        "threed_68_points": os.path.join(weights_dir, "reference_3d_68_points_trans.npy"),
        "pose_mean": os.path.join(weights_dir, "WIDER_train_pose_mean_v1.npy"),
        "pose_stddev": os.path.join(weights_dir, "WIDER_train_pose_stddev_v1.npy"),
    }
    out = {}
    for key, path in paths.items():
        if not os.path.isfile(path):
            raise FileNotFoundError(f"img2pose artifact missing: {path}")
        out[key] = np.load(path)
    if out["threed_68_points"].shape != (68, 3):
        raise ValueError("reference_3d_68_points_trans.npy must be [68, 3], "
                         f"got {out['threed_68_points'].shape}")
    for key in ("pose_mean", "pose_stddev"):
        if out[key].reshape(-1).shape[0] != 6:
            raise ValueError(f"{key} must hold 6 pose dims, got {out[key].shape}")
    return out


def make_img2pose_detector(weights_dir: str, conf_threshold: float = 0.5):
    """img2pose baseline (reference ``evaluate_fddb_i2p.py:42-93``): the
    artifacts are parsed here; the network needs the img2pose package and
    ``img2pose_v1.pth``."""
    artifacts = load_img2pose_artifacts(weights_dir)
    try:
        from img2pose import img2poseModel  # type: ignore
        from model_loader import load_model  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"img2pose is not installed; artifacts parsed OK ({sorted(artifacts)}): "
            "supply any detector callable to evaluate_external_detector instead."
        ) from e

    model = img2poseModel(18, 400, 1400, pose_mean=artifacts["pose_mean"],
                          pose_stddev=artifacts["pose_stddev"],
                          threed_68_points=artifacts["threed_68_points"])
    load_model(model.fpn_model, os.path.join(weights_dir, "img2pose_v1.pth"),
               cpu_mode=str(model.device) == "cpu", model_only=True)
    model.evaluate()

    def detect(image):
        import torch

        tensor = torch.from_numpy(image.transpose(2, 0, 1)).float() / 255.0
        faces = model.predict([tensor])[0]
        boxes = faces["boxes"].cpu().numpy().reshape(-1, 4)
        scores = faces["scores"].cpu().numpy().reshape(-1)
        keep = scores >= conf_threshold
        return boxes[keep], scores[keep]

    return detect


def make_scrfd_detector():
    """insightface SCRFD baseline (reference ``evaluate_fddb_if.py``)."""
    try:
        from insightface.app import FaceAnalysis  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "insightface is not installed in this environment; supply any "
            "detector callable to evaluate_external_detector instead."
        ) from e
    app = FaceAnalysis(allowed_modules=["detection"])
    app.prepare(ctx_id=0)

    def detect(image):
        faces = app.get(image)
        boxes = np.array([f.bbox for f in faces]).reshape(-1, 4)
        scores = np.array([f.det_score for f in faces]).reshape(-1)
        return boxes, scores

    return detect


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--competitor", choices=["scrfd", "img2pose"], default="scrfd")
    ap.add_argument("--weights-dir", default=".", help="img2pose artifact dir")
    args = ap.parse_args(argv)
    if args.competitor == "img2pose":
        detector = make_img2pose_detector(args.weights_dir)
    else:
        detector = make_scrfd_detector()
    return evaluate_external_detector(args.data_dir, detector)


if __name__ == "__main__":
    main()
