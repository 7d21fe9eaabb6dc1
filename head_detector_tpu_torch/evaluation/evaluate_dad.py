"""DAD-3DHeads academic test-set evaluation.

Counterpart of ``head_detector_tpu/evaluation/evaluate_dad.py`` (reference
``evaluation/evaluate_dad.py:86-316``).  Per sample:
eval-predictor inference (conf 0.2, iou 0.5, post-nms 30), head selection by
IoU of the head-vertex bbox vs the GT bbox, then

* rot_error  = ||I - R_pred @ R_KT^T||_F where R_KT comes from the GT
  model-view matrix pre-rotated by diag(1,-1,-1) (the 180-degree flip at
  ``:257-259``),
* angle_error = axis-angle degrees of the relative rotation, wrapped at 90
  (the reference's ``mae(0, .)`` with PI_2=90, ``:113-119``),
* nme_2d over 68 landmarks / sqrt(bbox wh) * 100,
* Z_n depth-ordering on the head-vertex subset (GT z negated, ``:295-299``),
* chamfer of the 7-landmark Procrustes-aligned prediction vs GT scaled to
  inter-eye 20,

with per-attribute breakdowns (quality/gender/expression/age/occlusions/
pose/standard light).

The DAD-3DHeads dataset ships its own JSON index; ``DadSample`` documents the
fields consumed here (image_path, bbox xywh, model_view_matrix [4,4],
landmarks_68_2d [68,2], vertices_3d [5023,3], attributes dict).

The forward, the decode and the chamfer distance run on the predictor's
device; the rest is host numpy, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List

import cv2
import numpy as np
import torch
from scipy.spatial.transform import Rotation

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.evaluation.dad_metrics import (
    calc_zn,
    chamfer_distance,
    get_68_landmark_indices,
    get_7_landmarks_from_68,
    procrustes_align,
    scale_gt_to_standard,
)
from head_detector_tpu_torch.evaluation.evaluate_pose import _iou, _select
from head_detector_tpu_torch.evaluation.predictor import EvalPredictor
from head_detector_tpu_torch.head_info import FlameParams
from head_detector_tpu_torch.ops.rotation import rot_mat_from_6dof

ROT_180 = np.diag([1.0, -1.0, -1.0])


@dataclass
class DadSample:
    image_path: str
    bbox: List[float]  # xywh
    model_view_matrix: np.ndarray  # [4, 4]
    landmarks_68_2d: np.ndarray  # [68, 2] absolute image coords
    vertices_3d: np.ndarray  # [5023, 3] world
    attributes: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_config(cls, config: Dict[str, Any], base_path: str) -> "DadSample":
        return cls(
            image_path=os.path.join(base_path, config["image_path"]),
            bbox=list(config["bbox"]),
            model_view_matrix=np.asarray(config["model_view_matrix"], np.float64),
            landmarks_68_2d=np.asarray(config["landmarks_68_2d"], np.float64),
            vertices_3d=np.asarray(config["vertices_3d"], np.float64),
            attributes=dict(config.get("attributes", {})),
        )


def _angle_mae_90(x: float) -> float:
    pi2 = 90.0
    return min(abs(x), abs(x - 2 * pi2), abs(x + 2 * pi2))


class DadEvaluator:
    """``predictor`` maps an RGB image to ``YoloHeadsPredictions``; the
    chamfer distance runs on its ``device`` (the CPU for one without)."""

    def __init__(self, samples: List[DadSample], predictor: EvalPredictor):
        self.samples = samples
        self.predictor = predictor
        self.device = getattr(predictor, "device", torch.device("cpu"))
        self.lmk68 = get_68_landmark_indices()
        self.head_indices = load_flame_assets().head_indices
        # per sample: the index of the selected head and its metrics
        self.selected: List[Dict[str, Any]] = []
        self.metrics: Dict[str, List[float]] = {
            "nme_2d": [], "z_n": [], "rot_error": [], "angle_error": [], "chamfer": [],
        }
        self.attribute_metrics: Dict[str, Dict[str, Dict[str, List[float]]]] = {
            k: defaultdict(lambda: defaultdict(list))
            for k in ("quality", "gender", "expression", "age", "occlusions",
                      "pose", "standard light")
        }

    def _add(self, name: str, value: float, attributes: Dict[str, Any]):
        self.metrics[name].append(value)
        for attr, attr_value in attributes.items():
            if attr in self.attribute_metrics:
                self.attribute_metrics[attr][str(attr_value)][name].append(value)

    def _head_bbox(self, vertices_2d: np.ndarray) -> np.ndarray:
        pts = np.take(vertices_2d, self.head_indices, axis=0)
        return np.array(
            [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
        ).astype(int)

    def __call__(self) -> Dict[str, float]:
        fail_cases = 0
        for ann in self.samples:
            image = cv2.imread(ann.image_path)
            if image is None:
                fail_cases += 1
                continue
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
            pred = self.predictor(image)
            if len(pred.scores) == 0:
                fail_cases += 1
                continue
            index = 0
            if pred.bboxes_xyxy.shape[0] > 1:
                x, y, w, h = ann.bbox
                gt_xyxy = [x, y, x + w, y + h]
                ious = [
                    _iou(self._head_bbox(v), gt_xyxy)
                    for v in pred.predicted_2d_vertices
                ]
                index = int(np.argmax(ious))
            pred = _select(pred, index)
            record = {"image_path": ann.image_path, "index": index}

            p = FlameParams.from_3dmm(np.asarray(pred.mm_params, np.float32))
            pred_R = rot_mat_from_6dof(torch.from_numpy(np.ascontiguousarray(p.rotation)))
            pred_R = pred_R[0].numpy()

            r_kt = (np.diag([1.0, -1.0, -1.0, 1.0]) @ ann.model_view_matrix)[:3, :3]
            r_dist = pred_R @ r_kt.T
            record["rot_error"] = float(np.linalg.norm(np.eye(3) - r_dist, "fro"))
            angle = np.rad2deg(np.linalg.norm(Rotation.from_matrix(r_dist).as_rotvec()))
            record["angle_error"] = _angle_mae_90(float(angle))

            pred_3d = pred.predicted_3d_vertices[0]
            pred_2d = pred.predicted_2d_vertices[0]
            lmk2d = pred_2d[self.lmk68][..., :2]
            record["nme_2d"] = float(
                np.mean(
                    np.linalg.norm(ann.landmarks_68_2d - lmk2d, 2, -1)
                    / np.sqrt(ann.bbox[2] * ann.bbox[3])
                )
            ) * 100.0

            gt_3d = np.asarray(ann.vertices_3d)
            record["z_n"] = calc_zn(
                pred_3d[self.head_indices][None],
                (gt_3d[self.head_indices] * np.array([1.0, 1.0, -1.0]))[None],
            )

            # chamfer: GT scaled to inter-eye 20, pred Procrustes-aligned on
            # the 7 of 68 landmarks
            gt_lmks68 = gt_3d[self.lmk68]
            gt_scaled, gt_lmks_scaled = scale_gt_to_standard(gt_3d, gt_lmks68)
            pred_lmks68 = pred_3d[self.lmk68]
            aligned = procrustes_align(
                pred_3d,
                get_7_landmarks_from_68(pred_lmks68),
                get_7_landmarks_from_68(gt_lmks_scaled),
            )
            record["chamfer"] = chamfer_distance(gt_scaled, aligned, device=self.device)
            for name in self.metrics:
                self._add(name, record[name], ann.attributes)
            self.selected.append(record)

        print(f"Num Fail Cases = {fail_cases}")
        result = {k: float(np.mean(v)) if v else float("nan") for k, v in self.metrics.items()}
        print(f"[dad] {result}")
        return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-json", required=True)
    ap.add_argument("--base-path", default="")
    ap.add_argument("--model", default="yolo_heads_l")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--image-size", type=int, default=640,
                    help="eval resolution (the protocol's 640; use the "
                         "training resolution for checkpoints trained "
                         "at another size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with open(args.dataset_json) as f:
        data = json.load(f)
    samples: List[DadSample] = []
    for _, values in data.items():
        samples += [DadSample.from_config(cfg, args.base_path) for cfg in values]

    predictor = EvalPredictor(
        model_name=args.model, checkpoint=args.checkpoint,
        image_size=args.image_size,
        confidence_threshold=0.2, nms_iou_threshold=0.5,
        post_nms_max_predictions=30, device=args.device,
    )
    return DadEvaluator(samples, predictor)()


if __name__ == "__main__":
    main()
