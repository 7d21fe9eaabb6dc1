"""Head-pose evaluation on AFLW2000-3D and BIWI.

Counterpart of ``head_detector_tpu/evaluation/evaluate_pose.py`` (reference
``evaluation/evaluate_pose.py:45-304``).  Per image:
eval-predictor inference, head selection (AFLW: max IoU of the face-vertex
bbox vs the GT 68-landmark bbox; BIWI: detection closest to the (320,320)
image center), per-axis MAE with +-360 wrapping, GT rotations above 99 deg
skipped (AFLW), RPY zeroed when any predicted axis exceeds 135 deg.

Usage: ``python -m head_detector_tpu_torch.evaluation.evaluate_pose --aflw-dir ...
[--biwi-dir ...] [--checkpoint weights.msgpack] [--model yolo_heads_l]
[--device cpu]``
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path
from typing import Any, Optional, Tuple

import cv2
import numpy as np

from head_detector_tpu_torch.assets_io import load_flame_assets
from head_detector_tpu_torch.evaluation.predictor import EvalPredictor
from head_detector_tpu_torch.head_info import RPY
from head_detector_tpu_torch.metrics import rpy_from_flame_params
from head_detector_tpu_torch.post_prediction import YoloHeadsPredictions

MAX_ROTATION = 99


def _mae(x: float, y: float, pi: float = 180.0) -> float:
    return min(abs(x - y), abs(x - (y - 2 * pi)), abs(x - (y + 2 * pi)))


def _face_bbox(vertices_2d: np.ndarray) -> np.ndarray:
    pts = np.take(vertices_2d, load_flame_assets().face_indices, axis=0)
    return np.array(
        [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
    ).astype(int)


def _iou(b1, b2) -> float:
    x_overlap = max(0, min(b1[2], b2[2]) - max(b1[0], b2[0]))
    y_overlap = max(0, min(b1[3], b2[3]) - max(b1[1], b2[1]))
    inter = x_overlap * y_overlap
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    return inter / max(a1 + a2 - inter, 1e-9)


def _select(pred: YoloHeadsPredictions, index: int) -> YoloHeadsPredictions:
    return YoloHeadsPredictions(
        scores=pred.scores[index : index + 1],
        bboxes_xyxy=pred.bboxes_xyxy[index : index + 1],
        mm_params=pred.mm_params[index : index + 1],
        predicted_3d_vertices=pred.predicted_3d_vertices[index : index + 1],
        predicted_2d_vertices=pred.predicted_2d_vertices[index : index + 1],
    )


def pred_rpy(pred: YoloHeadsPredictions) -> RPY:
    rpy = rpy_from_flame_params(pred.mm_params[0])
    if any(abs(v) > 135 for v in rpy):
        return RPY(roll=0, pitch=0, yaw=0)  # ref "Rotation is too large" guard
    return rpy


class HeadPoseEvaluator:
    name = "pose"

    def __init__(self, data_dir: str, predictor: EvalPredictor):
        self.data_dir = data_dir
        self.predictor = predictor

    def get_gt_pose(self, label_path: str) -> Optional[Tuple[RPY, Any]]:
        raise NotImplementedError

    def find_images_and_labels(self, data_dir: str):
        raise NotImplementedError

    def select_head(self, pred: YoloHeadsPredictions, metadata: Any):
        raise NotImplementedError

    def __call__(self) -> dict:
        images, labels = self.find_images_and_labels(self.data_dir)
        rolls, pitches, yaws = [], [], []
        failed = 0
        for image_path, label_path in zip(images, labels):
            gt = self.get_gt_pose(str(label_path))
            if gt is None:
                continue
            gt_pose, metadata = gt
            image = cv2.imread(str(image_path))
            if image is None:
                failed += 1
                continue
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
            pred = self.predictor(image)
            if len(pred.scores) == 0:
                failed += 1
                continue
            if pred.bboxes_xyxy.shape[0] > 1:
                pred = self.select_head(pred, metadata)
            else:
                pred = _select(pred, 0)
            p = pred_rpy(pred)
            rolls.append(_mae(gt_pose.roll, p.roll))
            pitches.append(_mae(gt_pose.pitch, p.pitch))
            yaws.append(_mae(gt_pose.yaw, p.yaw))
        out = {
            "roll_mae": float(np.mean(rolls)) if rolls else float("nan"),
            "pitch_mae": float(np.mean(pitches)) if pitches else float("nan"),
            "yaw_mae": float(np.mean(yaws)) if yaws else float("nan"),
            "failed": failed,
            "evaluated": len(rolls),
        }
        out["mean_mae"] = float(
            np.mean([out["roll_mae"], out["pitch_mae"], out["yaw_mae"]])
        )
        print(f"[{self.name}] {out}")
        return out


class AFLWEvaluator(HeadPoseEvaluator):
    name = "aflw"

    def find_images_and_labels(self, data_dir: str):
        d = Path(data_dir)
        labels = sorted(d.glob("*.mat"))
        images = [d / (p.stem + ".jpg") for p in labels]
        return images, labels

    def get_gt_pose(self, label_path: str):
        import scipy.io

        mat = scipy.io.loadmat(label_path)
        pose_params = mat["Pose_Para"][0]
        degrees = pose_params[:3] * (180 / np.pi)
        if np.any(np.abs(degrees) > MAX_ROTATION):
            return None
        kp = np.asarray(mat["pt3d_68"]).T[:, :2]
        bbox = np.array([kp[:, 0].min(), kp[:, 1].min(), kp[:, 0].max(), kp[:, 1].max()]).astype(int)
        return RPY(roll=degrees[2], pitch=degrees[0], yaw=degrees[1]), bbox

    def select_head(self, pred: YoloHeadsPredictions, metadata):
        ious = [
            _iou(_face_bbox(v), metadata) for v in pred.predicted_2d_vertices
        ]
        return _select(pred, int(np.argmax(ious)))


class BIWIEvaluator(HeadPoseEvaluator):
    name = "biwi"

    def find_images_and_labels(self, data_dir: str):
        images = sorted(glob.glob(f"{data_dir}/**/*rgb.png", recursive=True))
        labels = [x.replace("rgb.png", "pose.txt") for x in images]
        return images, labels

    def get_gt_pose(self, label_path: str):
        rotation_matrix = np.loadtxt(label_path)[:3, :]
        r = np.transpose(rotation_matrix)
        roll = -np.arctan2(r[1][0], r[0][0]) * 180 / np.pi
        yaw = -np.arctan2(-r[2][0], np.sqrt(r[2][1] ** 2 + r[2][2] ** 2)) * 180 / np.pi
        pitch = np.arctan2(r[2][1], r[2][2]) * 180 / np.pi
        return RPY(roll=roll, pitch=pitch, yaw=yaw), None

    def select_head(self, pred: YoloHeadsPredictions, metadata):
        centers = (pred.bboxes_xyxy[:, :2] + pred.bboxes_xyxy[:, 2:]) / 2
        d = np.linalg.norm(centers - np.array([320.0, 320.0]), axis=1)
        return _select(pred, int(np.argmin(d)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--aflw-dir", default=None)
    ap.add_argument("--biwi-dir", default=None)
    ap.add_argument("--model", default="yolo_heads_l")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    predictor = EvalPredictor(
        model_name=args.model, checkpoint=args.checkpoint,
        confidence_threshold=0.5, nms_iou_threshold=0.5,
        post_nms_max_predictions=30, device=args.device,
    )
    results = {}
    if args.aflw_dir:
        results["aflw"] = AFLWEvaluator(args.aflw_dir, predictor)()
    if args.biwi_dir:
        results["biwi"] = BIWIEvaluator(args.biwi_dir, predictor)()
    return results


if __name__ == "__main__":
    main()
