"""Validation metrics: KeypointsNME, KeypointsFailureRate, RPYError.

Counterpart of ``head_detector_tpu/metrics.py`` (host numpy, after the
post-prediction decode).  Matching is IoU Hungarian assignment (scipy
``linear_sum_assignment``) with ``min_iou`` 0.5; NME folds detection
accuracy in as ``nme / acc``; failure rate folds as ``1 - (1 - fr) * acc``;
RPY errors are per-axis MAE with +-360-degree wrapping, divided by
accuracy.  Every metric keeps its states as sums (``_STATE_FIELDS``), so
``merge`` of per-shard instances is exact; the all-reduce across cards
(``reduce_metrics_across_mesh``) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from scipy.spatial.transform import Rotation

from head_detector_tpu_torch.assets_io import get_indices
from head_detector_tpu_torch.head_info import RPY, FlameParams
from head_detector_tpu_torch.ops.rotation import rot_mat_from_6dof
from head_detector_tpu_torch.post_prediction import (
    YoloHeadsPostPredictionCallback,
    YoloHeadsPredictions,
)
from head_detector_tpu_torch.train.mesh_sample import MeshEstimationSample


@dataclasses.dataclass
class HeadsMatchingResult:
    tp_matches: List[Tuple[int, int]]
    fp_indexes: List[int]
    fn_indexes: List[int]


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def xywh_to_xyxy_np(b: np.ndarray) -> np.ndarray:
    out = np.asarray(b, np.float32).copy()
    out[:, 2] = out[:, 0] + out[:, 2]
    out[:, 3] = out[:, 1] + out[:, 3]
    return out


def match_head_boxes(
    pred_boxes_xyxy: np.ndarray, true_boxes_xyxy: np.ndarray, min_iou: float
) -> HeadsMatchingResult:
    """IoU Hungarian matching (ref functional.py:21-45)."""
    iou = box_iou_np(np.asarray(pred_boxes_xyxy), np.asarray(true_boxes_xyxy))
    if iou.size == 0:
        return HeadsMatchingResult(
            tp_matches=[],
            fp_indexes=list(range(pred_boxes_xyxy.shape[0])),
            fn_indexes=list(range(true_boxes_xyxy.shape[0])),
        )
    row_ind, col_ind = linear_sum_assignment(iou, maximize=True)
    tp = [(r, c) for r, c in zip(row_ind, col_ind) if iou[r, c] >= min_iou]
    # preserved verbatim from the reference (functional.py:43-44), including
    # its quirk of checking pred indexes against col_ind / gt against row_ind
    fp = [i for i in range(pred_boxes_xyxy.shape[0]) if i not in col_ind]
    fn = [i for i in range(true_boxes_xyxy.shape[0]) if i not in row_ind]
    return HeadsMatchingResult(tp_matches=tp, fp_indexes=fp, fn_indexes=fn)


def keypoints_nme(
    output_kp: np.ndarray, target_kp: np.ndarray, bbox_xywh: Optional[np.ndarray]
) -> float:
    """Mean L2 error normalised by sqrt(bbox area) (ref nme.py:17-33)."""
    err = np.linalg.norm(output_kp - target_kp, axis=-1).mean()
    norm = math.sqrt(bbox_xywh[2] * bbox_xywh[3]) if bbox_xywh is not None else 2.0
    return float(err / norm)


def _angle_mae(x: float, y: float, pi: float = 180.0) -> float:
    return min(abs(x - y), abs(x - (y - 2 * pi)), abs(x - (y + 2 * pi)))


def _limit_angle(angle: float, pi: float = 180.0) -> float:
    if angle < -pi:
        k = -2 * (int(angle / pi) // 2)
        angle = angle + k * pi
    if angle > pi:
        k = 2 * ((int(angle / pi) + 1) // 2)
        angle = angle - k * pi
    return angle


def rpy_from_rotation_mat(rot_mat: np.ndarray) -> RPY:
    angle = Rotation.from_matrix(np.transpose(rot_mat)).as_euler("xyz", degrees=True)
    roll, pitch, yaw = (
        _limit_angle(angle[2]),
        _limit_angle(angle[0] - 180),
        _limit_angle(angle[1]),
    )
    return RPY(roll=roll, pitch=pitch, yaw=yaw)


def rpy_from_flame_params(mm_params_row: np.ndarray) -> RPY:
    p = FlameParams.from_3dmm(np.asarray(mm_params_row, np.float32).reshape(1, -1))
    rot = rot_mat_from_6dof(torch.from_numpy(np.ascontiguousarray(p.rotation)))[0]
    return rpy_from_rotation_mat(rot.numpy())


class _MatchedMetric:
    """Common update loop: decode -> Hungarian match -> per-TP accumulation."""

    _STATE_FIELDS: Tuple[str, ...] = ("total", "total_tp")

    def merge(self, *others: "_MatchedMetric") -> "_MatchedMetric":
        """Host-side sum of per-shard metric states into ``self``."""
        for other in others:
            if other._STATE_FIELDS != self._STATE_FIELDS:
                raise ValueError("cannot merge different metric classes")
            for f in self._STATE_FIELDS:
                setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def __init__(
        self,
        post_prediction_callback: YoloHeadsPostPredictionCallback,
        indexes_subset: Union[str, None] = None,
        min_iou: float = 0.5,
    ):
        self.post_prediction_callback = post_prediction_callback
        self.min_iou = min_iou
        self.indexes_subset = (
            np.asarray(get_indices()[indexes_subset], np.int64)
            if indexes_subset is not None
            else None
        )
        self.total = 0.0
        self.total_tp = 0.0

    def _iterate_matches(self, preds, gt_samples: Sequence[MeshEstimationSample]):
        predictions: List[YoloHeadsPredictions] = self.post_prediction_callback(preds)
        assert len(predictions) == len(gt_samples)
        for pred, gt in zip(predictions, gt_samples):
            match = match_head_boxes(
                pred.bboxes_xyxy, xywh_to_xyxy_np(gt.bboxes_xywh), self.min_iou
            )
            for pred_index, true_index in match.tp_matches:
                yield pred, gt, pred_index, true_index
                self.total_tp += 1.0
            self.total += float(
                len(match.fp_indexes) + len(match.fn_indexes) + len(match.tp_matches)
            )

    def _subset(self, kp: np.ndarray) -> np.ndarray:
        return kp[self.indexes_subset] if self.indexes_subset is not None else kp


class KeypointsNME(_MatchedMetric):
    """weight * mean-NME over TPs, divided by detection accuracy
    (ref nme.py:35-124)."""

    _STATE_FIELDS = ("total", "total_tp", "nme")

    def __init__(self, post_prediction_callback, indexes_subset="head",
                 min_iou: float = 0.5, weight: int = 100):
        super().__init__(post_prediction_callback, indexes_subset, min_iou)
        self.weight = weight
        self.nme = 0.0

    def update(self, preds, gt_samples: Sequence[MeshEstimationSample]):
        for pred, gt, pi, ti in self._iterate_matches(preds, gt_samples):
            p_kp = self._subset(pred.predicted_2d_vertices[pi][..., :2])
            t_kp = self._subset(gt.vertices_2d[ti][..., :2])
            self.nme += keypoints_nme(p_kp, t_kp, gt.bboxes_xywh[ti])

    def compute(self) -> float:
        acc = self.total_tp / self.total if self.total else 0
        if acc <= 0:
            return float(self.weight)
        return float(self.weight * (self.nme / self.total_tp) / acc)


class KeypointsFailureRate(_MatchedMetric):
    """Share of TPs with NME > threshold*IOD, folded with accuracy
    (ref failure_rate.py:34-120)."""

    _STATE_FIELDS = ("total", "total_tp", "failure_rate")

    def __init__(self, post_prediction_callback, indexes_subset="head",
                 min_iou: float = 0.5, threshold: float = 0.05, below: bool = True):
        super().__init__(post_prediction_callback, indexes_subset, min_iou)
        self.threshold = threshold
        self.below = below
        self.failure_rate = 0.0

    def update(self, preds, gt_samples: Sequence[MeshEstimationSample]):
        for pred, gt, pi, ti in self._iterate_matches(preds, gt_samples):
            p_kp = self._subset(pred.predicted_2d_vertices[pi][..., :2])
            t_kp = self._subset(gt.vertices_2d[ti][..., :2])
            bbox = gt.bboxes_xywh[ti]
            err = np.linalg.norm(p_kp - t_kp, axis=-1).mean()
            norm = math.sqrt(bbox[2] * bbox[3])
            failed = err > self.threshold * norm if self.below else err < self.threshold * norm
            self.failure_rate += float(failed)

    def compute(self) -> float:
        if self.total_tp == 0:
            return 1.0
        acc = self.total_tp / self.total if self.total else 0
        fr = self.failure_rate / self.total_tp
        return float(1 - (1 - fr) * acc)


class RPYError(_MatchedMetric):
    """Per-axis roll/pitch/yaw MAE with 360-wrap, divided by accuracy
    (ref rpy.py:19-133)."""

    _STATE_FIELDS = ("total", "total_tp", "roll", "pitch", "yaw")

    def __init__(self, post_prediction_callback, min_iou: float = 0.5):
        super().__init__(post_prediction_callback, None, min_iou)
        self.roll = 0.0
        self.pitch = 0.0
        self.yaw = 0.0

    def update(self, preds, gt_samples: Sequence[MeshEstimationSample]):
        for pred, gt, pi, ti in self._iterate_matches(preds, gt_samples):
            pred_rpy = rpy_from_flame_params(pred.mm_params[pi])
            true_rpy = rpy_from_rotation_mat(gt.rotation_matrix[ti])
            self.roll += _angle_mae(pred_rpy.roll, true_rpy.roll)
            self.pitch += _angle_mae(pred_rpy.pitch, true_rpy.pitch)
            self.yaw += _angle_mae(pred_rpy.yaw, true_rpy.yaw)

    def compute(self) -> dict:
        if self.total_tp == 0:
            return {"RPY_roll": 100, "RPY_pitch": 100, "RPY_yaw": 100, "RPY_mean": 100}
        acc = self.total_tp / self.total
        roll = (self.roll / self.total_tp) / acc
        pitch = (self.pitch / self.total_tp) / acc
        yaw = (self.yaw / self.total_tp) / acc
        return {
            "RPY_roll": float(roll),
            "RPY_pitch": float(pitch),
            "RPY_yaw": float(yaw),
            "RPY_mean": float(roll + pitch + yaw) / 3,
        }
