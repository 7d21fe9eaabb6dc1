"""Single-class COCO-style detection AP, pure numpy.

The port's copy of ``head_detector_tpu/evaluation/detection_ap.py``.  It
replaces the reference's pycocotools dependency
(``evaluation/evaluate_fddb.py:194-234``, ``evaluate_wider.py:190-250``):
AP@[.50:.95:.05] with 101-point interpolated precision, greedy
highest-score-first matching per IoU threshold — the standard COCO protocol
restricted to one category and no area/maxdet stratification beyond
``max_dets``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(pred), len(gt)))
    lt = np.maximum(pred[:, None, :2], gt[None, :, :2])
    rb = np.minimum(pred[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_p = np.clip(pred[:, 2] - pred[:, 0], 0, None) * np.clip(pred[:, 3] - pred[:, 1], 0, None)
    area_g = np.clip(gt[:, 2] - gt[:, 0], 0, None) * np.clip(gt[:, 3] - gt[:, 1], 0, None)
    union = area_p[:, None] + area_g[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def coco_map(
    predictions: Sequence[Tuple[np.ndarray, np.ndarray]],
    ground_truths: Sequence[np.ndarray],
    max_dets: int = 100,
) -> Dict[str, float]:
    """
    :param predictions: per image, (boxes_xyxy [N,4], scores [N])
    :param ground_truths: per image, gt boxes_xyxy [M,4]
    :return: {"AP": AP@[.5:.95], "AP50": ..., "AP75": ..., "AR100": ...}
    """
    assert len(predictions) == len(ground_truths)
    num_gt = sum(len(g) for g in ground_truths)
    if num_gt == 0:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "AR100": 0.0}

    # flatten predictions with image ids, sorted by score desc
    recs = []
    matches_per_image = []
    for img_id, ((boxes, scores), gts) in enumerate(zip(predictions, ground_truths)):
        order = np.argsort(-scores)[:max_dets]
        boxes, scores = boxes[order], scores[order]
        iou = _iou_matrix(np.asarray(boxes, np.float64), np.asarray(gts, np.float64))
        matches_per_image.append(iou)
        for j, s in enumerate(scores):
            recs.append((float(s), img_id, j))
    recs.sort(key=lambda r: -r[0])

    aps = []
    recalls_at = []
    for t in IOU_THRESHOLDS:
        gt_used = [np.zeros(len(g), bool) for g in ground_truths]
        tp = np.zeros(len(recs))
        fp = np.zeros(len(recs))
        for k, (_, img_id, j) in enumerate(recs):
            iou = matches_per_image[img_id]
            if iou.shape[1] == 0:
                fp[k] = 1
                continue
            cand = iou[j].copy()
            cand[gt_used[img_id]] = -1.0
            best = cand.argmax()
            if cand[best] >= t:
                gt_used[img_id][best] = True
                tp[k] = 1
            else:
                fp[k] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        recall = ctp / num_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        # monotone precision envelope + 101-point interpolation
        for i in range(len(precision) - 2, -1, -1):
            precision[i] = max(precision[i], precision[i + 1])
        idx = np.searchsorted(recall, RECALL_POINTS, side="left")
        p_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
        aps.append(p_at.mean())
        recalls_at.append(recall[-1] if len(recall) else 0.0)

    aps = np.asarray(aps)
    return {
        "AP": float(aps.mean()),
        "AP50": float(aps[0]),
        "AP75": float(aps[5]),
        "AR100": float(np.mean(recalls_at)),
    }
