"""WIDER FACE val evaluation: COCO mAP + official per-event txt dump.

Counterpart of ``head_detector_tpu/evaluation/evaluate_wider.py`` (reference
``evaluation/evaluate_wider.py:42-263``).  It parses
``wider_face_split/wider_face_val_bbx_gt.txt`` (filename / count / xywh
rows), runs the eval predictor, scores COCO mAP, and writes the official
submission format (one txt per image under per-event directories:
filename, count, then ``x y w h score`` rows).

Usage: ``python -m head_detector_tpu_torch.evaluation.evaluate_wider --data-dir
/path/to/WIDER [--save-dir wider_eval] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import cv2
import numpy as np

from head_detector_tpu_torch.evaluation.detection_ap import coco_map
from head_detector_tpu_torch.evaluation.predictor import EvalPredictor


def read_wider_annotations(data_dir: str) -> Dict[str, List[List[int]]]:
    path = os.path.join(data_dir, "wider_face_split", "wider_face_val_bbx_gt.txt")
    with open(path) as f:
        lines = f.readlines()
    annotations: Dict[str, List[List[int]]] = {}
    i = 0
    while i < len(lines):
        filename = lines[i].strip()
        num_boxes = int(lines[i + 1].strip())
        boxes = []
        for j in range(num_boxes):
            vals = list(map(int, lines[i + 2 + j].strip().split()))
            boxes.append(vals[:4])  # xywh
        annotations[filename] = boxes
        i += 3 if num_boxes == 0 else 2 + num_boxes
    return annotations


def evaluate_wider(data_dir: str, predictor: EvalPredictor,
                   save_dir: str = "wider_eval") -> dict:
    annotations = read_wider_annotations(data_dir)
    preds, gts = [], []
    skipped = 0
    for rel_path, boxes in annotations.items():
        image_path = os.path.join(data_dir, "WIDER_val", "images", rel_path)
        image = cv2.imread(image_path)
        if image is None:
            skipped += 1
            continue
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        p = predictor(image)
        pred_boxes = np.asarray(p.bboxes_xyxy)
        scores = np.asarray(p.scores)
        preds.append((pred_boxes, scores))
        xywh = np.asarray(boxes, np.float64).reshape(-1, 4)
        xyxy = xywh.copy()
        xyxy[:, 2] = xywh[:, 0] + xywh[:, 2]
        xyxy[:, 3] = xywh[:, 1] + xywh[:, 3]
        gts.append(xyxy)

        # official per-event submission dump
        event_dir = os.path.join(save_dir, os.path.dirname(rel_path))
        os.makedirs(event_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(rel_path))[0]
        with open(os.path.join(event_dir, f"{stem}.txt"), "w") as f:
            f.write(f"{stem}\n{len(scores)}\n")
            for (x1, y1, x2, y2), s in zip(pred_boxes, scores):
                f.write(f"{x1:.1f} {y1:.1f} {x2 - x1:.1f} {y2 - y1:.1f} {s:.4f}\n")

    result = coco_map(preds, gts)
    result["skipped"] = skipped
    print(f"[wider] {result}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--save-dir", default="wider_eval")
    ap.add_argument("--model", default="yolo_heads_l")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    predictor = EvalPredictor(
        model_name=args.model, checkpoint=args.checkpoint,
        confidence_threshold=0.5, nms_iou_threshold=0.5,
        pre_nms_max_predictions=1000, post_nms_max_predictions=500,
        device=args.device,
    )
    return evaluate_wider(args.data_dir, predictor, args.save_dir)


if __name__ == "__main__":
    main()
