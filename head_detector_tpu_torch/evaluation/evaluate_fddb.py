"""FDDB head-detection evaluation (COCO mAP protocol).

Counterpart of ``head_detector_tpu/evaluation/evaluate_fddb.py`` (reference
``evaluation/evaluate_fddb.py:42-247``).  It parses
``label.txt`` ('# path' header lines followed by x y x1 y1 boxes), runs the
640 eval predictor with conf 0.5 / iou 0.5 / post-nms 500, scores each image's
xywh+score detections with COCO mAP (native AP implementation replaces
pycocotools).

Usage: ``python -m head_detector_tpu_torch.evaluation.evaluate_fddb --data-dir
/path/to/FDDB [--checkpoint w.msgpack] [--model yolo_heads_l] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import cv2
import numpy as np

from head_detector_tpu_torch.evaluation.detection_ap import coco_map
from head_detector_tpu_torch.evaluation.predictor import EvalPredictor


def read_fddb_annotations(data_dir: str) -> Dict[str, List[List[int]]]:
    with open(os.path.join(data_dir, "label.txt")) as f:
        lines = f.readlines()
    annotations: Dict[str, List[List[int]]] = {}
    current = None
    for line in lines:
        line = line.strip()
        if line.startswith("#"):
            current = line[2:]
            annotations[current] = []
        elif line:
            x, y, x1, y1 = map(int, line.split())
            annotations[current].append([x, y, x1, y1])
    return annotations


def evaluate_fddb(data_dir: str, predictor: EvalPredictor) -> dict:
    annotations = read_fddb_annotations(data_dir)
    preds, gts = [], []
    skipped = 0
    for rel_path, boxes in annotations.items():
        image = cv2.imread(os.path.join(data_dir, "images", rel_path))
        if image is None:
            image = cv2.imread(os.path.join(data_dir, rel_path))
        if image is None:
            skipped += 1
            continue
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        p = predictor(image)
        preds.append((np.asarray(p.bboxes_xyxy), np.asarray(p.scores)))
        gts.append(np.asarray(boxes, np.float64).reshape(-1, 4))
    result = coco_map(preds, gts)
    result["skipped"] = skipped
    print(f"[fddb] {result}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--model", default="yolo_heads_l")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--image-size", type=int, default=640,
                    help="eval resolution (the protocol's 640; use the "
                         "training resolution for checkpoints trained "
                         "at another size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    predictor = EvalPredictor(
        model_name=args.model, checkpoint=args.checkpoint,
        image_size=args.image_size,
        confidence_threshold=0.5, nms_iou_threshold=0.5,
        pre_nms_max_predictions=1000, post_nms_max_predictions=500,
        device=args.device,
    )
    return evaluate_fddb(args.data_dir, predictor)


if __name__ == "__main__":
    main()
