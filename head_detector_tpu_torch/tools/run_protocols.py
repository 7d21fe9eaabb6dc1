"""Run the DAD and FDDB evaluation protocols in ONE process.

Counterpart of ``tools/run_protocols.py``.  ``EvalPredictor`` applies its
post-prediction callback after the forward, so one predictor (one model on
the card) serves both protocols by swapping the callback: the DAD pass
(conf 0.2, NMS 0.5, post-NMS 30; reference ``evaluate_dad.py:236-316``) and
the FDDB pass (conf 0.5, NMS 0.5, pre 1000 / post 500; reference
``evaluate_fddb.py:194-234``).  It writes the reference's JSON with one key
more, ``seconds``: each pass's host seconds.

Usage::

    python -m head_detector_tpu_torch.tools.run_protocols \\
        --checkpoint checkpoints/flagship_ema.msgpack --arch yolo_heads_m \\
        --image-size 512 --dad-json runs/dad_standin/dataset.json \\
        --dad-base runs/dad_standin --fddb-dir runs/fddb_standin \\
        [--out runs/protocols.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--arch", default="yolo_heads_m")
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--dad-json", default="runs/dad_standin/dataset.json")
    ap.add_argument("--dad-base", default="runs/dad_standin")
    ap.add_argument("--fddb-dir", default="runs/fddb_standin")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from head_detector_tpu_torch.evaluation.evaluate_dad import DadEvaluator, DadSample
    from head_detector_tpu_torch.evaluation.evaluate_fddb import evaluate_fddb
    from head_detector_tpu_torch.evaluation.predictor import EvalPredictor
    from head_detector_tpu_torch.post_prediction import YoloHeadsPostPredictionCallback

    results = {"checkpoint": args.checkpoint, "arch": args.arch,
               "image_size": args.image_size}

    # DAD protocol settings (ref evaluate_dad.py:236-316)
    predictor = EvalPredictor(
        model_name=args.arch, checkpoint=args.checkpoint,
        image_size=args.image_size,
        confidence_threshold=0.2, nms_iou_threshold=0.5,
        post_nms_max_predictions=30, device=args.device,
    )
    with open(args.dad_json) as f:
        data = json.load(f)
    samples = []
    for _, values in data.items():
        samples += [DadSample.from_config(cfg, args.dad_base) for cfg in values]
    print(f"[protocols] DAD pass over {len(samples)} samples", flush=True)
    seconds = {}
    t0 = time.perf_counter()
    results["dad"] = DadEvaluator(samples, predictor)()
    seconds["dad"] = time.perf_counter() - t0

    # FDDB protocol settings (ref evaluate_fddb.py:194-234): swap the
    # callback only; the model is reused
    predictor.callback = YoloHeadsPostPredictionCallback(
        flame_model=predictor.flame,
        confidence_threshold=0.5, nms_iou_threshold=0.5,
        pre_nms_max_predictions=1000, post_nms_max_predictions=500,
    )
    print("[protocols] FDDB pass", flush=True)
    t0 = time.perf_counter()
    results["fddb"] = evaluate_fddb(args.fddb_dir, predictor)
    seconds["fddb"] = time.perf_counter() - t0
    results["seconds"] = seconds

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
        print(f"[protocols] wrote {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
