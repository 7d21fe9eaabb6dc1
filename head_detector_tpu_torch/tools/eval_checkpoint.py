"""Score a training step directory (raw and/or EMA parameters) on the
rendered validation protocol, and export its weights as a flax msgpack.

Counterpart of ``tools/eval_checkpoint.py``, over the port's step
directories (``{ckpt_dir}/{step}/state.pt``, ``train/checkpoint.py``) in
place of orbax's.  The trainer validates with the EMA parameters; this tool
scores both parameter sets of any saved step, so the learning curve of the
raw model is visible beside the EMA-lagged metric of record.  Either set is
paired with the step's BatchNorm statistics, as the reference pairs
``ema_params`` with ``batch_stats``.

``--export-msgpack PATH`` writes the first ``--which`` set as a flax
``{params, batch_stats}`` msgpack (``weights.save_variables``; ``--export-dtype
f16`` casts the float32 leaves to float16) with a ``PATH.json`` sidecar
(arch, image size, which, step, dtype) that ``HeadDetector``, the
``StreamingDetector`` and the JAX package read.

Usage::

    python -m head_detector_tpu_torch.tools.eval_checkpoint \\
        --ckpt-dir runs/flagship_campaign [--step 1024] [--arch yolo_heads_m] \\
        [--image-size 512] [--which both] [--data-dir runs/synth512] \\
        [--export-msgpack best_ema.msgpack --export-dtype f16] [--no-eval] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

import numpy as np
import torch


def cast_float32_leaves(tree, dtype):
    """Every float32 leaf of a nested dict cast to ``dtype``; others as they are."""
    if isinstance(tree, dict):
        return {k: cast_float32_leaves(v, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    return arr.astype(dtype) if arr.dtype == np.float32 else arr


def step_variables(restored: Dict[str, Any], kind: str) -> Dict[str, Any]:
    """A restored step's ``raw`` or ``ema`` parameters with its BatchNorm
    statistics, as a flax ``{params, batch_stats}`` tree of float32 arrays."""
    from head_detector_tpu_torch.weights import flax_from_state_dict

    params = restored["params"] if kind == "raw" else restored["ema_params"]
    return flax_from_state_dict({**params, **restored["batch_stats"]})


def export_variables(variables: Dict[str, Any], path: str, meta: Dict[str, Any],
                     dtype: str = "f32") -> None:
    """``variables`` (float32 leaves cast to float16 for ``dtype="f16"``) to
    ``path`` as flax msgpack, and ``meta`` with the dtype to ``path.json``."""
    from head_detector_tpu_torch.weights import save_variables

    out = cast_float32_leaves(variables, np.float16) if dtype == "f16" else variables
    save_variables(out, path)
    with open(path + ".json", "w") as f:
        json.dump({**meta, "dtype": dtype}, f)


@torch.no_grad()
def evaluate(variables, model, flame, dataset, batch_size=16, max_boxes=30,
             param_fusion=False, fusion_iou=0.7, confidence_threshold=0.5,
             num_workers=4) -> Dict[str, float]:
    """The trainer's validation metrics of ``variables`` (a flax training-
    layout tree) loaded into ``model`` (training layout, on the device of
    ``flame``) over ``dataset``."""
    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.metrics import KeypointsFailureRate, KeypointsNME, RPYError
    from head_detector_tpu_torch.post_prediction import YoloHeadsPostPredictionCallback
    from head_detector_tpu_torch.train.runner import _Prefetcher, _targets_to_samples
    from head_detector_tpu_torch.train.trainer import images_to_device
    from head_detector_tpu_torch.weights import train_state_dict_from_flax

    callback = YoloHeadsPostPredictionCallback(
        flame_model=flame,
        confidence_threshold=confidence_threshold,
        nms_iou_threshold=0.7,
        pre_nms_max_predictions=300,
        post_nms_max_predictions=30,
        param_fusion=param_fusion,
        fusion_iou=fusion_iou,
    )
    metrics = {
        "KeypointsNME": KeypointsNME(callback, indexes_subset="head"),
        "KeypointsFailureRate": KeypointsFailureRate(callback, indexes_subset="head"),
        "RPYError": RPYError(callback),
    }
    state, _ = train_state_dict_from_flax(variables)
    model.load_state_dict(state, strict=True)
    model.eval()
    loader = _Prefetcher(dataset, batch_size, max_boxes, num_workers=num_workers, seed=0)
    n_images = 0
    for i, (images, targets) in enumerate(loader):
        with exact_float32():
            decoded, _ = model(images_to_device(images, flame.device))
        gt_samples = _targets_to_samples(images, targets)
        n_images += len(gt_samples)
        for m in metrics.values():
            m.update(decoded, gt_samples)
        if i % 8 == 0:
            print(f"[eval] batch {i} ({n_images} imgs)", flush=True)
    out: Dict[str, float] = {}
    for name, m in metrics.items():
        val = m.compute()
        if isinstance(val, dict):
            out.update({k: float(v) for k, v in val.items()})
        else:
            out[name] = float(val)
    out["images"] = n_images
    return out


def main(argv=None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--step", type=int, default=None, help="default: latest")
    ap.add_argument("--arch", default="yolo_heads_n")
    ap.add_argument("--image-size", type=int, default=320)
    ap.add_argument("--val-length", type=int, default=64)
    ap.add_argument("--max-heads", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--max-boxes", type=int, default=30,
                    help="GT pad width (match the trainer's max_gt_boxes so "
                         "crowd scenes are not silently truncated)")
    ap.add_argument("--which", choices=["raw", "ema", "both"], default="both")
    ap.add_argument("--data-dir", default=None,
                    help="VGGHeads-layout dataset root: score the on-disk "
                         "val split instead of the procedural generator")
    ap.add_argument("--val-split", default="val")
    ap.add_argument("--export-dtype", choices=["f32", "f16"], default="f32",
                    help="dtype for --export-msgpack leaves; f16 halves the artifact")
    ap.add_argument("--export-msgpack", default=None,
                    help="also write {params,batch_stats} (first --which "
                         "kind) as a flax msgpack for HeadDetector")
    ap.add_argument("--no-eval", action="store_true",
                    help="skip metric evaluation (export-only)")
    ap.add_argument("--param-fusion", action="store_true",
                    help="WBF-style score-weighted FLAME-row fusion over "
                         "each kept box's suppressed neighbor anchors "
                         "(ops/nms.py); detection matching is unchanged")
    ap.add_argument("--fusion-iou", type=float, default=0.7)
    ap.add_argument("--conf", type=float, default=0.5,
                    help="decode confidence threshold (protocol: 0.5)")
    ap.add_argument("--average-best", type=int, default=0, metavar="N",
                    help="score the uniform weight-average of the N best "
                         "on-disk checkpoints by the watched metric (the "
                         "reference's average_best_models); overrides --step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from head_detector_tpu_torch.device import resolve_device
    from head_detector_tpu_torch.train.checkpoint import CheckpointManager, average_trees

    device = resolve_device(args.device)
    mgr = CheckpointManager(args.ckpt_dir)
    if args.average_best > 0:
        best = mgr.best_steps(args.average_best)
        if not best:
            raise SystemExit("no metric history / on-disk steps to average")
        print(f"averaging {len(best)} best steps: {sorted(best)}")
        restored = average_trees([mgr.restore(s) for s in best])
        step = f"avg{len(best)}:{'+'.join(str(s) for s in sorted(best))}"
    else:
        step = args.step if args.step is not None else mgr.latest_step()
        restored = mgr.restore(step)

    results: Dict[str, Dict[str, float]] = {}
    which = ["raw", "ema"] if args.which == "both" else [args.which]
    model = flame = dataset = None
    for i, kind in enumerate(which):
        variables = step_variables(restored, kind)
        if i == 0 and args.export_msgpack:
            export_variables(variables, args.export_msgpack,
                             {"arch": args.arch, "image_size": args.image_size,
                              "which": kind, "step": str(step)}, args.export_dtype)
            print(f"[step {step}] wrote {kind} msgpack: {args.export_msgpack}")
        if args.no_eval:
            continue
        if model is None:
            from head_detector_tpu_torch.flame import FlameModel
            from head_detector_tpu_torch.models import build_model

            model = build_model(args.arch, deploy=False).to(device)
            flame = FlameModel.from_assets(device=device)
            dataset = _val_dataset(args, flame)
        results[kind] = evaluate(variables, model, flame, dataset,
                                 batch_size=args.batch_size, max_boxes=args.max_boxes,
                                 param_fusion=args.param_fusion, fusion_iou=args.fusion_iou,
                                 confidence_threshold=args.conf)
        print(f"[step {step}] {kind}: {results[kind]}")
    return results


def _val_dataset(args, flame):
    if args.data_dir:
        from head_detector_tpu_torch.train.dataset import DAD3DHeadsDataset
        from head_detector_tpu_torch.train.transforms import default_val_transforms

        return DAD3DHeadsDataset(args.data_dir, splits=[args.val_split],
                                 transforms=default_val_transforms(args.image_size))
    from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset

    # the held-out val renders: seed offset 1 from the train set, as the
    # trainer's entry point does
    return SyntheticHeadsDataset(flame, image_size=args.image_size, length=args.val_length,
                                 max_heads=args.max_heads, seed=1, render=True,
                                 device=flame.device)


if __name__ == "__main__":
    main()
