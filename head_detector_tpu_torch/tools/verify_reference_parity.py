"""Reference-parity runner: one command from a checkpoint to a pass/fail
report of the port against a TorchScript reference, at the rebuild's bar.

Counterpart of ``tools/verify_reference_parity.py`` and
``tools/layer_diff.py``, which hold the JAX model against a torch twin.  The
port is torch itself, so it runs the reference's own ``.trcd`` (the
artifact the reference ships: ``exportable_mesh_model.py:440-442``, a
``torch.jit.trace`` of the whole model) and holds its own outputs against it:

1. the checkpoint: ``.pth``/``.pt``/``.ckpt``/``.msgpack`` through
   ``weights.load_variables``; a ``.trcd`` through ``torch.jit.load``, its
   SuperGradients state dict converted by ``tools/convert_torch_checkpoint``
   (the table that ``torch_mirror.sg_state_dict`` inverts);
2. the port's model in the tree's layout (the training layout for a
   SuperGradients checkpoint; the deploy layout where the QARepVGG blocks
   come fused as ``rbr_reparam``), dense FLAME towers, globalised, in eval
   mode; for a training-layout tree the names are held to the table both
   ways: ``sg_state_dict(convert(sd))`` gives ``sd`` back leaf for leaf;
3. against the reference module (``--reference``, else the checkpoint itself
   when it is a ``.trcd``) run on the same device: the stages (backbone
   c2-c5, neck p3-p5) of a random image, the max |diff| each, relative to
   the stage's magnitude above 1 (bar ``STAGE_TOL``), where the reference
   has ``backbone`` and ``neck`` submodules;
4. end to end on a battery of seeded random images: boxes, scores and FLAME
   rows; over the 100 anchors of highest reference score, the box IoU
   (>= 0.99) and the posed-vertex L2 relative to the coordinates' magnitude
   (<= 1e-3), the bar of ``BASELINE.md``.

``--self-test`` needs no outside file: a seeded random SuperGradients state
(the JAX tool's recipe over the names of ``sg_state_dict``) is saved as
``<arch>_selftest.pth``, exported through ``torch_mirror.export_torchscript``
as ``<arch>_selftest.trcd``, and the chain is verified twice: the ``.pth``
against the ``.trcd``, and the ``.trcd`` alone.

Usage::

    python -m head_detector_tpu_torch.tools.verify_reference_parity ckpt_best.pth \\
        --reference vgg_heads_l.trcd --arch yolo_heads_l [--device cpu]
    python -m head_detector_tpu_torch.tools.verify_reference_parity vgg_heads_l.trcd \\
        --arch yolo_heads_l
    python -m head_detector_tpu_torch.tools.verify_reference_parity --self-test \\
        --arch yolo_heads_n --size 64 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

VERTEX_L2_THRESHOLD = 1e-3
BBOX_IOU_THRESHOLD = 0.99
STAGE_TOL = 5e-3
STAGES = ("c2", "c3", "c4", "c5", "p3", "p4", "p5")
TOP_ANCHORS = 100


def load_checkpoint(path: str, device) -> tuple:
    """(flax tree of numpy leaves, the TorchScript module or None)."""
    from head_detector_tpu_torch.tools.convert_torch_checkpoint import convert
    from head_detector_tpu_torch.weights import count_leaves, load_variables

    if path.endswith((".trcd", ".jit")):
        module = torch.jit.load(path, map_location=device).eval()
        tree, _ = convert({k: v.cpu() for k, v in module.state_dict().items()})
        if not count_leaves(tree):
            raise ValueError(f"{path} holds no backbone/neck/heads tensors")
        return tree, module
    return load_variables(path), None


def is_deploy_tree(tree) -> bool:
    def walk(node):
        return isinstance(node, dict) and ("rbr_reparam" in node
                                           or any(walk(v) for v in node.values()))
    return walk(tree["params"])


def build_port_model(arch, tree, device):
    """The port's model of ``tree`` in its layout, dense towers, globalised,
    float32, eval mode, on ``device``."""
    from head_detector_tpu_torch.models import build_model, get_arch
    from head_detector_tpu_torch.weights import state_dict_from_flax, train_state_dict_from_flax

    arch = get_arch(arch) if isinstance(arch, str) else arch
    deploy = is_deploy_tree(tree)
    net = build_model(arch, defer_globalization=False, skip_flame=False, deploy=deploy)
    state, _ = (state_dict_from_flax(tree, arch) if deploy
                else train_state_dict_from_flax(tree))
    net.load_state_dict(state, strict=True)
    return net.to(device).eval()


def table_roundtrip(tree, arch) -> float:
    """Max |diff| of ``convert(sg_state_dict(tree))`` against ``tree``, leaf
    for leaf (inf if a leaf is missing or extra)."""
    from head_detector_tpu_torch.tools.convert_torch_checkpoint import convert
    from head_detector_tpu_torch.torch_mirror import sg_state_dict

    back, _ = convert(sg_state_dict(tree, arch))
    worst = 0.0

    def walk(a, b):
        nonlocal worst
        if set(a) != set(b):
            worst = float("inf")
            return
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                d = np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
                worst = max(worst, float(d.max()) if d.size else 0.0)

    walk(tree, back)
    return worst


def _traced_parent(reference):
    """The module holding ``backbone`` and ``neck``, or None."""
    for _, sub in reference.named_modules():
        if {"backbone", "neck"} <= {n for n, _ in sub.named_children()}:
            return sub
    return None


def _neck_arguments(parent) -> list:
    """For each argument of a traced ``neck``, the index of the traced
    ``backbone``'s output that the parent's graph passes there.  A traced
    submodule may list its outputs and arguments in another order than its
    source, so the parent's graph is the one record of the wiring."""
    calls = {}
    for node in parent.graph.nodes():
        if node.kind() == "prim::CallMethod":
            owner = node.inputsAt(0).node()
            if owner.kind() == "prim::GetAttr":
                calls[owner.s("name")] = node
    unpack = next(u.user for u in calls["backbone"].outputsAt(0).uses()
                  if u.user.kind() == "prim::TupleUnpack")
    outputs = [v.unique() for v in unpack.outputs()]
    return [outputs.index(a.unique()) for a in list(calls["neck"].inputs())[1:]]


def _in_order(ours, theirs) -> list:
    """``theirs`` in the order of ``ours``, matched by shape (each stage has
    its own)."""
    theirs = list(theirs)
    shapes = [tuple(t.shape) for t in theirs]
    if len(set(shapes)) != len(shapes) or len(theirs) != len(ours):
        raise ValueError(f"cannot match the reference's stages by shape: {shapes}")
    return [theirs[shapes.index(tuple(a.shape))] for a in ours]


def stage_diffs(model, reference, image: torch.Tensor) -> Dict[str, float]:
    """Max |diff| of the backbone (c2-c5) and neck (p3-p5) outputs over the
    reference's largest |value| where that exceeds 1 (a random network's
    activations grow stage by stage: at yolo_heads_m, 640 px, c5 reaches
    ~1e6, where float32 carries ~1e-1), or {} when the reference has no
    module holding ``backbone`` and ``neck``."""
    from head_detector_tpu_torch.device import exact_float32

    parent = _traced_parent(reference)
    if parent is None:
        return {}
    with torch.no_grad(), exact_float32():
        c = list(model.backbone(image))
        p = list(model.neck(c))
        tc = list(parent.backbone(image))
        if isinstance(parent, torch.jit.ScriptModule):  # the pyramid as separate arguments
            tp = parent.neck(*[tc[i] for i in _neck_arguments(parent)])
        else:
            tp = parent.neck(tc)
    return {n: float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
            for n, a, b in zip(STAGES, c + p, _in_order(c, tc) + _in_order(p, tp))}


def battery(seed: int, size: int, n_images: int):
    """The end-to-end images: seeded uniform [0, 1) images, NCHW float32."""
    return [torch.from_numpy(np.random.RandomState(seed + 100 + i).rand(1, size, size, 3)
                             .astype(np.float32).transpose(0, 3, 1, 2).copy())
            for i in range(n_images)]


def decode(model, image: torch.Tensor):
    """(boxes [A, 4], scores [A], flame [A, 413]) of one image, on the CPU."""
    from head_detector_tpu_torch.device import exact_float32

    with torch.no_grad(), exact_float32():
        out = model(image)
    if isinstance(out, tuple) and len(out) == 2:  # the port's (decoded, raw)
        out = (out[0].boxes_xyxy, out[0].scores, out[0].flame_params)
    boxes, scores, flame = (o.detach().float().cpu()[0] for o in out)
    return boxes, scores.reshape(-1), flame


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1, y1 = np.maximum(a[:, 0], b[:, 0]), np.maximum(a[:, 1], b[:, 1])
    x2, y2 = np.minimum(a[:, 2], b[:, 2]), np.minimum(a[:, 3], b[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)

    def area(b):
        return np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)

    union = area(a) + area(b) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 1.0)


def posed_vertex_l2(flame_model, ours: torch.Tensor, theirs: torch.Tensor) -> float:
    """Max posed-vertex L2 of two sets of FLAME rows, relative to the
    coordinates' magnitude (a random network's exp-clipped scales would
    otherwise turn float32 noise into large absolute numbers)."""
    from head_detector_tpu_torch.flame import reproject_spatial_vertices

    dev = flame_model.device
    vo = reproject_spatial_vertices(flame_model, ours.to(dev), to_2d=False)[2].cpu().double()
    vt = reproject_spatial_vertices(flame_model, theirs.to(dev), to_2d=False)[2].cpu().double()
    l2 = float(torch.linalg.norm(vo - vt, dim=-1).max())
    return l2 / max(1.0, float(vt.abs().max()))


def verify(ckpt: str, arch: str = "yolo_heads_l", size: int = 640, n_images: int = 4,
           seed: int = 0, reference: Optional[str] = None, device="cuda",
           print_fn=print) -> Dict[str, object]:
    """The chain of the module docstring for ``ckpt``; returns the report,
    ``report["pass"]`` the verdict."""
    from head_detector_tpu_torch.device import resolve_device
    from head_detector_tpu_torch.flame import FlameModel

    dev = resolve_device(device)
    report: Dict[str, object] = {"arch": arch, "checkpoint": ckpt, "reference": reference,
                                 "device": str(dev)}
    tree, module = load_checkpoint(ckpt, dev)
    ref = torch.jit.load(reference, map_location=dev).eval() if reference else module
    report["layout"] = "deploy" if is_deploy_tree(tree) else "training"
    model = build_port_model(arch, tree, dev)
    print_fn(f"[parity] {ckpt}: {report['layout']} layout, "
             f"{sum(p.numel() for p in model.parameters())} parameters")
    if report["layout"] == "training":
        report["table_roundtrip"] = table_roundtrip(tree, arch)
        print_fn(f"[parity] SuperGradients names both ways: max|diff| "
                 f"{report['table_roundtrip']:.3e}")
    if ref is None:
        raise ValueError("no reference module: give --reference X.trcd (or a .trcd checkpoint)")

    image = battery(seed, size, 1)[0].to(dev)
    stages = stage_diffs(model, ref, image)
    report["stage_diffs"] = stages
    for name, d in stages.items():
        print_fn(f"[parity] {name:<4}{d:>12.3e}")

    flame_model = FlameModel.from_assets(device=dev)
    worst = {"box": 0.0, "score": 0.0, "flame": 0.0}
    min_iou, max_l2 = 1.0, 0.0
    for x in battery(seed, size, n_images):
        ob, os_, of = decode(model, x.to(dev))
        tb, ts, tf = decode(ref, x.to(dev))
        for key, a, b in (("box", ob, tb), ("score", os_, ts), ("flame", of, tf)):
            worst[key] = max(worst[key], float((a - b).abs().max()))
        sel = torch.argsort(-ts)[:TOP_ANCHORS]
        min_iou = min(min_iou, float(box_iou(ob[sel].numpy(), tb[sel].numpy()).min()))
        max_l2 = max(max_l2, posed_vertex_l2(flame_model, of[sel], tf[sel]))
    report.update(max_box_diff=worst["box"], max_score_diff=worst["score"],
                  max_flame_diff=worst["flame"], min_bbox_iou=min_iou, max_vertex_l2=max_l2)
    ok = (all(d < STAGE_TOL for d in stages.values())
          and report.get("table_roundtrip", 0.0) == 0.0
          and min_iou >= BBOX_IOU_THRESHOLD and max_l2 <= VERTEX_L2_THRESHOLD)
    report["pass"] = bool(ok)
    print_fn(f"[parity] boxes max|d|={worst['box']:.3e} scores={worst['score']:.3e} "
             f"flame={worst['flame']:.3e}")
    print_fn(f"[parity] min bbox IoU={min_iou:.5f} (>= {BBOX_IOU_THRESHOLD}), max vertex "
             f"L2={max_l2:.3e} (<= {VERTEX_L2_THRESHOLD})")
    print_fn(f"[parity] RESULT: {'PASS' if ok else 'FAIL'}")
    return report


def random_sg_state(arch, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded random SuperGradients state of ``arch`` by the JAX tool's
    recipe: scalars, running variances and BatchNorm weights uniform in
    [0.5, 1.5), every other tensor normal with std 0.05."""
    from head_detector_tpu_torch.models import build_model
    from head_detector_tpu_torch.torch_mirror import sg_state_dict
    from head_detector_tpu_torch.weights import flax_from_state_dict

    tree = flax_from_state_dict(build_model(arch, deploy=False).state_dict())
    g = torch.Generator().manual_seed(seed)
    state = sg_state_dict(tree, arch)
    for key, t in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        if t.ndim == 0 or key.endswith("running_var") or (
                "bn" in key.rsplit(".", 2)[-2] and key.endswith("weight")):
            state[key] = torch.rand(t.shape, generator=g) + 0.5
        else:
            state[key] = torch.randn(t.shape, generator=g) * 0.05
    return state


def self_test(arch: str = "yolo_heads_n", size: int = 64, n_images: int = 2, seed: int = 0,
              device="cuda", work_dir: Optional[str] = None, print_fn=print) -> Dict[str, object]:
    """The ``--self-test`` chain (module docstring): both reports, passing
    when both pass."""
    from head_detector_tpu_torch.torch_mirror import export_torchscript
    from head_detector_tpu_torch.weights import load_variables

    with tempfile.TemporaryDirectory(prefix="hdt_parity_") as tmp:
        work = work_dir or tmp
        pth = os.path.join(work, f"{arch}_selftest.pth")
        trcd = os.path.join(work, f"{arch}_selftest.trcd")
        torch.save(random_sg_state(arch, seed), pth)
        export_torchscript(arch, load_variables(pth), trcd, image_size=(size, size),
                           device=device)
        print_fn(f"[parity] self-test artifacts: {pth}, {trcd}")
        reports = {"pth_against_trcd": verify(pth, arch, size, n_images, seed, reference=trcd,
                                              device=device, print_fn=print_fn),
                   "trcd": verify(trcd, arch, size, n_images, seed, device=device,
                                  print_fn=print_fn)}
    reports["pass"] = all(r["pass"] for r in reports.values())
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", nargs="?", help=".pth/.pt/.ckpt/.msgpack/.trcd checkpoint")
    ap.add_argument("--reference", default=None, help="the reference .trcd to hold it against")
    ap.add_argument("--arch", default="yolo_heads_l")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--n-images", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--self-test", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not args.ckpt and not args.self_test:
        ap.error("provide a checkpoint path or --self-test")
    if args.self_test:
        report = self_test(args.arch, args.size, args.n_images, args.seed, args.device)
    else:
        report = verify(args.ckpt, args.arch, args.size, args.n_images, args.seed,
                        args.reference, args.device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2, default=str)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
