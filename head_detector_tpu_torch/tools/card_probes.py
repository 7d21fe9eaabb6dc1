"""Probes of two faults of the port on the card: float32 gradients at a
pose stem, and training that is not deterministic.

``pose-stem``: the state of ``tools/grad_precision.py --steps 8 --lr 3e-4``
(MiT-B5 at 320 px), one float32 step (TF32 off) on the card with cuDNN's
default algorithm choice and again with ``cudnn.deterministic=True`` and
``benchmark=False``, each against the CPU's float32 and float64 (the
gradients over the model and the worst parameters).  Then every convolution
under ``heads.head1.pose_stem`` alone: its input and output gradient are
captured in the card's step, and its forward, input gradient and weight
gradient are computed on the card (both algorithm choices, with the
profiler's kernel names) and on the CPU in float32, each against float64 on
the CPU from the same tensors.  An algorithm that is the cause shows as one convolution whose
card error is far above the CPU's.

``determinism``: phase 7's training run of ``chip_smoke.py`` (yolo_heads_m
from the shipped checkpoint, rendered scenes, 640 px, batch 8, bfloat16)
uninterrupted for two epochs and as one epoch plus a resumed one, under
``torch.use_deterministic_algorithms(True, warn_only=True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``: the ops that have no deterministic
implementation (each warns once) and the parameters' distance between the
two runs, then the same two runs without it.

Usage::

    python -m head_detector_tpu_torch.tools.card_probes pose-stem \
        [--arch segformer --size 320 --steps 8] [--device cpu]
    python -m head_detector_tpu_torch.tools.card_probes determinism [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import warnings
from typing import Dict

import torch

from head_detector_tpu_torch.tools import grad_precision as gp

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKPOINT = os.path.join(REPO, "checkpoints", "flagship_ema.msgpack")
LR, MAX_STEPS = 3e-4, 100  # grad_precision's defaults: its reading's trained point
SCOPE = "heads.head1.pose_stem"


@contextlib.contextmanager
def cudnn_choice(deterministic: bool):
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-300))


def _conv_legs(module, x, g, device, dtype, names=None):
    """(output, input gradient, weight gradient) of ``module``'s convolution
    of ``x`` with output gradient ``g``, on ``device`` in ``dtype``; the
    card's kernel names go into ``names``."""
    from head_detector_tpu_torch.device import exact_float32

    x = x.to(device, dtype).requires_grad_(True)
    w = module.weight.detach().to(device, dtype).requires_grad_(True)
    b = None if module.bias is None else module.bias.detach().to(device, dtype)
    prof = None
    if names is not None:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    with exact_float32():
        y = module._conv_forward(x, w, b)
        gx, gw = torch.autograd.grad(y, (x, w), g.to(device, dtype))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if prof is not None:
        prof.__exit__(None, None, None)
        names.extend(sorted({e.key for e in prof.key_averages() if e.device_time_total > 0}))
    return y.detach(), gx, gw


def pose_stem(args) -> dict:
    from head_detector_tpu_torch.device import resolve_device
    from head_detector_tpu_torch.models.blocks import Conv2d

    dev = resolve_device(args.device)
    weights, images, targets, loss_cfg = gp.prepare(args.arch, args.size, args.steps, LR,
                                                    MAX_STEPS, dev)
    captured: Dict[str, list] = {}

    def hook(net):
        for name, module in net.named_modules():
            if isinstance(module, Conv2d) and name.startswith(SCOPE):
                captured[name] = [module]
                module.register_forward_hook(lambda m, i, o, n=name: _capture(n, i[0], o))

    def _capture(name, x, y):
        captured[name].append(x.detach().clone())
        y.register_hook(lambda g: captured[name].append(g.detach().clone()))

    grads, comps = {}, {}
    for side, where, dtype, deterministic in (
            ("card", dev, torch.float32, False), ("card_deterministic", dev, torch.float32, True),
            ("cpu", torch.device("cpu"), torch.float32, False),
            ("float64", torch.device("cpu"), torch.float64, False)):
        with cudnn_choice(deterministic):
            comps[side], grads[side] = gp.step_gradients(
                args.arch, weights, images, targets, loss_cfg, where, dtype,
                on_net=hook if side == "card" else None)
    out = {"model": gp.compare(grads, worst=4), "convs": {}}
    print(f"[card_probes] pose-stem: the model's gradients at the trained point: "
          f"{json.dumps(out['model'], default=str)}", flush=True)
    cpu = torch.device("cpu")
    for name, (module, x, g) in captured.items():
        ref = _conv_legs(module, x, g, cpu, torch.float64)
        row = {"shape": [list(x.shape), list(module.weight.shape)]}
        for side, where, deterministic in (("card", dev, False),
                                           ("card_deterministic", dev, True),
                                           ("cpu", cpu, False)):
            names = [] if where.type == "cuda" else None
            with cudnn_choice(deterministic):
                legs = _conv_legs(module, x, g, where, torch.float32, names)
            row[side] = {leg: _rel(a, r) for leg, a, r in zip(("y", "grad_x", "grad_w"),
                                                               legs, ref)}
            if names is not None:
                row[side]["kernels"] = names
        out["convs"][name] = row
        print(f"[card_probes] pose-stem: {name}: {json.dumps(row)}", flush=True)
    return out


def _phase7_argv(root: str, device: str, epochs: int, resume: bool, per_run: int) -> list:
    return ["--config-name", "yolo_heads_m", "--device", device, "dataset_params.render=true",
            f"pretrained_weights={CHECKPOINT}", "dataset_params.image_size=640",
            "dataset_params.batch_size=8", "dataset_params.train_length=64",
            "dataset_params.val_length=16", f"training_hyperparams.max_epochs={epochs}",
            f"training_hyperparams.epochs_per_run={per_run}",
            f"training_hyperparams.resume={'true' if resume else 'false'}",
            f"ckpt_root_dir={root}", "experiment_name=probe", "log_every=8"]


def _resume_distance(device: str) -> dict:
    from head_detector_tpu_torch.train.__main__ import build_trainer, state_digest

    states = {}
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        whole = build_trainer(_phase7_argv(a, device, 2, False, 2))
        whole.train()
        states["uninterrupted"] = whole
        build_trainer(_phase7_argv(b, device, 2, False, 1)).train()
        resumed = build_trainer(_phase7_argv(b, device, 2, True, 1))
        resumed.train()
        states["resumed"] = resumed
    p = {k: v.detach().float() for k, v in states["uninterrupted"].state.params().items()}
    q = {k: v.detach().float() for k, v in states["resumed"].state.params().items()}
    flat_p = torch.cat([p[k].reshape(-1).cpu() for k in sorted(p)])
    flat_q = torch.cat([q[k].reshape(-1).cpu() for k in sorted(p)])
    return {"step": [states["uninterrupted"].state.step, states["resumed"].state.step],
            "params_rel_l2": _rel(flat_q, flat_p),
            "tensors_equal": sum(bool(torch.equal(p[k], q[k])) for k in p),
            "tensors": len(p),
            "digests_equal": state_digest(states["uninterrupted"].state)
            == state_digest(states["resumed"].state)}


def determinism(args) -> dict:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with cudnn_choice(True):
                out["deterministic"] = _resume_distance(args.device)
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0] for w in caught
                  if "deterministic" in str(w.message)})
    out["deterministic"]["nondeterministic_ops"] = ops
    print(f"[card_probes] determinism: under use_deterministic_algorithms: "
          f"{json.dumps(out['deterministic'])}", flush=True)
    out["default"] = _resume_distance(args.device)
    print(f"[card_probes] determinism: default: {json.dumps(out['default'])}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=["pose-stem", "determinism"])
    ap.add_argument("--arch", default="segformer")
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return pose_stem(args) if args.probe == "pose-stem" else determinism(args)


if __name__ == "__main__":
    main()
