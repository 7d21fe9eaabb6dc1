"""Probes of faults of the port on the card: float32 gradients at a pose
stem, training that is not deterministic, the validated EMA model of a
campaign, the flagship's train step on the card against the CPU with every
module's error against float64, the loss alone against the loss in float64,
the model gradient at the shipped checkpoint against JAX's own float32 error
and BatchNorm's backward alone, and two campaigns' losses paired by step.

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
card error is far above the CPU's.  Last, the train-mode BatchNorms of
``heads.head1.flame_jaw_pred`` (:func:`jaw_tower`): each one's per-channel
batch variance of its input in a forward on the card, on the CPU and in
float64, the channel of least variance against the BatchNorm's ``eps``, and
each side's relative error there (a channel whose variance is near ``eps``
turns a 2e-7 input error into a large relative one).

``determinism``: phase 7's training run of ``chip_smoke.py`` (yolo_heads_m
from the shipped checkpoint, rendered scenes, 640 px, batch 8, bfloat16)
uninterrupted for two epochs and as one epoch plus a resumed one, under
``torch.use_deterministic_algorithms(True, warn_only=True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``: the ops that have no deterministic
implementation (each warns once) and the parameters' distance between the
two runs, then the same two runs without it (in the same process, so on
the cuBLAS handle the first runs made).

:func:`dp_resume` runs the caller's uninterrupted, cut and resumed runs of
the entry point (``chip_smoke.py`` phase 14 (c)'s: two gloo ranks sharing
the card, float32) under a set of deterministic switches (``SWITCHES``):
``cudnn`` is ``cudnn.deterministic=True`` with ``cudnn.benchmark=False``;
``algorithms`` is ``use_deterministic_algorithms(True, warn_only=True)``
with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the ranks' environment (and
only there).  It returns the digests, the parameters' distance, the ops
that warn and the convolution kernels of each run on each rank (the
profiler's names).

``validation``: one saved step of a campaign (``--ckpt-dir``, ``--step`` a
number, ``best``, ``worst`` or ``latest``) scored on the val split in four
variants in bfloat16 (the campaign's mixed precision), each by
``tools/diagnose_recall.py``'s threshold sweep (TP, FP and
FN, accuracy, the raw NME over true positives and the folded metrics): (i)
the EMA parameters with the live BatchNorm statistics, as ``Trainer.validate``
scores them; (ii) the live parameters with the live statistics; (iii) the
EMA parameters with statistics recalibrated on them (``calibrate_batch_stats``
on one batch of train images); (iv) (i) on the CPU, on the first
``--cpu-images`` val images, beside (i) on the card on the same images and
the largest score difference of one dense forward.  It also prints the
relative L2 between the EMA and the live parameters.  ``--export-ema
PATH.msgpack.gz`` writes (i)'s variables as a gzipped float16 msgpack (the
M model's ~67 MiB shrink to ~62 MiB) for the JAX package's validator
(``python tests/test_torch_validation.py --msgpack PATH``).

``flagship-steps``: the flagship configuration's train step (``flagship_r4``
on JAX's 5-epoch schedule: 512 px, batch 16, params wire, warmup 500,
``max_steps`` 3840, EMA 0.999) from one start on the card and on the CPU.
The start is ``init_model`` with a CPU generator at seed 0, moved to
each device; the batches are scenes of the port's renderer at
``--min-visibility 0.5`` through the flagship reader's augmentations, and
the sha256 of the collated arrays is printed (a run elsewhere on the same
arrays prints the same digest).  ``--bf16-steps`` bfloat16 steps and
``--f32-steps`` float32 steps run on the card, on the CPU, and on the card
from a start one float32 step away from the first (``card_ulp``: how far
rounding alone carries a run, the yardstick of a device difference); the
float32 steps also run on the CPU in float64.  Each step prints every loss
component of every run and the parameters' distance by group
(:func:`group_of`) between runs.  Then :func:`layer_gradients` for
``yolo_heads_m`` (at ``--size``) and SegFormer at 320 px, each at
``tools/grad_precision.py``'s state (8 bfloat16 steps, batch 2): the
relative error of the gradient at every module's output from the loss back
to the stems, card and CPU in float32 against float64, and the first module
where the card's error exceeds ``LAYER_RATIO`` times the CPU's, and the
same for every module's output in the forward.

``loss-precision``: the loss alone on one set of raw outputs, those of the
float64 network at ``tools/grad_precision.py``'s state of ``--arch`` at
``--size`` (:func:`loss_precision`): each term's gradient with respect to
the class logits, the box bins and each FLAME slot, in float32 on the card
and on the CPU and as the float64 runs compute it (a float32 FLAME model),
each against the loss in float64 (a float64 FLAME model and float64
targets); a side whose error is far above the CPU's against float64 is a
fault of the device's loss, and one that is above it only against the
float64 runs' loss is the yardstick's shared rounding.

``bn-precision``: the model gradient of one train-mode float32 step of
the shipped ``yolo_heads_m`` checkpoint (``BN_SIZE`` px, ``BN_BATCH``
scenes of the flagship renderer made on the CPU from ``BN_SEED`` and kept
in ``BN_BATCH_FILE``, ``tools/grad_precision.py``'s loss settings) against
the port's float64 on the CPU: the port's float32 on the CPU, on the card,
and on the card with cuDNN disabled, over the whole model and over the leaves whose exact
gradient is not 0 (:func:`exact_zero_leaves` lists the others, from the
module structure; their norm is reported apart).  Then the train-mode
BatchNorm that carries most of the card's error alone, on its input and
output gradient from the card's step: card with cuDNN and without, CPU,
each against float64, with the profiler's kernel names.  It exits 1 when
the card's error on the non-zero leaves is over ``BN_RATIO`` times JAX's
own float32 error at the same state (``JAX_F32_ERROR``, measured on the
CPU by ``tests/test_torch_bn_precision.py``).

``losses``: the step logs of two campaigns (``[epoch E step S] loss=...
cls=... iou=... pose=... verts=...`` lines, a file or every ``*.log`` of a
directory), paired by step: both trainers log one step's components every
``log_every`` steps at the same step numbers, from the same set in the same
loader order, so a pair is one batch seen by both.  For each epoch and
component (``rot+dfl`` is ``loss`` less the four logged terms): the pairs,
the mean of (second - first), its standard error, and the correlation of
the two series after a quadratic trend in the step is taken out of each.
Runs on the CPU, with no card.

Usage::

    python -m head_detector_tpu_torch.tools.card_probes losses \
        --reference campaigns/flagship_r4/campaign_r5.log \
        --port campaigns/flagship_torch_r3_5ep
    python -m head_detector_tpu_torch.tools.card_probes flagship-steps \
        [--bf16-steps 50 --f32-steps 8 --size 512] [--out steps.jsonl] [--device cpu]
        # ~45 min on the card's machine at the defaults, most of it the CPU's
        # float32 and float64 steps at 512 px, batch 16
    python -m head_detector_tpu_torch.tools.card_probes layers \
        [--arch segformer --size 320] [--device cpu]
    python -m head_detector_tpu_torch.tools.card_probes loss-precision \
        [--arch segformer --size 320] [--device cpu]
    python -m head_detector_tpu_torch.tools.card_probes bn-precision [--device cpu]
    python -m head_detector_tpu_torch.tools.card_probes pose-stem \
        [--arch segformer --size 320 --steps 8] [--device cpu]
    python -m head_detector_tpu_torch.tools.card_probes determinism [--device cpu]
    python -m head_detector_tpu_torch.tools.card_probes validation \
        --ckpt-dir runs/campaign/flagship_r4 --data-dir runs/synth512 \
        [--step worst] [--arch yolo_heads_m --image-size 512] [--cpu-images 64] \
        [--export-ema runs/ema.msgpack.gz] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import tempfile
import warnings
from typing import Dict

import torch

from head_detector_tpu_torch.tools import grad_precision as gp

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKPOINT = os.path.join(REPO, "checkpoints", "flagship_ema.msgpack")
LR, MAX_STEPS = 3e-4, 100  # grad_precision's defaults: its reading's trained point
SCOPE = "heads.head1.pose_stem"
JAW = "heads.head1.flame_jaw_pred"
# validation: the flagship configuration's val batch, GT boxes, compute dtype
# (mixed precision) and protocol threshold, and diagnose_recall's sweep
VAL_BATCH, MAX_BOXES, VAL_DTYPE, PROTOCOL = 16, 4, torch.bfloat16, 0.5
THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7)


@contextlib.contextmanager
def cudnn_enabled(enabled: bool):
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


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


def _record_variances(store: dict):
    """``on_net`` hook: each BatchNorm under :data:`JAW` records, in train
    mode, the per-channel batch variance of its input (biased, computed in
    float64 from the side's own activations) and its ``eps``."""
    from head_detector_tpu_torch.models.blocks import BatchNorm2d

    def record(name, module, x):
        var = x.detach().double().var(dim=(0, 2, 3), unbiased=False).cpu()
        store[name] = (var, module.eps)

    def hook(net):
        for name, module in net.named_modules():
            if isinstance(module, BatchNorm2d) and name.startswith(JAW):
                module.register_forward_hook(lambda m, i, o, n=name: record(n, m, i[0]))
    return hook


def jaw_tower(arch: str, weights, images, targets, loss_cfg, device) -> dict:
    """The train-mode batch variances of the jaw tower's BatchNorms in one
    forward of the loss on ``device`` (float32), on the CPU (float32) and on
    the CPU in float64: for each BatchNorm, the float64 run's channel of
    least variance, that variance over ``eps``, and each float32 side's
    relative error of the variance there and over all channels."""
    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.models import build_model
    from head_detector_tpu_torch.train.loss import Targets
    from head_detector_tpu_torch.train.trainer import images_to_device, make_loss_fn

    stats: Dict[str, dict] = {}
    for side, where, dtype in (("card", device, torch.float32),
                               ("cpu", torch.device("cpu"), torch.float32),
                               ("float64", torch.device("cpu"), torch.float64)):
        net = build_model(arch, deploy=False).to(where)
        net.load_state_dict(weights, strict=True)
        net.to(dtype)
        net.dtype = dtype
        stats[side] = {}
        _record_variances(stats[side])(net)
        with torch.no_grad(), exact_float32():
            make_loss_fn(net, FlameModel.from_assets(device=where), loss_cfg)(
                images_to_device(images, where).to(dtype), Targets(*targets).to(where))
    out = {}
    for name, (var, eps) in stats["float64"].items():
        c = int(torch.argmin(var))
        row = {"channel": c, "min_var": float(var[c]), "eps": eps,
               "min_var_over_eps": float(var[c]) / eps}
        for side in ("card", "cpu"):
            got = stats[side][name][0]
            row[side] = {"min_var": float(got[c]),
                         "rel_err_at_min": float(abs(got[c] - var[c]) / var[c]),
                         "rel_l2": _rel(got, var)}
        out[name] = row
    return out


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
        print(f"[card_probes] pose-stem: {name}: {json.dumps(row, default=float)}", flush=True)
    out["jaw_tower"] = jaw_tower(args.arch, weights, images, targets, loss_cfg, dev)
    for name, row in out["jaw_tower"].items():
        print(f"[card_probes] pose-stem: jaw tower {name}: {json.dumps(row, default=float)}",
              flush=True)
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


# dp_resume's settings: which deterministic switches each turns on
SWITCHES = {"none": (), "cudnn": ("cudnn",), "algorithms": ("algorithms",),
            "all": ("cudnn", "algorithms")}


@contextlib.contextmanager
def environ(name: str, value):
    """``os.environ[name]`` set to ``value`` (removed for None) inside the
    block, restored after it."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def _dp_rank(rank, world, device, group, runs: dict, switches: tuple) -> dict:
    """One rank of :func:`dp_resume`: the caller's runs in turn, each
    profiled on the card, under ``switches``."""
    from head_detector_tpu_torch.train.__main__ import _train_rank

    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if "algorithms" in switches:
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with cudnn_choice(True) if "cudnn" in switches else contextlib.nullcontext():
                for label, argv in runs.items():
                    prof = None
                    if device.type == "cuda":
                        from torch.profiler import ProfilerActivity, profile

                        prof = profile(activities=[ProfilerActivity.CUDA])
                        prof.__enter__()
                    summary = _train_rank(rank, world, device, group,
                                          [(argv, {"return_state": True})], {})[0]
                    kernels = []
                    if prof is not None:
                        prof.__exit__(None, None, None)
                        kernels = sorted({e.key for e in prof.key_averages()
                                          if e.device_time_total > 0
                                          and any(w in e.key.lower()
                                                  for w in ("conv", "xmma", "cudnn"))})
                    out[label] = {"digest": summary["digest"], "step": summary["step"],
                                  "params": summary["state"]["params"], "kernels": kernels}
        finally:
            torch.use_deterministic_algorithms(False)
    out["warned"] = sorted({str(w.message).split("\n")[0] for w in caught
                            if "deterministic" in str(w.message)})
    return out


def dp_resume(device: str, runs: dict, switches: str = "all") -> dict:
    """``runs`` (``{"uninterrupted": argv, "cut": argv, "resumed": argv}``
    of the entry point) under two gloo ranks on ``device`` with the
    switches ``SWITCHES[switches]`` (module docstring): the resumed run
    against the uninterrupted one on rank 0, the ranks' replicas, and the
    convolution kernels that differ between the runs and between the ranks."""
    from head_detector_tpu_torch import distributed

    on = SWITCHES[switches]
    cublas = ":4096:8" if "algorithms" in on else None
    with environ("CUBLAS_WORKSPACE_CONFIG", cublas):  # the ranks inherit it, this process not
        ranks = distributed.spawn(_dp_rank, 2, [device, device], "gloo", args=(runs, on),
                                  timeout_s=300.0)
    whole, resumed = ranks[0]["uninterrupted"], ranks[0]["resumed"]
    flat = lambda d: torch.cat([d[k].reshape(-1).double() for k in sorted(d)])  # noqa: E731
    kernels = {r: {label: set(ranks[r][label]["kernels"]) for label in runs} for r in (0, 1)}
    return {
        "switches": switches, "steps": [whole["step"], resumed["step"]],
        "digests_equal": whole["digest"] == resumed["digest"],
        "params_rel_l2": _rel(flat(resumed["params"]), flat(whole["params"])),
        "replicas_equal": all(ranks[0][k]["digest"] == ranks[1][k]["digest"] for k in runs),
        "warned": sorted(set(ranks[0]["warned"]) | set(ranks[1]["warned"])),
        "kernels_only_uninterrupted": sorted(kernels[0]["uninterrupted"]
                                             - kernels[0]["cut"] - kernels[0]["resumed"]),
        "kernels_only_cut_or_resumed": sorted((kernels[0]["cut"] | kernels[0]["resumed"])
                                              - kernels[0]["uninterrupted"]),
        "kernels_rank0_not_rank1": sorted(set().union(*kernels[0].values())
                                          - set().union(*kernels[1].values())),
        "kernels_rank1_not_rank0": sorted(set().union(*kernels[1].values())
                                          - set().union(*kernels[0].values())),
    }


def determinism(args) -> dict:
    out = {}
    with environ("CUBLAS_WORKSPACE_CONFIG", ":4096:8"), \
            warnings.catch_warnings(record=True) as caught:
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


def pick_step(mgr, which: str) -> int:
    """``which``: a step number, or ``best`` / ``worst`` (by the manager's
    metric over the saved steps) / ``latest``."""
    if which == "latest":
        return mgr.latest_step()
    if which in ("best", "worst"):
        ranked = mgr.best_steps(len(mgr.all_steps()))
        if not ranked:
            raise FileNotFoundError(f"no scored step in {mgr.ckpt_dir}")
        return ranked[0] if which == "best" else ranked[-1]
    return int(which)


def relative_distance(ema: Dict[str, torch.Tensor], live: Dict[str, torch.Tensor]) -> float:
    """Relative L2 of the EMA from the live parameters over the model."""
    names = sorted(live)
    return _rel(torch.cat([ema[n].detach().reshape(-1).cpu().double() for n in names]),
                torch.cat([live[n].detach().reshape(-1).cpu().double() for n in names]))


def validation(args) -> dict:
    """Variants (i)-(iv) of one campaign step (module docstring)."""
    import gzip

    import numpy as np

    from head_detector_tpu_torch.assets_io import get_indices
    from head_detector_tpu_torch.device import resolve_device
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.models import build_model, calibrate_batch_stats
    from head_detector_tpu_torch.tools import diagnose_recall as dr
    from head_detector_tpu_torch.tools.eval_checkpoint import cast_float32_leaves
    from head_detector_tpu_torch.train.checkpoint import CheckpointManager
    from head_detector_tpu_torch.train.dataset import DAD3DHeadsDataset
    from head_detector_tpu_torch.train.runner import _Prefetcher
    from head_detector_tpu_torch.train.trainer import images_to_device
    from head_detector_tpu_torch.train.transforms import default_val_transforms
    from head_detector_tpu_torch.weights import flax_from_state_dict, serialize_variables

    dev = resolve_device(args.device)
    cpu = torch.device("cpu")
    mgr = CheckpointManager(args.ckpt_dir)
    step = pick_step(mgr, args.step)
    recorded = next((r for r in reversed(mgr.metrics_history()) if r.get("step") == step), {})
    state = mgr.restore(step)
    stats = state["batch_stats"]
    variants = {"ema": {**state["ema_params"], **stats}, "live": {**state["params"], **stats}}
    val = DAD3DHeadsDataset(args.data_dir, splits=["val"],
                            transforms=default_val_transforms(args.image_size))
    head_idx = np.asarray(get_indices()["head"], np.int64)
    flames = {"card": FlameModel.from_assets(device=dev)}
    models = {"card": build_model(args.arch, dtype=VAL_DTYPE, deploy=False).to(dev)}

    def score(tree, where, dataset):
        records = dr.collect_predictions(flax_from_state_dict(tree), models[where],
                                         flames[where], dataset, min(VAL_BATCH, len(dataset)),
                                         MAX_BOXES, head_idx)
        rows = dr.sweep(records, THRESHOLDS)
        return {"images": len(records), "sweep": rows,
                "protocol": next(r for r in rows if r["threshold"] == PROTOCOL)}

    out = {"step": step, "recorded": recorded,
           "ema_to_live": relative_distance(state["ema_params"], state["params"])}
    print(f"[card_probes] validation: step {step} ({args.ckpt_dir}), recorded "
          f"{json.dumps(recorded, default=float)}, EMA to live (relative L2) "
          f"{out['ema_to_live']}", flush=True)
    out["i_ema_live_stats"] = score(variants["ema"], "card", val)
    out["ii_live_live_stats"] = score(variants["live"], "card", val)

    train = DAD3DHeadsDataset(args.data_dir, splits=["train"],
                              transforms=default_val_transforms(args.image_size))
    images, _ = next(iter(_Prefetcher(train, args.calib_images, MAX_BOXES, num_workers=4,
                                      seed=0)))
    net = models["card"]
    net.load_state_dict(variants["ema"], strict=True)
    with torch.no_grad():
        calibrate_batch_stats(net, images_to_device(images, dev).to(VAL_DTYPE))
    recalibrated = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    out["iii_ema_recalibrated"] = score(recalibrated, "card", val)
    out["iii_ema_recalibrated"]["calib_images"] = args.calib_images

    subset = [val[i] for i in range(min(args.cpu_images, len(val)))]
    flames["cpu"] = FlameModel.from_assets(device=cpu)
    models["cpu"] = build_model(args.arch, dtype=VAL_DTYPE, deploy=False)
    out["iv_cpu"] = score(variants["ema"], "cpu", subset)
    out["iv_cpu"]["card_same_images"] = score(variants["ema"], "card", subset)["protocol"]
    batch, _ = next(iter(_Prefetcher(subset, min(VAL_BATCH, len(subset)), MAX_BOXES,
                                     num_workers=2, seed=0)))
    scores = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        m = models[where]
        m.load_state_dict(variants["ema"], strict=True)
        m.eval()
        with torch.no_grad():
            scores[where] = m(images_to_device(batch, d).to(VAL_DTYPE))[0].scores.float().cpu()
    out["iv_cpu"]["max_score_gap"] = float((scores["card"] - scores["cpu"]).abs().max())
    for key in ("i_ema_live_stats", "ii_live_live_stats", "iii_ema_recalibrated", "iv_cpu"):
        row = {k: v for k, v in out[key].items() if k != "sweep"}
        print(f"[card_probes] validation: {key}: {json.dumps(row, default=float)}", flush=True)
    if args.export_ema:
        tree = cast_float32_leaves(flax_from_state_dict(variants["ema"]), np.float16)
        with gzip.open(args.export_ema, "wb", compresslevel=9) as f:
            f.write(serialize_variables(tree))
        with open(args.export_ema + ".json", "w") as f:
            json.dump({"arch": args.arch, "image_size": args.image_size, "which": "ema",
                       "step": step, "dtype": "f16", "recorded": recorded}, f)
        print(f"[card_probes] validation: wrote {args.export_ema} "
              f"({os.path.getsize(args.export_ema) / 2**20:.1f} MiB)", flush=True)
    return out


FLAGSHIP, FLAGSHIP_OVERRIDES = "flagship_r4", ["training_hyperparams.max_epochs=5"]
FLAGSHIP_SET, FLAGSHIP_BATCH, FLAGSHIP_MIN_VISIBILITY = 12288, 16, 0.5  # r4's set
FLAGSHIP_SEED = 0  # flagship-steps: the start's init and the scenes
LAYER_RATIO = 3.0  # layer_gradients: the card's error over the CPU's that marks a module
LAYER_FLOOR = 1e-6  # ... where the card's error is above this
HEAD_PARTS = {"cls": ("cls_conv", "cls_pred"), "box": ("bbox_stem", "reg_conv", "reg_pred")}


def group_of(name: str) -> str:
    """The group of a parameter of the training layout: ``backbone``,
    ``neck``, or ``headN.cls`` (``cls_conv``, ``cls_pred``), ``headN.box``
    (``bbox_stem``, ``reg_conv``, ``reg_pred``), ``headN.flame`` (the pose
    stem and the FLAME towers); a running statistic is ``running_mean`` or
    ``running_var``."""
    parts = name.split(".")
    if parts[-1] in ("running_mean", "running_var"):
        return parts[-1]
    if parts[0] != "heads":
        return parts[0]
    for group, scopes in HEAD_PARTS.items():
        if parts[2] in scopes:
            return f"{parts[1]}.{group}"
    return f"{parts[1]}.flame"


def grouped_rel(got: dict, want: dict) -> Dict[str, float]:
    """Relative L2 of ``got`` from ``want`` (name -> float64 array) in each
    :func:`group_of` group, and over the parameters (``model``)."""
    import numpy as np

    sq: Dict[str, list] = {}
    for name, w in want.items():
        g = group_of(name)
        d, n = float(np.sum((got[name] - w) ** 2)), float(np.sum(w ** 2))
        for key in (g,) if g.startswith("running") else (g, "model"):
            acc = sq.setdefault(key, [0.0, 0.0])
            acc[0] += d
            acc[1] += n
    return {k: float(np.sqrt(d / max(n, 1e-300))) for k, (d, n) in sq.items()}


def flagship_configs():
    """(``TrainConfig``, ``LossConfig``) of ``FLAGSHIP`` with
    ``FLAGSHIP_OVERRIDES``, ``max_steps`` as the runner sets it for r4's
    set (768 steps an epoch)."""
    from head_detector_tpu_torch.config import CONFIG_DIR, load_config, run_config_from_dict
    from head_detector_tpu_torch.train.runner import epoch_schedule

    cfg = run_config_from_dict(load_config(os.path.join(CONFIG_DIR, f"{FLAGSHIP}.yaml"),
                                           FLAGSHIP_OVERRIDES))
    return epoch_schedule(cfg, FLAGSHIP_SET)[1], cfg.loss


class StepRun:
    """One training run of the training layout on ``device`` with the
    network in ``dtype`` (float64: parameters too) from ``state_dict``."""

    def __init__(self, arch, state_dict, train_cfg, loss_cfg, device, dtype):
        from head_detector_tpu_torch.flame import FlameModel
        from head_detector_tpu_torch.models import build_model
        from head_detector_tpu_torch.train import trainer as tt

        net = build_model(arch, dtype=dtype, deploy=False)
        net.load_state_dict(state_dict, strict=True)
        if dtype == torch.float64:
            net = net.double()
        self.net = net.to(device)
        self.dtype = dtype
        self.state = tt.TrainState(self.net, train_cfg)
        self.fn = tt.make_train_step(self.net, FlameModel.from_assets(device=device), loss_cfg,
                                     train_cfg)

    def step(self, images, targets) -> dict:
        import numpy as np

        lr = self.state.schedule(self.state.step)
        x = images.astype(np.float64) / 255.0 if self.dtype == torch.float64 else images
        _, comps = self.fn(self.state, x, targets)
        return {"lr": lr, **{k: float(v) for k, v in comps.items()}}

    def snapshot(self) -> dict:
        """Parameters and running statistics as float64 numpy copies."""
        import numpy as np

        named = {**dict(self.net.named_parameters()),
                 **{n: b for n, b in self.net.named_buffers() if "running" in n}}
        return {n: np.array(t.detach().to("cpu", torch.float64).numpy()) for n, t in named.items()}


def one_ulp_away(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every floating parameter (not the running
    statistics) moved one float32 step away from zero."""
    out = {}
    for k, v in state_dict.items():
        if v.is_floating_point() and "running" not in k:
            v = torch.nextafter(v, torch.where(v >= 0, torch.full_like(v, float("inf")),
                                               torch.full_like(v, float("-inf"))))
        out[k] = v
    return out


def flagship_batches(root: str, size: int, steps: int, seed: int, device,
                     batch: int = FLAGSHIP_BATCH) -> list:
    """``steps`` collated params-wire batches of ``batch`` scenes, rendered
    by the port on ``device`` into ``root`` at the flagship set's least
    visibility and read through the flagship reader's augmentations at
    epoch 0."""
    from head_detector_tpu_torch.tools.render_synthetic_dataset import render_split
    from head_detector_tpu_torch.train.param_wire import (
        ConformalAugs,
        RenderedHeadsDataset,
        collate_param_samples,
    )
    from head_detector_tpu_torch.train.transforms import PhotometricAugs

    render_split(root, "train", batch * steps, size, seed=seed,
                 min_visibility=FLAGSHIP_MIN_VISIBILITY, device=device, log_every=0)
    ds = RenderedHeadsDataset(root, splits=["train"], augs=ConformalAugs(size),
                              photometric=PhotometricAugs(), keyed_draws=True)
    ds.set_epoch(0)
    return [collate_param_samples([ds[batch * i + j] for j in range(batch)], MAX_BOXES)
            for i in range(steps)]


def batches_digest(batches) -> str:
    import hashlib

    h = hashlib.sha256()
    for images, targets in batches:
        for a in (images, *targets):
            h.update(a.tobytes())
    return h.hexdigest()


def step_runs(device, arch: str, size: int, bf16_steps: int, f32_steps: int,
              out=None) -> dict:
    """The card against the CPU on the flagship's steps (module docstring):
    ``{"sha256": ..., "bfloat16": [row a step], "float32": [...]}``, each row
    the step's components by run and the groups' distances between runs;
    ``out``: a file that takes one JSON line a row."""
    from head_detector_tpu_torch.models import build_model, init_model

    cpu = torch.device("cpu")
    train_cfg, loss_cfg = flagship_configs()
    start = {k: v.clone() for k, v in init_model(
        build_model(arch, deploy=False), torch.Generator().manual_seed(FLAGSHIP_SEED),
        (size, size)).state_dict().items()}
    k_total = max(bf16_steps, f32_steps)
    with tempfile.TemporaryDirectory() as root:
        batches = flagship_batches(root, size, k_total, FLAGSHIP_SEED, device)
    result = {"sha256": batches_digest(batches)}
    print(f"[card_probes] flagship-steps: {arch} at {size} px, batch {FLAGSHIP_BATCH}, "
          f"{k_total} batches, sha256 {result['sha256']}", flush=True)
    for label, dtype, k in (("bfloat16", torch.bfloat16, bf16_steps),
                            ("float32", torch.float32, f32_steps)):
        runs = {"card": StepRun(arch, start, train_cfg, loss_cfg, device, dtype),
                "cpu": StepRun(arch, start, train_cfg, loss_cfg, cpu, dtype),
                "card_ulp": StepRun(arch, one_ulp_away(start), train_cfg, loss_cfg, device,
                                    dtype)}
        pairs = [("card", "cpu"), ("card", "card_ulp")]
        if dtype == torch.float32:
            runs["cpu64"] = StepRun(arch, start, train_cfg, loss_cfg, cpu, torch.float64)
            pairs += [("card", "cpu64"), ("cpu", "cpu64")]
        result[label] = []
        for i, (images, targets) in enumerate(batches[:k], start=1):
            comps, snaps = {}, {}
            for side, run in runs.items():
                comps[side] = run.step(images, targets)
                snaps[side] = run.snapshot()
            row = {"dtype": label, "step": i, "components": comps,
                   "groups": {f"{a}_vs_{b}": grouped_rel(snaps[a], snaps[b]) for a, b in pairs}}
            result[label].append(row)
            if out is not None:
                out.write(json.dumps(row) + "\n")
                out.flush()
            print(f"[card_probes] flagship-steps: {label} step {i}: " + "; ".join(
                f"{side} " + " ".join(f"{c} {v:.6f}" for c, v in cmp.items()
                                      if c.startswith("loss"))
                for side, cmp in comps.items()), flush=True)
            print(f"[card_probes] flagship-steps: {label} step {i} groups: " + "; ".join(
                f"{pair} " + " ".join(f"{g} {d:.2e}" for g, d in sorted(dist.items()))
                for pair, dist in row["groups"].items()), flush=True)
        del runs
    return result


def flagship_steps(args) -> dict:
    from head_detector_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    sink = open(args.out, "w") if args.out else None
    try:
        result = step_runs(dev, args.arch, args.size, args.bf16_steps, args.f32_steps, sink)
    finally:
        if sink:
            sink.close()
    result["layers"] = {arch: layers(arch, size, dev)
                        for arch, size in ((args.arch, args.size), ("segformer", 320))}
    return result


def layers(arch: str, size: int, device) -> dict:
    """:func:`layer_gradients` at ``tools/grad_precision.py``'s state of
    ``arch`` at ``size`` (8 bfloat16 steps at ``LR``, batch 2)."""
    w, images, targets, loss_cfg = gp.prepare(arch, size, 8, LR, MAX_STEPS, device)
    return layer_gradients(arch, w, images, targets, loss_cfg, device)


LOSS_TERMS = ("loss_cls", "loss_iou", "loss_dfl", "loss_pose_reg", "loss_3d_vertices",
              "loss_3d_rotation", "loss")
# loss-precision's sides: (device, whose raw outputs, their dtype, the FLAME
# model's and the targets' dtype).  The loss alone on the float64 network's
# outputs: "float64" (the yardstick), "float64_run" (the loss of the float64
# runs of step_gradients and StepRun: a float32 FLAME model), "cpu" and
# "card" (float32); the float32 network's outputs on each device under the
# loss in float64 ("*_forward"), and under its own float32 loss ("*_step",
# the loss of that device's float32 step)
LOSS_SIDES = {"float64": ("cpu", "float64", torch.float64, torch.float64),
              "float64_run": ("cpu", "float64", torch.float64, torch.float32),
              "cpu": ("cpu", "float64", torch.float32, torch.float32),
              "card": (None, "float64", torch.float32, torch.float32),
              "cpu_forward": ("cpu", "cpu", torch.float64, torch.float64),
              "card_forward": ("cpu", "card", torch.float64, torch.float64),
              "cpu_step": ("cpu", "cpu", torch.float32, torch.float32),
              "card_step": (None, "card", torch.float32, torch.float32)}


def _raw_parts(grads) -> dict:
    """The gradients with respect to (class logits, box distributions,
    FLAME vectors) -> float64 CPU tensors by part: ``cls``, ``box`` and each
    FLAME slot in the wire's order (``FlameParams.from_3dmm``)."""
    from head_detector_tpu_torch.head_info import FLAME_CONSTS

    g_cls, g_box, g_flame = (torch.zeros((), dtype=torch.float64) if g is None
                             else g.detach().cpu().double() for g in grads)
    out, i = {"cls": g_cls, "box": g_box}, 0
    for name in ("shape", "expression", "jaw", "rotation", "eyeballs", "neck", "translation",
                 "scale"):
        if FLAME_CONSTS[name]:
            out[name] = g_flame[..., i:i + FLAME_CONSTS[name]] if g_flame.dim() else g_flame
        i += FLAME_CONSTS[name]
    return out


def loss_precision(arch: str, weights, images, targets, loss_cfg, device) -> dict:
    """The loss alone on the raw outputs of ``arch`` at ``weights`` (train
    mode, one batch), on the sides of ``LOSS_SIDES``: each loss term's
    gradient with respect to the raw outputs, by part (:func:`_raw_parts`),
    against the float64 loss's on the float64 network's outputs (a float64
    FLAME model and float64 targets: the yardstick); the float32 loss alone
    on the card and the CPU also against the float64 runs' loss.  The
    float32 network's outputs on each device against the float64 network's,
    by part; each side's assignment against float64's, and the gradients
    again with float64's assignment fed to every side.  Last, the network's
    parameter gradients against the float64 network's from the float64
    loss's gradient at its outputs, over the model and by group
    (:func:`group_of`): the float32 network on the card and the CPU fed that
    same gradient at its outputs (``shared``: the network's backward alone),
    and fed its own float32 loss's (``step``: the whole float32 step)."""
    import numpy as np

    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.models import build_model
    from head_detector_tpu_torch.train.loss import Targets, yolo_heads_loss
    from head_detector_tpu_torch.train.trainer import images_to_device

    cpu = torch.device("cpu")
    raws = {}
    for src, where, dtype in (("float64", cpu, torch.float64), ("cpu", cpu, torch.float32),
                              ("card", device, torch.float32)):
        net = build_model(arch, deploy=False).to(where)
        net.load_state_dict(weights, strict=True)
        net.to(dtype)
        net.dtype = dtype
        net.train()
        with exact_float32(), torch.no_grad():
            raws[src] = net(images_to_device(images, where).to(dtype))[1]
    fields = ("cls_score_list", "reg_distri_list", "flame_params")
    upstream = {}  # side -> the total loss's gradient at the raw outputs

    def side_grads(side, inject=None):
        where, src, raw_dtype, dtype = LOSS_SIDES[side]
        where = torch.device(where) if where else device
        leaves = [getattr(raws[src], k).detach().to(where, raw_dtype).requires_grad_(True)
                  for k in fields]
        raw = raws[src]._replace(**dict(zip(fields, leaves)),
                                 **{k: getattr(raws[src], k).to(where, raw_dtype)
                                    for k in ("anchors", "anchor_points", "stride_tensor")})
        tgt = Targets(*(torch.as_tensor(np.asarray(t)).to(where, dtype) for t in targets))
        record = []
        with exact_float32(), assignments(record, inject):
            _, comps = yolo_heads_loss(FlameModel.from_assets(device=where, dtype=dtype), raw,
                                       tgt, loss_cfg)
            full = {term: torch.autograd.grad(comps[term], leaves, retain_graph=True,
                                              allow_unused=True) for term in LOSS_TERMS}
        upstream[side] = [g.detach().to(cpu, torch.float64) for g in full["loss"]]
        return ({k: float(v.detach()) for k, v in comps.items()},
                {term: _raw_parts(g) for term, g in full.items()}, record[0])

    def rel(got, want):
        return {term: {part: gp._rel(got[term][part], w) for part, w in parts.items()}
                for term, parts in want.items()}

    comps, grads, assigned = {}, {}, {}
    for side in LOSS_SIDES:
        comps[side], grads[side], assigned[side] = side_grads(side)
    own = {side: upstream[side] for side in ("float64", "cpu_step", "card_step")}
    others = [side for side in LOSS_SIDES if side != "float64"]
    shared = {side: side_grads(side, assigned["float64"])[1] for side in others}
    shared["float64"] = grads["float64"]
    parts64 = _raw_parts([getattr(raws["float64"], k) for k in fields])
    out = {"components": comps,
           "outputs": {src: {part: gp._rel(got, parts64[part]) for part, got in _raw_parts(
               [getattr(raws[src], k) for k in fields]).items()} for src in ("cpu", "card")},
           "assignment": {side: _assignment_gap(assigned[side], assigned["float64"])
                          for side in others},
           "norm": {term: {part: float(torch.linalg.norm(g)) for part, g in parts.items()}
                    for term, parts in grads["float64"].items()},
           "against_float64": {side: rel(grads[side], grads["float64"]) for side in others},
           "against_float64_run": {side: rel(grads[side], grads["float64_run"])
                                   for side in ("card", "cpu")},
           "with_float64_assignment": {side: rel(shared[side], shared["float64"])
                                       for side in others}}
    # the network's backward: the float32 network on each device from the
    # float64 loss's gradient at the float64 outputs ("*_shared"), and from
    # its own float32 loss's at its own outputs ("*_step": the whole step)
    model = {}
    for side, where, dtype, g in (
            ("float64", cpu, torch.float64, own["float64"]),
            ("cpu_shared", cpu, torch.float32, own["float64"]),
            ("card_shared", device, torch.float32, own["float64"]),
            ("cpu_step", cpu, torch.float32, own["cpu_step"]),
            ("card_step", device, torch.float32, own["card_step"])):
        net = build_model(arch, deploy=False).to(where)
        net.load_state_dict(weights, strict=True)
        net.to(dtype)
        net.dtype = dtype
        net.train()
        with exact_float32():
            raw = net(images_to_device(images, where).to(dtype))[1]
            torch.autograd.backward([getattr(raw, k) for k in fields],
                                    [t.to(where, dtype) for t in g])
        model[side] = {n: p.grad.detach().cpu().double() for n, p in net.named_parameters()}
    out["network"] = {
        key: {"compare": gp.compare({k: model[k] for k in (f"card_{key}", f"cpu_{key}",
                                                            "float64")}, worst=4),
              "groups": {dev_: grouped_rel({n: g.numpy() for n, g in model[f"{dev_}_{key}"].items()},
                                           {n: g.numpy() for n, g in model["float64"].items()})
                         for dev_ in ("card", "cpu")}}
        for key in ("shared", "step")}
    print(f"[card_probes] loss-precision: {arch}: components "
          f"{json.dumps(comps)}; assignments against float64's "
          f"{json.dumps(out['assignment'])}", flush=True)
    print(f"[card_probes] loss-precision: {arch}: the float32 network's outputs against "
          f"float64's {json.dumps(out['outputs'])}", flush=True)
    for key in ("against_float64", "against_float64_run", "with_float64_assignment"):
        for term in LOSS_TERMS:
            print(f"[card_probes] loss-precision: {arch}: {key}: {term}: " + "; ".join(
                f"{part} " + " ".join(f"{side} {out[key][side][term][part]:.3e}"
                                      for side in out[key])
                for part in out["norm"][term]), flush=True)
    for key, row in out["network"].items():
        print(f"[card_probes] loss-precision: {arch}: the network's gradients ({key}) "
              f"{json.dumps(row['compare'], default=str)}; by group "
              f"{json.dumps(row['groups'])}", flush=True)
    return out


def loss_precision_at(arch: str, size: int, device) -> dict:
    """:func:`loss_precision` at ``tools/grad_precision.py``'s state of
    ``arch`` at ``size`` (8 bfloat16 steps at ``LR``, batch 2)."""
    w, images, targets, loss_cfg = gp.prepare(arch, size, 8, LR, MAX_STEPS, device)
    return loss_precision(arch, w, images, targets, loss_cfg, device)


def _capture_outputs(store: dict):
    """``on_net`` hook: every leaf module's output and output gradient, as
    float64 CPU copies under ``name#call``, in the order the forward and the
    backward reach them (``store["forward"]``, ``store["backward"]``)."""
    store.update(forward={}, backward={})

    def hook(net):
        calls: Dict[str, int] = {}

        def record(name, y):
            if not (torch.is_tensor(y) and y.is_floating_point()):
                return
            key = f"{name}#{calls.get(name, 0)}"
            calls[name] = calls.get(name, 0) + 1
            store["forward"][key] = y.detach().to("cpu", torch.float64)
            if y.requires_grad:
                y.register_hook(lambda g: store["backward"].__setitem__(
                    key, g.detach().to("cpu", torch.float64)))

        for name, module in net.named_modules():
            if name and not any(True for _ in module.children()):
                module.register_forward_hook(lambda m, i, o, n=name: record(n, o))
    return hook


def _errors(stores: Dict[str, dict], leg: str) -> list:
    """Per module of ``leg`` (in the order float64 reached them): the card's
    and the CPU's relative error against float64, and their ratio."""
    rows = []
    for key, want in stores["float64"][leg].items():
        if key in stores["card"][leg] and key in stores["cpu"][leg]:
            card, cpu = _rel(stores["card"][leg][key], want), _rel(stores["cpu"][leg][key], want)
            rows.append({"module": key, "card": card, "cpu": cpu,
                         "ratio": card / max(cpu, 1e-300)})
    return rows


@contextlib.contextmanager
def assignments(record: list, inject=None):
    """Inside the block the loss's ``task_aligned_assigner`` appends each
    result to ``record`` (on the CPU), and with ``inject`` (such a recorded
    result) returns that instead of its own, on the caller's device and in
    the dtype of its scores: one run's assignment fed to another's loss."""
    from head_detector_tpu_torch.train import loss as loss_mod
    from head_detector_tpu_torch.train.assigner import AssignmentResult

    own = loss_mod.task_aligned_assigner

    def assigner(pred_scores, *args, **kwargs):
        result = own(pred_scores, *args, **kwargs)
        if inject is not None:
            result = AssignmentResult(*(
                t.to(r.device, r.dtype) for t, r in zip(inject, result)))
        record.append(AssignmentResult(*(t.detach().cpu() for t in result)))
        return result

    loss_mod.task_aligned_assigner = assigner
    try:
        yield record
    finally:
        loss_mod.task_aligned_assigner = own


def _assignment_gap(got, want) -> dict:
    """Anchors whose foreground or assigned GT differ, and the assigned
    scores' largest difference."""
    return {"fg_differ": int((got.fg_mask != want.fg_mask).sum()),
            "gt_differ": int(((got.assigned_gt_index != want.assigned_gt_index)
                              & want.fg_mask).sum()),
            "positives": int(want.fg_mask.sum()),
            "scores_max_diff": float((got.assigned_scores.double()
                                      - want.assigned_scores.double()).abs().max())}


def layer_gradients(arch: str, weights, images, targets, loss_cfg, device) -> dict:
    """One float32 step of ``arch`` on ``device``, on the CPU and on the CPU
    in float64 from ``weights`` (``tools/grad_precision.py``'s
    ``step_gradients``): the relative error against float64 of each leaf
    module's output in the forward and of its output gradient in the
    backward (from the loss back to the stems), card and CPU; in each leg the
    first module where the card's error exceeds ``LAYER_RATIO`` times the
    CPU's (and ``LAYER_FLOOR``), and the modules of the largest ratios.  The
    assigner's result of each float32 run against float64's (anchors whose
    foreground or GT differ), and the model's gradients again with float64's
    assignment fed to both float32 runs: a difference that the assigner's
    discrete choices make goes away there."""
    stores: Dict[str, dict] = {}
    grads: Dict[str, dict] = {}
    assigned: Dict[str, list] = {}
    shared: Dict[str, dict] = {}
    for side, where, dtype in (("float64", torch.device("cpu"), torch.float64),
                               ("card", device, torch.float32),
                               ("cpu", torch.device("cpu"), torch.float32)):
        stores[side] = {}
        with assignments(assigned.setdefault(side, [])):
            _, grads[side] = gp.step_gradients(arch, weights, images, targets, loss_cfg, where,
                                               dtype, on_net=_capture_outputs(stores[side]))
        if side != "float64":
            with assignments([], inject=assigned["float64"][0]):
                _, shared[side] = gp.step_gradients(arch, weights, images, targets, loss_cfg,
                                                    where, dtype)
    order = ("card", "cpu", "float64")  # compare() holds every side to the last
    shared["float64"] = grads["float64"]
    out = {"model": gp.compare({k: grads[k] for k in order}, worst=4),
           "assignment": {side: _assignment_gap(assigned[side][0], assigned["float64"][0])
                          for side in order[:2]},
           "model_with_float64_assignment": gp.compare({k: shared[k] for k in order}, worst=4)}
    for leg in ("forward", "backward"):
        rows = _errors(stores, leg)
        first = next((r for r in rows if r["ratio"] > LAYER_RATIO and r["card"] > LAYER_FLOOR),
                     None)
        out[leg] = {"modules": len(rows), "first_over": first,
                    "largest_ratios": sorted(rows, key=lambda r: -r["ratio"])[:8],
                    "sampled": rows[:: max(len(rows) // 24, 1)]}
        print(f"[card_probes] layers: {arch}: {leg}: {len(rows)} module outputs; the first "
              f"where the card's error is over {LAYER_RATIO:g}x the CPU's (and over "
              f"{LAYER_FLOOR:g}): {json.dumps(first)}", flush=True)
        for r in out[leg]["sampled"]:
            print(f"[card_probes] layers: {arch}: {leg}: {r['module']}: card {r['card']:.3e} "
                  f"cpu {r['cpu']:.3e}", flush=True)
        print(f"[card_probes] layers: {arch}: {leg}: largest ratios "
              f"{json.dumps(out[leg]['largest_ratios'])}", flush=True)
    print(f"[card_probes] layers: {arch}: the model's gradients "
          f"{json.dumps(out['model'], default=str)}", flush=True)
    print(f"[card_probes] layers: {arch}: the assigner against float64's "
          f"{json.dumps(out['assignment'])}; the model's gradients with float64's assignment "
          f"{json.dumps(out['model_with_float64_assignment'], default=str)}", flush=True)
    return out


# bn-precision: the shipped yolo_heads_m checkpoint in train mode, float32,
# on one params-wire batch of the flagship renderer's scenes made on the CPU
# (render_bn_batch) and kept in BN_BATCH_FILE
BN_ARCH, BN_SIZE, BN_BATCH, BN_SEED = "yolo_heads_m", 128, 4, 3
# JAX's own float32 model gradient at that state against the port's float64,
# over the leaves that are not exactly zero (relative L2): measured on the
# CPU by tests/test_torch_bn_precision.py, which holds it to this value; the
# yardstick of the card, which has no jax
JAX_F32_ERROR = 2.827136e-4
BN_RATIO = 3.0  # the bar: the card's error over JAX_F32_ERROR
BN_BATCH_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bn_precision_batch.npz")
BN_BATCH_SHA256 = "b6b1942b6ce8332f54f66d3edf80cfef54ca006f5032234d631fb391bf23daa0"


def exact_zero_leaves(net) -> list:
    """The parameters of a training-layout YOLO-NAS network whose exact
    gradient in a train-mode step is 0, from its module structure: each
    QARepVGG block's ``branch_3x3_bn.bias`` and ``branch_1x1.bias`` (a
    constant per channel added before the train-mode ``post_bn``, which
    subtracts the batch mean of each channel), and each up stage's
    ``upsample.bias`` where every consumer of the upsampled tensor is a 1x1
    convolution into a train-mode BatchNorm (a constant per channel stays
    one through it)."""
    from head_detector_tpu_torch.models.blocks import QARepVGGBlock, YoloNASUpStage

    out = []
    for name, m in net.named_modules():
        if isinstance(m, QARepVGGBlock) and not (m.deploy or m.s2d):
            out += [f"{name}.branch_3x3_bn.bias", f"{name}.branch_1x1.bias"]
        elif isinstance(m, YoloNASUpStage):
            consumers = ((m.reduce_after_concat,) if m.reduce_channels
                         else (m.blocks.conv1, m.blocks.conv2))
            if all(c.conv.kernel_size == (1, 1) for c in consumers):
                out.append(f"{name}.upsample.bias")
    return out


def bn_state() -> Dict[str, torch.Tensor]:
    """The shipped checkpoint's training-layout state dict, every leaf made
    float32 (the file's are float16)."""
    import numpy as np

    from head_detector_tpu_torch import weights

    def f32(tree):
        return ({k: f32(v) for k, v in tree.items()} if isinstance(tree, dict)
                else np.asarray(tree, np.float32))

    return weights.train_state_dict_from_flax(f32(weights.load_variables(CHECKPOINT)))[0]


def render_bn_batch():
    """(uint8 images [B, H, W, 3], ``ParamTargets`` of numpy arrays): one
    params-wire batch of ``BN_BATCH`` scenes at ``BN_SIZE`` px, rendered
    from ``BN_SEED`` on the CPU.  The arrays depend on the machine's torch
    and cv2 (the card's machine renders other bytes), so the probe reads
    them from ``BN_BATCH_FILE``, which this wrote."""
    with tempfile.TemporaryDirectory() as root:
        return flagship_batches(root, BN_SIZE, 1, BN_SEED, torch.device("cpu"), BN_BATCH)[0]


def write_bn_batch(path: str = BN_BATCH_FILE) -> str:
    """Render the batch (:func:`render_bn_batch`) into ``path``; its sha256."""
    import numpy as np

    images, targets = render_bn_batch()
    np.savez_compressed(path, images=images, **targets._asdict())
    return batches_digest([(images, targets)])


def bn_batch():
    """The batch of ``BN_BATCH_FILE``: (uint8 images, ``ParamTargets`` of
    numpy arrays), held to ``BN_BATCH_SHA256``."""
    import numpy as np

    from head_detector_tpu_torch.train.param_wire import ParamTargets

    with np.load(BN_BATCH_FILE) as f:
        batch = f["images"], ParamTargets(*(f[k] for k in ParamTargets._fields))
    digest = batches_digest([batch])
    if digest != BN_BATCH_SHA256:
        raise ValueError(f"{BN_BATCH_FILE}: sha256 {digest}, not {BN_BATCH_SHA256}")
    return batch


def bn_loss_cfg():
    """``tools/grad_precision.py``'s loss settings (the arch's config)."""
    from head_detector_tpu_torch.config import CONFIG_DIR, load_config, run_config_from_dict

    return run_config_from_dict(load_config(os.path.join(CONFIG_DIR, f"{BN_ARCH}.yaml"))).loss


def split_error(got: dict, want: dict, zero) -> dict:
    """``got``'s gradient against ``want``'s (float64): the relative L2
    over the whole model, over the leaves that are not exactly zero, the
    exactly-zero leaves' norm over ``want``'s whole norm, and the leaves
    that carry most of the error (each leaf's error norm over ``want``'s
    whole norm, then its own relative L2)."""
    rest = [n for n in want if n not in zero]

    def flat(g, names):
        return torch.cat([g[n].reshape(-1) for n in names])

    norm = float(torch.linalg.norm(flat(want, list(want))))
    share = {n: float(torch.linalg.norm(got[n] - want[n])) / norm for n in rest}
    return {"model": _rel(flat(got, list(want)), flat(want, list(want))),
            "nonzero": _rel(flat(got, rest), flat(want, rest)),
            "zero_over_model": float(torch.linalg.norm(flat(got, zero))) / norm,
            "worst": [(n, share[n], _rel(got[n], want[n]))
                      for n in sorted(rest, key=lambda n: -share[n])[:4]]}


def _capture_batchnorms(store: dict):
    """``on_net`` hook: each train-mode BatchNorm's input and output
    gradient, as detached copies on their device, under its name."""
    from head_detector_tpu_torch.models.blocks import BatchNorm2d

    def record(name, x, y):
        store[name] = [x.detach().clone()]
        y.register_hook(lambda g: store[name].append(g.detach().clone()))

    def hook(net):
        for name, module in net.named_modules():
            if isinstance(module, BatchNorm2d):
                module.register_forward_hook(lambda m, i, o, n=name: record(n, i[0], o))
    return hook


def batchnorm_alone(module, x, g, device, dtype, names=None) -> tuple:
    """(output, input gradient, weight gradient, bias gradient) of the
    train-mode BatchNorm ``module`` (the port's ``BatchNorm2d.forward``)
    of ``x`` with output gradient ``g``, on ``device`` in ``dtype``; the
    card's kernel names go into ``names``."""
    import torch.nn.functional as F

    x = x.to(device, dtype).requires_grad_(True)
    w = module.weight.detach().to(device, dtype).requires_grad_(True)
    b = module.bias.detach().to(device, dtype).requires_grad_(True)
    c = x.shape[1]
    prof = None
    if names is not None:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    y = F.batch_norm(x, torch.zeros(c, device=device, dtype=dtype),
                     torch.ones(c, device=device, dtype=dtype), w, b, True, 1.0, module.eps)
    grads = torch.autograd.grad(y, (x, w, b), g.to(device, dtype))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if prof is not None:
        prof.__exit__(None, None, None)
        names.extend(sorted({e.key for e in prof.key_averages() if e.device_time_total > 0}))
    return (y.detach(), *grads)


def bn_precision(device) -> dict:
    """The model gradient of one train-mode float32 step at the shipped
    checkpoint (``bn_state``, ``bn_batch``, ``bn_loss_cfg``) against the
    port's float64 on the CPU: the port's float32 on the CPU (``cpu``), on
    ``device`` (``card``) and on ``device`` with cuDNN disabled
    (``card_native``), each over the whole model and over the leaves that
    are not exactly zero (:func:`exact_zero_leaves`, reported apart).
    Then the train-mode BatchNorm whose parameters carry most of the
    error on ``device`` alone, on its input and output gradient from that
    step: on ``device`` with cuDNN and without, on the CPU in float32, each
    against float64 (the profiler's kernel names on the card).  Last,
    ``card`` on the non-zero leaves over ``JAX_F32_ERROR``, ``ok`` when
    that is at most ``BN_RATIO``."""
    from head_detector_tpu_torch.models import build_model

    cpu = torch.device("cpu")
    state, (images, targets), loss_cfg = bn_state(), bn_batch(), bn_loss_cfg()
    zero = exact_zero_leaves(build_model(BN_ARCH, deploy=False))
    captured: Dict[str, list] = {}
    comps, grads = {}, {}
    for side, where, dtype, cudnn in (("float64", cpu, torch.float64, True),
                                      ("cpu", cpu, torch.float32, True),
                                      ("card", device, torch.float32, True),
                                      ("card_native", device, torch.float32, False)):
        with cudnn_enabled(cudnn):
            comps[side], grads[side] = gp.step_gradients(
                BN_ARCH, state, images, targets, loss_cfg, where, dtype,
                on_net=_capture_batchnorms(captured) if side == "card" else None,
                loss_dtype=dtype)
    out = {"batch_sha256": batches_digest([(images, targets)]), "exact_zero": len(zero),
           "loss": {s: c["loss"] for s, c in comps.items()},
           "errors": {s: split_error(grads[s], grads["float64"], zero)
                      for s in ("cpu", "card", "card_native")}}
    print(f"[card_probes] bn-precision: {BN_ARCH} at {BN_SIZE} px, batch {BN_BATCH}, the "
          f"shipped checkpoint in train mode, batch sha256 {out['batch_sha256']}; "
          f"{len(zero)} exactly-zero leaves; losses {json.dumps(out['loss'])}", flush=True)
    for side, e in out["errors"].items():
        print(f"[card_probes] bn-precision: {side} against float64: "
              f"{json.dumps(e, default=str)}", flush=True)
    # the BatchNorm of the worst parameters on the card, alone
    from head_detector_tpu_torch.models.blocks import BatchNorm2d

    net = build_model(BN_ARCH, deploy=False)
    net.load_state_dict(state, strict=True)
    bns = {n: m for n, m in net.named_modules() if isinstance(m, BatchNorm2d)}

    def error(n):  # the BatchNorm's share of the card's error
        keys = [f"{n}.{p}" for p in ("weight", "bias") if f"{n}.{p}" not in zero]
        return sum(float(torch.linalg.norm(grads["card"][k] - grads["float64"][k])) for k in keys)

    worst = max(bns, key=error)
    x, g = captured[worst]
    ref = batchnorm_alone(bns[worst], x, g, cpu, torch.float64)
    alone = {"module": worst, "shape": list(x.shape)}
    for side, where, cudnn in (("card", device, True), ("card_native", device, False),
                               ("cpu", cpu, True)):
        names = [] if where.type == "cuda" else None
        with cudnn_enabled(cudnn):
            legs = batchnorm_alone(bns[worst], x, g, where, torch.float32, names)
        alone[side] = {leg: _rel(a, r) for leg, a, r in zip(("y", "grad_x", "grad_w", "grad_b"),
                                                           legs, ref)}
        if names is not None:
            alone[side]["kernels"] = names
    out["batchnorm_alone"] = alone
    print(f"[card_probes] bn-precision: BatchNorm2d alone, {worst}: "
          f"{json.dumps(alone, default=float)}", flush=True)
    out["card_over_jax"] = out["errors"]["card"]["nonzero"] / JAX_F32_ERROR
    out["ok"] = out["card_over_jax"] <= BN_RATIO
    print(f"[card_probes] bn-precision: the card's error on the non-zero leaves "
          f"{out['errors']['card']['nonzero']:.4e} is {out['card_over_jax']:.3f}x JAX's "
          f"float32 {JAX_F32_ERROR:.4e} (bar {BN_RATIO:g}x): "
          f"{'ok' if out['ok'] else 'OVER'}", flush=True)
    return out


LOG_LINE = re.compile(r"^\[epoch (\d+) step (\d+)\] (.*?)(?: \(|$)")
LOGGED = ("loss", "cls", "iou", "pose", "verts")
PAIRED = ("loss", "cls", "iou", "pose", "verts", "rot+dfl")


def read_step_log(path: str) -> Dict[int, dict]:
    """step -> {"epoch": E, component: value} of a campaign's step log (a
    file, or every ``*.log`` of a directory in name order; a step logged
    twice, as by a resumed chunk, keeps its last line)."""
    files = ([os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith(".log")]
             if os.path.isdir(path) else [path])
    out: Dict[int, dict] = {}
    for name in files:
        with open(name) as f:
            for line in f:
                m = LOG_LINE.match(line.strip())
                if not m:
                    continue
                values = dict(kv.split("=") for kv in m.group(3).split())
                if not set(LOGGED) <= set(values):
                    continue
                row = {k: float(values[k]) for k in LOGGED}
                row["rot+dfl"] = row["loss"] - sum(row[k] for k in LOGGED[1:])
                out[int(m.group(2))] = {"epoch": int(m.group(1)), **row}
    return out


def _detrended(steps, values):
    import numpy as np

    x = np.asarray(steps, np.float64)
    x = (x - x.mean()) / max(float(x.std()), 1e-12)
    y = np.asarray(values, np.float64)
    return y - np.polyval(np.polyfit(x, y, 2), x)


def paired_losses(reference: Dict[int, dict], port: Dict[int, dict]) -> Dict[int, dict]:
    """epoch -> component -> {"pairs", "mean_diff" (port - reference),
    "stderr", "detrended_corr"} over the steps both logs hold (module
    docstring)."""
    import numpy as np

    steps = sorted(set(reference) & set(port))
    out: Dict[int, dict] = {}
    for epoch in sorted({reference[s]["epoch"] for s in steps}):
        ours = [s for s in steps if reference[s]["epoch"] == epoch == port[s]["epoch"]]
        out[epoch] = {}
        for c in PAIRED:
            a = np.array([reference[s][c] for s in ours])
            b = np.array([port[s][c] for s in ours])
            d = b - a
            corr = float(np.corrcoef(_detrended(ours, a), _detrended(ours, b))[0, 1]) \
                if len(ours) > 3 else float("nan")
            out[epoch][c] = {"pairs": len(ours), "mean_diff": float(d.mean()),
                             "stderr": float(d.std(ddof=1) / np.sqrt(len(d)))
                             if len(d) > 1 else float("nan"),
                             "detrended_corr": corr}
    return out


def losses(args) -> dict:
    table = paired_losses(read_step_log(args.reference), read_step_log(args.port))
    print(f"[card_probes] losses: {args.port} minus {args.reference}, paired by step: "
          "mean (standard error) [detrended correlation]")
    print("| Epoch | pairs | " + " | ".join(PAIRED) + " |")
    print("| --- " * (len(PAIRED) + 2) + "|")
    for epoch, row in table.items():
        cells = [f"{row[c]['mean_diff']:+.4f} ({row[c]['stderr']:.4f}) "
                 f"[{row[c]['detrended_corr']:.2f}]" for c in PAIRED]
        print(f"| {epoch} | {row['loss']['pairs']} | " + " | ".join(cells) + " |")
    return table


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=["pose-stem", "determinism", "validation", "losses",
                                      "flagship-steps", "layers", "loss-precision",
                                      "bn-precision"])
    ap.add_argument("--arch", default=None,
                    help="default: segformer (pose-stem), yolo_heads_m (validation, "
                         "flagship-steps)")
    ap.add_argument("--size", type=int, default=None,
                    help="default: 320 (pose-stem), 512 (flagship-steps)")
    ap.add_argument("--bf16-steps", type=int, default=50)
    ap.add_argument("--f32-steps", type=int, default=8)
    ap.add_argument("--out", default=None, help="flagship-steps: one JSON line a step")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", help="validation: a campaign's checkpoint directory")
    ap.add_argument("--step", default="best", help="validation: N, best, worst or latest")
    ap.add_argument("--data-dir", help="validation: the rendered set (train and val)")
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--calib-images", type=int, default=64)
    ap.add_argument("--cpu-images", type=int, default=64)
    ap.add_argument("--export-ema", default=None, help="validation: PATH.msgpack.gz")
    ap.add_argument("--reference", help="losses: the reference campaign's log or log directory")
    ap.add_argument("--port", help="losses: the other campaign's log or log directory")
    args = ap.parse_args(argv)
    if args.probe == "losses":
        return losses(args)
    if args.probe == "bn-precision":
        from head_detector_tpu_torch.device import resolve_device

        out = bn_precision(resolve_device(args.device))
        if not out["ok"]:
            raise SystemExit(1)
        return out
    if args.probe in ("validation", "flagship-steps"):
        args.arch = args.arch or "yolo_heads_m"
        args.size = args.size or 512
        return validation(args) if args.probe == "validation" else flagship_steps(args)
    args.arch = args.arch or "segformer"
    args.size = args.size or 320
    if args.probe in ("layers", "loss-precision"):
        from head_detector_tpu_torch.device import resolve_device

        probe = layers if args.probe == "layers" else loss_precision_at
        return probe(args.arch, args.size, resolve_device(args.device))
    return pose_stem(args) if args.probe == "pose-stem" else determinism(args)


if __name__ == "__main__":
    main()
