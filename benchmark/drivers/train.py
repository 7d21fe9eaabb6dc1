"""The training step, fed on the device: the port's ``make_train_step``
(forward, loss, backward, AdamW + EMA) on batches already on the card.

Set-up renders ``batches`` x ``batch`` scenes with their GT from the seed,
draws the initial weights from the seed, builds one ``TrainState`` and one
step function, and drives them through the first ``checked_steps`` steps on
distinct batches, keeping what the check compares (each step's loss, the
first gradient as AdamW holds it, the change of the parameters and of the
EMA), then one more step.  The window hands that same state to the same
step, cycling the batches, until ``seconds`` have passed, then waits for the
card: images/s over the whole window.  After the window the reference
repeats the checked steps in float32 from the same weights and batches.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import checks, work
from benchmark.harness.core import Check, Window, held
from benchmark.harness.scenes import Scenes, batches
from benchmark.harness.weights import initial_state
from benchmark.reference import precision
from benchmark.reference.assets_io import get_indices
from benchmark.reference.flame import FlameModel
from benchmark.reference.pipeline import arch_from_dict, build_model, require_port_arch
from benchmark.reference.train_step import TrainStep, loss_config

BETA1 = 0.9


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[n].float().norm() for n in names]).cpu().tolist()
    return dict(zip(names, norms))


class Cell:
    def __init__(self, ctx):
        from head_detector_tpu_torch.assets_io import get_indices as port_indices
        from head_detector_tpu_torch.flame import FlameModel as PortFlame
        from head_detector_tpu_torch.models import build_model as port_build, get_arch
        from head_detector_tpu_torch.train.loss import LossConfig
        from head_detector_tpu_torch.train.trainer import (
            TrainConfig,
            TrainState,
            make_train_step,
        )

        t, recipe = ctx.traffic, ctx.config["recipe"]
        self.ctx = ctx
        port_arch = get_arch(ctx.config["name"])
        require_port_arch(ctx.config, port_arch)
        self.arch = arch_from_dict(ctx.config["arch"])
        scenes = Scenes(ctx.seed, t["batches"] * t["batch"], t["image_size"], t["max_heads"],
                        ctx.device)
        self.batches = batches(scenes, t["batch"], recipe["max_gt_boxes"])
        del scenes

        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[recipe["mixed_precision"]]
        self.model = port_build(port_arch, dtype=dtype, deploy=False).to(ctx.device)
        start = initial_state(self.arch, ctx.seed, ctx.device)
        self.model.load_state_dict(start, strict=True)
        crit = dict(recipe["criterion"])
        crit["indexes_subset"] = port_indices()[crit["indexes_subset"]]
        train_cfg = TrainConfig(
            initial_lr=recipe["initial_lr"], cosine_final_lr_ratio=recipe["cosine_final_lr_ratio"],
            warmup_initial_lr=recipe["warmup_initial_lr"], lr_warmup_steps=recipe["lr_warmup_steps"],
            max_steps=recipe["max_steps"], weight_decay=recipe["weight_decay"],
            zero_weight_decay_on_bias_and_bn=recipe["zero_weight_decay_on_bias_and_bn"],
            ema=recipe["ema"], ema_decay=recipe["ema_decay"], ema_beta=recipe["ema_beta"])
        self.state = TrainState(self.model, train_cfg)
        self.step = make_train_step(self.model, PortFlame.from_assets(device=ctx.device),
                                    LossConfig(**crit), train_cfg)
        self.steps = 0

        # the checked steps, through the window's own call and feed
        names = {p: n for n, p in self.model.named_parameters()}
        self.losses: List[Dict[str, float]] = []
        for k in range(t["checked_steps"]):
            comps = self._step()
            self.losses.append(comps)
            if k == 0:
                self.first_grad = leaf_norms({
                    names[p]: s["exp_avg"] / (1 - BETA1)
                    for p, s in self.state.optimizer.state.items()})
                self.bn_change = statistics_change(self.model, start)
        self.losses = [{k: float(v) for k, v in c.items()} for c in self.losses]
        params = self.state.params()
        self.change = leaf_norms({n: params[n] - start[n] for n in params})
        self.ema_change = leaf_norms({n: self.state.ema[n] - start[n] for n in params})
        del start, params
        self._step()
        self._sync()

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _step(self) -> Dict[str, torch.Tensor]:
        images, targets = self.batches[self.steps % len(self.batches)]
        self.steps += 1
        with torch.profiler.record_function("train.step"):
            _, comps = self.step(self.state, images, targets)
        return comps

    def window(self, seconds: float) -> Window:
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._step()
            n += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        images = n * self.ctx.traffic["batch"]
        self.peak_bytes = (torch.cuda.max_memory_allocated(self.ctx.device)
                           if self.ctx.device.type == "cuda" else 0)
        return Window(metrics={"train_images_per_s": images / elapsed}, attempted=n, failed=0,
                      facts={"images": images, "seconds": elapsed, "steps": n})

    def burst(self) -> None:
        for _ in range(self.ctx.traffic["burst_steps"]):
            self._step()

    def work(self) -> Dict[str, float]:
        return {"flops_per_image": work.train_step_flops(self.arch, self.ctx.traffic["image_size"])}

    def counters(self) -> Dict[str, float]:
        return {"peak_bytes": float(self.peak_bytes)}

    def judge(self) -> List[Check]:
        del self.step, self.state, self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        readings = reference_readings(self.ctx, self.batches[:self.ctx.traffic["checked_steps"]])
        self.numbers = compare(self.losses, self.first_grad, self.change, self.ema_change,
                               self.bn_change, readings)
        print(f"train check: worst leaves {self.numbers.pop('where')}; losses "
              f"{[c['loss'] for c in self.losses]} against "
              f"{[c['loss'] for c in readings['losses']]}", file=sys.stderr)
        return held(self.numbers, self.ctx.limits)


def statistics_change(model, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Norms of each BatchNorm running statistic's change from ``start``:
    after the first step, the first forward's batch statistics, which no
    assignment of the loss touches."""
    return leaf_norms({n: b - start[n] for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))})


def reference_readings(ctx, checked_batches, fp8: bool = False, rows: int = 0) -> dict:
    """The reference's losses, first gradient norms and changes over the
    checked steps, float32 with TF32 off (``fp8``: the control; ``rows``:
    each batch cut to its first ``rows`` images, the fault of a step that
    leaves out part of its batch)."""
    precision.set_float32(False)
    arch = arch_from_dict(ctx.config["arch"])
    start = initial_state(arch, ctx.seed, ctx.device)
    model = build_model(arch, start, ctx.device, train=True)
    flame = FlameModel.from_assets(device=ctx.device)
    step = TrainStep(model, flame, ctx.config["recipe"],
                     loss_config(ctx.config["recipe"], np.asarray(get_indices()["head"])))
    losses, first_grad = [], None
    for k, (images, targets) in enumerate(checked_batches):
        if rows:
            images, targets = images[:rows], tuple(t[:rows] for t in targets)
        if fp8:
            with precision.fp8_convolutions():
                comps = step(images, targets)
        else:
            comps = step(images, targets)
        losses.append({k: float(v) for k, v in comps.items()})
        if k == 0:
            first_grad = leaf_norms({n: p.grad for n, p in model.named_parameters()
                                     if p.grad is not None})
            bn_change = statistics_change(model, start)
    params = {n: p.detach() for n, p in model.named_parameters()}
    return {"losses": losses, "first_grad": first_grad, "bn_change": bn_change,
            "change": leaf_norms({n: params[n] - start[n] for n in params}),
            "ema_change": leaf_norms({n: step.ema[n] - start[n] for n in params})}


def compare(losses, first_grad, change, ema_change, bn_change,
            want: dict) -> Dict[str, float]:
    """The training numbers: the relative gap of the loss and of its
    classification term (``cls``) in the first and in the worst checked
    step, and for the first gradient, the parameters' change and the EMA's
    change over the checked steps, and for the BatchNorm statistics' change
    in the first step (``bn``), the gap of the worst leaf and of the median
    one (``checks.leaf_gap``).  ``losses``: per step the loss
    components as ``yolo_heads_loss`` names them."""
    keep = checks.moving_leaves(want["first_grad"])
    out: Dict = {"where": {}}
    for name, key in (("loss", "loss"), ("cls", "loss_cls")):
        gaps = [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(losses, want["losses"])]
        out[name + "1"], out[name] = gaps[0], max(gaps)
    for name, got, ref in (("grad", first_grad, want["first_grad"]),
                           ("step", change, want["change"]),
                           ("ema", ema_change, want["ema_change"])):
        got = {n: got.get(n, 0.0) for n in keep}
        out[name], out["where"][name] = checks.leaf_gap(got, ref, keep)
        out[name + "_median"] = checks.median_leaf_gap(got, ref, keep)
    stats = [n for n, v in want["bn_change"].items() if v > 0]
    got = {n: bn_change.get(n, 0.0) for n in stats}
    out["bn"], out["where"]["bn"] = checks.leaf_gap(got, want["bn_change"], stats)
    out["bn_median"] = checks.median_leaf_gap(got, want["bn_change"], stats)
    return out
