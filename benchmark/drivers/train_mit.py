"""The training step of SegFormerYoloHeads (a MiT encoder with the L preset's
NDFL heads), fed on the device: ``drivers/train.py``'s cell on the port's
``build_model("segformer", deploy=False)`` and ``make_train_step``.

Set-up renders ``batches`` x ``batch`` scenes with their GT from the seed,
draws the initial state from the seed (``harness/weights_mit.py``), builds
one ``TrainState`` and one step function, and drives them through the first
``checked_steps`` steps on distinct batches, keeping what the check compares
(each step's loss, the first gradient as AdamW holds it, the change of the
parameters and of the EMA, the BatchNorm statistics' change), then one more
step.  The window, the burst and the counters are ``train.py``'s.  After the
window the reference (``reference/models/segformer.py``, float32, TF32 off)
repeats the checked steps from the same state and batches, and
:func:`compare` (``train.py``'s numbers and ``positives``) gives the numbers
that the limits hold.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from benchmark.drivers import train
from benchmark.drivers.train import BETA1, Cell as TrainCell, leaf_norms, statistics_change
from benchmark.harness import work_mit
from benchmark.harness.core import Check, held
from benchmark.harness.scenes import Scenes, batches
from benchmark.harness.weights_mit import initial_state
from benchmark.reference import precision, train_step
from benchmark.reference.assets_io import get_indices
from benchmark.reference.flame import FlameModel
from benchmark.reference.models import segformer
from benchmark.reference.pipeline import arch_from_dict, require_port_arch
from benchmark.reference.train_step import TrainStep, loss_config

FAULTS = ("unchanged", "ema")


def reference_arch(config: dict):
    """(``MiTCfg``, heads ``ArchCfg``) of the reference, from the
    configuration's ``arch`` group."""
    return segformer.mit_from_dict(config["arch"]["mit"]), arch_from_dict(
        config["arch"]["heads"])


def port_model(config: dict, dtype: torch.dtype):
    """The port's network of the configuration: ``build_model("segformer")``
    for MiT-B5 with the L heads, the same class at the configuration's widths
    for another MiT (the benchmark's tests run a tiny one on the CPU)."""
    from head_detector_tpu_torch.models import MiTCfg, SegFormerYoloHeads, build_model, get_arch

    heads = config["arch"]["heads"]
    port_heads = get_arch(heads["name"])
    require_port_arch({"name": heads["name"], "arch": heads}, port_heads)
    mit = MiTCfg(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in config["arch"]["mit"].items()})
    if mit == MiTCfg() and port_heads == get_arch("yolo_heads_l"):
        model = build_model("segformer", dtype=dtype, deploy=False)
    else:
        model = SegFormerYoloHeads(mit, port_heads, dtype=dtype)
    if (model.mit, model.arch) != (mit, port_heads):
        raise ValueError(f"the port's SegFormer differs from {config['name']}")
    return model


class Cell(TrainCell):
    def __init__(self, ctx):
        from head_detector_tpu_torch.assets_io import get_indices as port_indices
        from head_detector_tpu_torch.flame import FlameModel as PortFlame
        from head_detector_tpu_torch.train.loss import LossConfig
        from head_detector_tpu_torch.train.trainer import (
            TrainConfig,
            TrainState,
            make_train_step,
        )

        t, recipe = ctx.traffic, ctx.config["recipe"]
        self.ctx = ctx
        self.mit, self.arch = reference_arch(ctx.config)
        scenes = Scenes(ctx.seed, t["batches"] * t["batch"], t["image_size"], t["max_heads"],
                        ctx.device)
        self.batches = batches(scenes, t["batch"], recipe["max_gt_boxes"])
        del scenes

        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[recipe["mixed_precision"]]
        self.model = port_model(ctx.config, dtype).to(ctx.device)
        start = initial_state(self.mit, self.arch, ctx.seed, ctx.device)
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
            self.losses.append(self._step())
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

    def work(self) -> Dict[str, float]:
        return {"flops_per_image": work_mit.train_step_flops(self.mit, self.arch,
                                                             self.ctx.traffic["image_size"])}

    def judge(self) -> List[Check]:
        del self.step, self.state, self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        readings = reference_readings(self.ctx, self.batches[:self.ctx.traffic["checked_steps"]])
        self.numbers = compare(self.losses, self.first_grad, self.change, self.ema_change,
                               self.bn_change, readings)
        print(f"train_mit check: worst leaves {self.numbers.pop('where')}; losses "
              f"{[c['loss'] for c in self.losses]} against "
              f"{[c['loss'] for c in readings['losses']]}", file=sys.stderr)
        return held(self.numbers, self.ctx.limits)


def compare(losses, first_grad, change, ema_change, bn_change, want: dict) -> Dict[str, float]:
    """``train.py``'s numbers, and ``positives``: the widest relative gap,
    over the checked steps, of the count of anchors the assigner made
    positive (``num_pos``).  Half a batch halves it; bfloat16 moves a few
    anchors across the assigner's cut.  With BatchNorms in the heads alone,
    half a batch moves their statistics less than bfloat16 does over 52
    blocks, so no other number tells it."""
    out = train.compare(losses, first_grad, change, ema_change, bn_change, want)
    out["positives"] = max(abs(a["num_pos"] - b["num_pos"]) / max(b["num_pos"], 1.0)
                           for a, b in zip(losses, want["losses"]))
    return out


def planted(control: bool, fault: Optional[str]):
    """What a reference step runs under: the control's float8 products, the
    EMA fault's decay of 1, or nothing."""
    if control:
        return precision.rounded_products(precision.round_e4m3, matmuls=True)
    if fault == "ema":
        return mock.patch.object(train_step, "ema_decay", lambda step, recipe: 1.0)
    return contextlib.nullcontext()


def reference_readings(ctx, checked_batches, control: bool = False, rows: int = 0,
                       fault: Optional[str] = None) -> dict:
    """The reference's losses, first gradient norms and changes over the
    checked steps, float32 with TF32 off.  ``control``: every convolution's
    and matmul's operands (the Linears, the attention's two products, the
    heads' convolutions) rounded to float8 e4m3; ``rows``: each batch cut to
    its first ``rows`` images; ``fault``: ``unchanged`` (no AdamW step, so
    the parameters and their EMA keep the initial state) or ``ema`` (the
    EMA's decay 1, so the EMA alone keeps it)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    precision.set_float32(False)
    mit, arch = reference_arch(ctx.config)
    start = initial_state(mit, arch, ctx.seed, ctx.device)
    model = segformer.build_model(mit, arch, start, ctx.device, train=True)
    flame = FlameModel.from_assets(device=ctx.device)
    recipe = ctx.config["recipe"]
    step = TrainStep(model, flame, recipe,
                     loss_config(recipe, np.asarray(get_indices()["head"])))
    if fault == "unchanged":
        step.optimizer.step = lambda *args, **kwargs: None
    losses, first_grad = [], None
    for k, (images, targets) in enumerate(checked_batches):
        if rows:
            images, targets = images[:rows], tuple(t[:rows] for t in targets)
        with planted(control, fault):
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
