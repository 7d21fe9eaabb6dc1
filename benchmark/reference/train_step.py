"""The reference's training step: the float32 training-layout forward, the
loss, the backward, AdamW with the weight-decay mask and the schedule's
learning rate, and the parameter EMA.

A frozen copy of the port's one-device step (``train/trainer.py``: the
groups of ``_wd_mask``, the optax warmup-cosine formula evaluated in
float32, the EMA ramp), on ``torch.optim.AdamW``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from benchmark.reference.loss import LossConfig, Targets, yolo_heads_loss


def lr_schedule(recipe: dict) -> Callable[[int], float]:
    warm = recipe["lr_warmup_steps"]
    cosine_steps = float(max(recipe["max_steps"] - warm, 1))
    f32 = np.float32

    def schedule(step: int) -> float:
        if warm > 0 and step < warm:
            frac = f32(1) - f32(min(max(step, 0), warm)) / f32(warm)
            return float(f32(recipe["warmup_initial_lr"] - recipe["initial_lr"]) * frac
                         + f32(recipe["initial_lr"]))
        count = f32(min(step - warm, cosine_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / f32(cosine_steps)))
        alpha = recipe["cosine_final_lr_ratio"]
        return float(f32(recipe["initial_lr"]) * (f32(1.0 - alpha) * decay + f32(alpha)))

    return schedule


def ema_decay(step: int, recipe: dict) -> float:
    x = np.float32(step) / np.float32(max(recipe["max_steps"], 1))
    return float(np.float32(recipe["ema_decay"])
                 * (np.float32(1) - np.exp(-x * np.float32(recipe["ema_beta"]))))


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay on kernels only: not a leaf of one dimension or fewer and
    not under a BatchNorm scope."""
    return p.dim() > 1 and not set(name.split(".")[:-1]) & {"bn", "post_bn", "branch_3x3_bn"}


def loss_config(recipe: dict, head_indices: np.ndarray) -> LossConfig:
    c = dict(recipe["criterion"])
    c["indexes_subset"] = head_indices if c.get("indexes_subset") == "head" else None
    return LossConfig(**c)


class TrainStep:
    """``step(images uint8 NHWC, targets) -> loss components``, in place on
    ``model``, its AdamW state and ``self.ema``."""

    def __init__(self, model, flame, recipe: dict, loss_cfg: LossConfig):
        self.model, self.flame, self.recipe, self.loss_cfg = model, flame, recipe, loss_cfg
        params = dict(model.named_parameters())
        groups = [{"params": [p for n, p in params.items() if decays(n, p)],
                   "weight_decay": recipe["weight_decay"]},
                  {"params": [p for n, p in params.items() if not decays(n, p)],
                   "weight_decay": 0.0}]
        self.optimizer = torch.optim.AdamW(groups, lr=recipe["initial_lr"],
                                           betas=(0.9, 0.999), eps=1e-8)
        self.schedule = lr_schedule(recipe)
        self.ema = {n: p.detach().clone() for n, p in params.items()}
        self.count = 0

    def __call__(self, images: torch.Tensor, targets) -> Dict[str, torch.Tensor]:
        x = images.to(torch.float32).permute(0, 3, 1, 2).contiguous() / 255.0
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        self.model.train()
        _, raw = self.model(x)
        total, components = yolo_heads_loss(self.flame, raw, Targets(*targets), self.loss_cfg)
        total.backward()
        self.optimizer.step()
        self.count += 1
        d = ema_decay(self.count, self.recipe)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                self.ema[n].mul_(d).add_(p.detach(), alpha=float(np.float32(1) - np.float32(d)))
        return {k: v.detach() for k, v in components.items()}
