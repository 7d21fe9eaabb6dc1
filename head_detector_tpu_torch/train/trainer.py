"""Training step: AdamW with the weight-decay mask, the optax LR schedule,
parameter EMA, one train-mode forward + loss + backward per step.

Counterpart of ``head_detector_tpu/train/trainer.py`` on one device:

* ``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8 outside the square root)
  with two parameter groups split by the rule of ``_wd_mask``; AdamW's
  decoupled decay ``p * (1 - lr * wd)`` uses the old ``p``, as optax's
  ``add_decayed_weights`` does;
* the learning rate is set by hand before every step from the optax
  schedule's formula (linear warmup joined to a cosine decay), evaluated at
  the number of steps already taken, as optax does;
* EMA over the parameters only (BatchNorm statistics are not averaged),
  ``e = e * d + p * (1 - d)`` at decay ``d(step + 1)``;
* images arrive as uint8 NHWC and are divided by 255 on the device;
* mixed precision is the model's compute dtype (``YoloHeads.dtype``); the
  parameters, the optimizer state and the loss stay float32.

Float32 products and convolutions run with TF32 off (``device.py``).  Data
parallelism over several cards is not part of this module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch

from head_detector_tpu_torch.device import exact_float32
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models.yolo_heads import YoloHeads
from head_detector_tpu_torch.train.loss import LossConfig, Targets, yolo_heads_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Knob names follow the reference training_hyperparams YAML."""

    initial_lr: float = 3e-4
    cosine_final_lr_ratio: float = 0.1
    warmup_initial_lr: float = 1e-6
    lr_warmup_steps: int = 128
    max_steps: int = 10000
    weight_decay: float = 1e-6
    zero_weight_decay_on_bias_and_bn: bool = True
    ema: bool = True
    ema_decay: float = 0.9997
    ema_beta: float = 50.0


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate: a linear warmup from ``warmup_initial_lr`` to
    ``initial_lr`` over ``lr_warmup_steps``, then a cosine decay to
    ``cosine_final_lr_ratio * initial_lr`` over the remaining steps
    (``optax.join_schedules`` of ``linear_schedule`` and
    ``cosine_decay_schedule``, in float32)."""
    warm = cfg.lr_warmup_steps
    cosine_steps = float(max(cfg.max_steps - warm, 1))
    f32 = np.float32

    def schedule(step: int) -> float:
        if warm > 0 and step < warm:
            frac = f32(1) - f32(min(max(step, 0), warm)) / f32(warm)
            return float(f32(cfg.warmup_initial_lr - cfg.initial_lr) * frac
                         + f32(cfg.initial_lr))
        count = f32(min(step - warm, cosine_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / f32(cosine_steps)))
        alpha = cfg.cosine_final_lr_ratio
        return float(f32(cfg.initial_lr) * (f32(1.0 - alpha) * decay + f32(alpha)))

    return schedule


def _wd_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether it takes weight decay: not a leaf of one
    dimension or fewer (biases, BatchNorm scales, the scalar ``alpha``) and
    not under a BatchNorm scope (``bn``, ``post_bn``, ``branch_3x3_bn``)
    (``zero_weight_decay_on_bias_and_bn: True``)."""
    out = {}
    for name, p in model.named_parameters():
        scopes = set(name.split(".")[:-1])
        out[name] = p.dim() > 1 and not scopes & {"bn", "post_bn", "branch_3x3_bn"}
    return out


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW over the model's parameters, in two groups by :func:`_wd_mask`
    (one group, all decayed, without ``zero_weight_decay_on_bias_and_bn``).
    The groups' ``lr`` is set before every step by the train step."""
    params = dict(model.named_parameters())
    if cfg.zero_weight_decay_on_bias_and_bn:
        mask = _wd_mask(model)
        groups = [
            {"params": [p for n, p in params.items() if mask[n]],
             "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0},
        ]
    else:
        groups = [{"params": list(params.values()), "weight_decay": cfg.weight_decay}]
    return torch.optim.AdamW(groups, lr=cfg.initial_lr, betas=(0.9, 0.999), eps=1e-8)


def _ema_decay(step: int, cfg: TrainConfig) -> float:
    """SG 'exp' decay ramp, in float32: decay * (1 - exp(-step * beta / max_steps))."""
    x = np.float32(step) / np.float32(max(cfg.max_steps, 1))
    return float(np.float32(cfg.ema_decay) * (np.float32(1) - np.exp(-x * np.float32(cfg.ema_beta))))


class TrainState:
    """What a train step updates: the model (parameters and BatchNorm
    statistics), the optimizer (Adam moments and counts), the EMA of the
    parameters and the step count."""

    def __init__(self, model: YoloHeads, cfg: TrainConfig):
        self.model = model
        self.optimizer = make_optimizer(cfg, model)
        self.schedule = make_lr_schedule(cfg)
        self.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.step = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.model.named_parameters()}

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {n: b for n, b in self.model.named_buffers()}

    def state_dict(self) -> dict:
        """Everything a resume needs, as CPU tensors."""
        cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}  # noqa: E731
        opt = self.optimizer.state_dict()
        opt["state"] = {k: cpu(v) for k, v in opt["state"].items()}
        return {"params": cpu(self.params()), "batch_stats": cpu(self.batch_stats()),
                "ema_params": cpu(self.ema), "opt_state": opt, "step": int(self.step)}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict({**state["params"], **state["batch_stats"]}, strict=True)
        self.optimizer.load_state_dict(state["opt_state"])
        dev = next(self.model.parameters()).device
        self.ema = {k: v.to(dev).clone() for k, v in state["ema_params"].items()}
        self.step = int(state["step"])


def images_to_device(images, device: torch.device) -> torch.Tensor:
    """uint8 (or float) NHWC images -> float32 NCHW in [0, 1] on ``device``;
    the division by 255 runs on the device."""
    x = torch.as_tensor(images).to(device)
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / 255.0
    return x.permute(0, 3, 1, 2).contiguous()


def make_loss_fn(model: YoloHeads, flame_model: FlameModel,
                 loss_cfg: LossConfig) -> Callable:
    """The train-mode loss forward: ``(images NCHW float, targets) -> (total,
    components)``; BatchNorm statistics update as a side effect."""

    def loss_fn(images: torch.Tensor, targets: Targets):
        model.train()
        _, raw = model(images)
        return yolo_heads_loss(flame_model, raw, targets, loss_cfg)

    return loss_fn


def make_train_step(model: YoloHeads, flame_model: FlameModel, loss_cfg: LossConfig,
                    train_cfg: TrainConfig) -> Callable:
    """``train_step(state, images, targets) -> (state, components)``: one
    AdamW step on the batch, updating ``state`` in place.  ``images`` are
    uint8 NHWC (numpy or torch), ``targets`` the five ``Targets`` fields as
    arrays; both are moved to the model's device.  The components stay on the device
    (reading them waits for the step)."""
    loss_fn = make_loss_fn(model, flame_model, loss_cfg)

    def train_step(state: TrainState, images, targets: Targets):
        dev = next(model.parameters()).device
        x = images_to_device(images, dev)
        targets = Targets(*targets).to(dev)
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        with exact_float32():
            total, components = loss_fn(x, targets)
            total.backward()
            state.optimizer.step()
            state.step += 1
            if train_cfg.ema:
                d = _ema_decay(state.step, train_cfg)
                names, params = zip(*model.named_parameters())
                ema = [state.ema[n] for n in names]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [p.detach() for p in params],
                                    alpha=float(np.float32(1) - np.float32(d)))
        return state, {k: v.detach() for k, v in components.items()}

    return train_step
