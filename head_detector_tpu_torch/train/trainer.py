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
* GT arrives dense (``Targets``) or as parameters (``ParamTargets``, the
  params wire), decoded on the device inside the step;
* mixed precision is the model's compute dtype (``YoloHeads.dtype``); the
  parameters, the optimizer state and the loss stay float32;
* with ``grad_clip_norm`` the gradients are clipped by their global norm
  before AdamW, with optax's ``clip_by_global_norm`` rule
  (:func:`clip_by_global_norm_`).

Float32 products and convolutions run with TF32 off (``device.py``).

Under a profiler session (``profiling.py``) a step records the span
``trainer.step``, keyed by the steps taken before it, around its children
``trainer.inputs`` (device copies, learning rate, ``zero_grad``),
``trainer.forward_loss``, ``trainer.backward``, ``trainer.optimizer``
(all-reduce, clip, AdamW) and ``trainer.ema``.

Data parallelism (``group``, one process a rank, ``distributed.py``): every
rank holds its rows of the global batch and the step computes the same
function of the global batch as the one-device step, as the JAX step jitted
over a ``data`` mesh does.  The BatchNorms normalise over the global batch
(``models/blocks.py``), the loss takes the global normalisers and positive
budget (``train/loss.py``), and each rank's loss is its share of the global
loss, so the global gradient is the *sum* of the ranks' gradients.  That
sum is one all-reduce of the flattened gradients after the backward, not
``DistributedDataParallel``: DDP would average (the loss would have to carry
a factor W), its buckets are reduced in an order that depends on the
backward's timing, and the BatchNorms' collectives already run inside the
backward; one buffer a dtype keeps the summation order fixed, so every rank
applies the same bits, and AdamW, the EMA and the BatchNorm statistics stay
bit-identical across ranks.  ``grad_clip_norm`` clips by the norm of the
summed gradient.  The start state comes from rank 0 (:func:`broadcast_state`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from head_detector_tpu_torch.device import exact_float32
from head_detector_tpu_torch.distributed import all_reduce_flat_, broadcast_
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models.blocks import set_process_group
from head_detector_tpu_torch.models.yolo_heads import YoloHeads
from head_detector_tpu_torch.profiling import span
from head_detector_tpu_torch.train.loss import LossConfig, Targets, yolo_heads_loss
from head_detector_tpu_torch.train.param_wire import ParamTargets, decode_param_targets


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
    grad_clip_norm: Optional[float] = None


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip ``grads`` in place as optax's ``clip_by_global_norm(max_norm)``
    does: with ``norm = sqrt(sum of every element squared)``, each gradient
    stays as it is when ``norm < max_norm`` and becomes ``g / norm *
    max_norm`` otherwise (``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6`` and always scales).  Decided on the device, without a
    host sync.  Returns the norm."""
    norm = torch.sqrt(torch.stack([torch.sum(g.float() * g.float()) for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


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
        self.grad_norm: Optional[torch.Tensor] = None  # with grad_clip_norm, the last step's

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


def broadcast_state(state: TrainState, group) -> None:
    """Give every rank rank 0's parameters, BatchNorm statistics and EMA."""
    tensors = [p.data for p in state.model.parameters()] + list(state.model.buffers())
    broadcast_(tensors + list(state.ema.values()), group)


def make_loss_fn(model: YoloHeads, flame_model: FlameModel,
                 loss_cfg: LossConfig, group=None) -> Callable:
    """The train-mode loss forward: ``(images NCHW float, targets) -> (total,
    components)``; BatchNorm statistics update as a side effect.  Targets in
    parameter form (``ParamTargets``, the params wire) are decoded on the
    model's device after the forward, before the loss.  With ``group`` the
    loss is the global batch's (``yolo_heads_loss``)."""

    def loss_fn(images: torch.Tensor, targets):
        model.train()
        _, raw = model(images)
        if isinstance(targets, ParamTargets):
            targets = decode_param_targets(flame_model, targets)
        return yolo_heads_loss(flame_model, raw, targets, loss_cfg, group=group)

    return loss_fn


def make_train_step(model: YoloHeads, flame_model: FlameModel, loss_cfg: LossConfig,
                    train_cfg: TrainConfig, group=None) -> Callable:
    """``train_step(state, images, targets) -> (state, components)``: one
    AdamW step on the batch, updating ``state`` in place.  ``images`` are
    uint8 NHWC (numpy or torch), ``targets`` the five ``Targets`` fields or a
    ``ParamTargets`` (decoded in the step), as arrays; both are moved to the
    model's device.  The components stay on the device (reading them waits
    for the step).  With ``group``, the batch is this rank's rows of the
    global batch, the model's BatchNorms are set to the group, and the step
    is the global batch's (see the module docstring)."""
    if group is not None:
        set_process_group(model, group)
    loss_fn = make_loss_fn(model, flame_model, loss_cfg, group)

    def step(state: TrainState, images, targets):
        key = state.step
        with span("trainer.inputs", key):
            dev = next(model.parameters()).device
            x = images_to_device(images, dev)
            targets = (targets.to(dev) if isinstance(targets, ParamTargets)
                       else Targets(*targets).to(dev))
            lr = state.schedule(state.step)
            for param_group in state.optimizer.param_groups:
                param_group["lr"] = lr
            state.optimizer.zero_grad(set_to_none=True)
        with exact_float32():
            with span("trainer.forward_loss", key):
                total, components = loss_fn(x, targets)
            with span("trainer.backward", key):
                total.backward()
            with span("trainer.optimizer", key):
                grads = [p.grad for p in model.parameters() if p.grad is not None]
                all_reduce_flat_(grads, group)
                if train_cfg.grad_clip_norm:
                    state.grad_norm = clip_by_global_norm_(grads, train_cfg.grad_clip_norm)
                state.optimizer.step()
                state.step += 1
            if train_cfg.ema:
                with span("trainer.ema", key):
                    d = _ema_decay(state.step, train_cfg)
                    names, params = zip(*model.named_parameters())
                    ema = [state.ema[n] for n in names]
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, [p.detach() for p in params],
                                        alpha=float(np.float32(1) - np.float32(d)))
        return state, {k: v.detach() for k, v in components.items()}

    def train_step(state: TrainState, images, targets):
        # the step's locals (the loss and its graph) are freed inside the span
        with span("trainer.step", state.step):
            return step(state, images, targets)

    return train_step
