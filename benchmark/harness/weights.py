"""Weights the benchmark hands to both sides.

``initial_state``: a training-layout initialisation drawn from the seed on
the device in one call (a flat normal draw, cut into the kernels and scaled
by their fan-in), keyed by the reference network's state-dict names, which
the port's training layout shares.  ``checkpoint_state``: the repository's
checkpoint read into the same layout.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import checkpoint
from benchmark.reference.models.yolo_heads import YoloHeads

CLS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def _fan_in(name: str, shape) -> int:
    if name.endswith("upsample.weight"):  # ConvTranspose2d [in, out, kh, kw]
        return shape[0] * shape[2] * shape[3]
    return shape[1] * shape[2] * shape[3]  # [out, in / groups, kh, kw]


def initial_state(arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """Training-layout state dict drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    with torch.device("meta"):
        shapes = {k: (v.shape, v.dtype) for k, v in YoloHeads(arch, deploy=False)
                  .state_dict().items()}
    kernels = [k for k, (shape, _) in shapes.items() if len(shape) == 4]
    total = sum(shapes[k][0].numel() for k in kernels)
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for name, (shape, dtype) in shapes.items():
        if name in kernels:
            n = shape.numel()
            state[name] = (flat[at:at + n].view(shape) / math.sqrt(_fan_in(name, shape)))
            at += n
        elif name.endswith("num_batches_tracked"):
            state[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif name.endswith(("running_var", "alpha")) or (
                name.endswith("weight") and len(shape) == 1):
            state[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name.endswith("cls_pred.bias"):
            state[name] = torch.full(shape, CLS_PRIOR_BIAS, dtype=dtype, device=device)
        else:  # biases, running means
            state[name] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def checkpoint_state(path: str, device) -> Dict[str, torch.Tensor]:
    """The flax msgpack checkpoint at ``path`` in the training layout."""
    variables = checkpoint._load_msgpack(path)
    state, used = checkpoint.train_state_dict_from_flax(variables)
    if used != checkpoint.count_leaves(variables):
        raise ValueError(f"{path}: read {used} of {checkpoint.count_leaves(variables)} leaves")
    return {k: v.to(device) for k, v in state.items()}
