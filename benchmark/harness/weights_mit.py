"""The initial state the benchmark hands to both sides of a SegFormer cell.

``initial_state``: a training-layout initialisation of ``SegFormerYoloHeads``
drawn from the seed on the device in one call, as ``weights.initial_state``
draws YoloHeads's: a flat normal draw cut into every convolution kernel and
``Linear`` weight, each scaled by its fan-in (a kernel's taps times its input
channels a group, a ``Linear``'s input features); unit LayerNorm and
BatchNorm scales and running variances, zero biases and running means, the
classifier's bias at the focal prior, QARepVGG ``alpha`` 1.  Keyed by the
reference network's state-dict names, which the port's training layout
shares.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness.weights import CLS_PRIOR_BIAS, _fan_in
from benchmark.reference.models.segformer import MiTCfg, SegFormerYoloHeads


def initial_state(mit: MiTCfg, arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """Training-layout state dict of MiT ``mit`` with the heads of ``arch``,
    drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    with torch.device("meta"):
        shapes = {k: (v.shape, v.dtype) for k, v in SegFormerYoloHeads(mit, arch)
                  .state_dict().items()}
    drawn = {k for k, (shape, _) in shapes.items()
             if len(shape) == 4 or (len(shape) == 2 and k.endswith("weight"))}
    total = sum(shapes[k][0].numel() for k in drawn)
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for name, (shape, dtype) in shapes.items():
        if name in drawn:
            n = shape.numel()
            fan_in = _fan_in(name, shape) if len(shape) == 4 else shape[1]
            state[name] = flat[at:at + n].view(shape) / math.sqrt(fan_in)
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
