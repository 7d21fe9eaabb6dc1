"""Device helpers of the plain reference.

The reference computes in whatever float32 mode its caller sets: TF32 off
for the reference itself (``benchmark.harness.compare.reference_precision``),
TF32 on for the detect cell's control.  So ``exact_float32`` here leaves the
process-wide flags alone, unlike the port's, which forces TF32 off.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    return torch.device(device)


def exact_float32():
    return contextlib.nullcontext()
