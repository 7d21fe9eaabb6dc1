"""Profiling hooks: a device trace, named regions, timing and FLOP counts.

Counterpart of ``head_detector_tpu/profiling.py``:

* :func:`trace` runs ``torch.profiler`` (CPU and, where there is a card,
  CUDA activity) around the block and writes a chrome trace
  (``trace.json``, which TensorBoard's profile plugin and ``chrome://
  tracing`` open) into ``log_dir``;
* :func:`annotate` is a named region inside a trace
  (``torch.profiler.record_function``);
* :func:`time_fn` runs a callable after a warm-up and returns the ms per call,
  synchronising the device around the timed calls;
* :func:`analytic_flops` counts the FLOPs of one call as the JAX package
  counts them (2 x MACs of matmuls and convolutions), and :func:`mfu` puts a
  rate against a peak.

The peaks are NVIDIA's H100 SXM data sheet figures (dense, no sparsity, at
the 700 W power limit), not readings of any card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core and float32 (non-tensor
# core) peaks.  What a card reaches depends on its power limit.
H100_BF16_PEAK_FLOPS = 989.4e12
H100_FP32_PEAK_FLOPS = 67e12


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; write ``log_dir/trace.json`` (chrome format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _conv_flops(x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                *args, out_shape=None, **kwargs) -> int:
    """2 x MACs of a convolution as the JAX package counts them: over the
    output positions, each taking ``prod(kernel) * Cin / groups`` MACs.  For a
    transposed convolution that is what JAX's lhs-dilated
    ``conv_general_dilated`` counts, stride^2 times its real MACs (4x for
    the neck's 2x2/s2 upsamples); ``torch.utils.flop_counter`` counts the
    real ones, over the input positions."""
    if not transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=False)
    n, spatial = out_shape[0], out_shape[2:]
    flops = 2 * n
    for d in list(w_shape) + list(spatial):  # [Cin, Cout / groups, kh, kw]
        flops *= d
    return flops


def analytic_flops(fn: Callable, *args) -> float:
    """FLOPs of one call of ``fn(*args)``: 2 x MACs of every matmul
    (``mm``, ``bmm``, ``addmm``, ...) and convolution it runs, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` with the convolutions
    counted as the JAX package's ``analytic_flops`` counts them (see
    :func:`_conv_flops`); elementwise and data-movement ops count 0.  Runs
    ``fn`` once, under ``torch.no_grad``."""
    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.convolution: _conv_flops,
                                              torch.ops.aten._convolution: _conv_flops})
    with torch.no_grad(), counter:
        fn(*args)
    return float(counter.get_total_flops())


flops_estimate = analytic_flops


def mfu(flops_per_item: float, items_per_sec: float,
        peak_flops: float = H100_BF16_PEAK_FLOPS) -> float:
    """Model FLOPs utilisation: achieved FLOP/s over ``peak_flops``."""
    if flops_per_item <= 0 or items_per_sec <= 0:
        return 0.0
    return flops_per_item * items_per_sec / peak_flops


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10) -> Tuple[float, Any]:
    """(ms per call, last output) of ``fn(*args)`` after ``warmup`` calls:
    the host clock around ``iters`` calls, the device synchronised before
    and after them."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _synchronize()
    return (time.perf_counter() - t0) / iters * 1000.0, out
