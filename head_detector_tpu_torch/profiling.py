"""Profiling hooks: a device trace, the port's spans and counters, timing
and FLOP counts.

Counterpart of ``head_detector_tpu/profiling.py``:

* :func:`trace` runs ``torch.profiler`` (CPU and, where there is a card,
  CUDA activity) around the block and writes a chrome trace
  (``trace.json``, which TensorBoard's profile plugin and ``chrome://
  tracing`` open) into ``log_dir``; the registry below is reset on entry,
  so after the block it holds that session's spans and counters;
* :func:`span` is a named region of the thread that drives the card: a
  ``torch.profiler.record_function`` in the device trace, and a record
  (name, key, start, end, thread, enclosing span) in an in-memory registry
  stamped on the wall clock (``time.time_ns``), the clock of the
  profiler's events; :func:`count` adds to a named counter from any
  thread; :func:`snapshot` reads the registry and :func:`reset` empties it.
  Spans and counts are recorded only while a profiler session is active in
  the process (``torch.autograd.profiler._is_profiler_enabled``, which
  every thread sees); otherwise :func:`span` returns the shared no-op
  ``NO_SPAN`` and :func:`count` returns at once; :func:`recording` says
  whether one is.  The registry keeps the newest ``MAX_RECORDS`` records
  (the counter ``profiling.dropped_records`` counts the rest) and exact
  per-name totals;
* the spans and counters the port records, each set documented in its
  module: ``pipeline.*`` (``pipeline.py``), ``detector.*``
  (``detector.py``), ``pncc.render`` (``detection_result.py``), the counters
  ``nms.calls`` and ``nms.sweeps`` (``ops/nms.py``), ``trainer.*``
  (``train/trainer.py``), and ``mit.attention`` and ``mit.ffn`` around each
  MiT block's attention and Mix-FFN forward, with the counter
  ``mit.attention_pairs`` of the query-key pairs scored
  (``models/segformer.py``);
* :func:`time_fn` runs a callable after a warm-up and returns the ms per call,
  synchronising the device around the timed calls;
* :func:`analytic_flops` counts the FLOPs of one call as the JAX package
  counts them (2 x MACs of matmuls and convolutions), and :func:`mfu` puts a
  rate against a peak.

The peaks are NVIDIA's H100 SXM data sheet figures (dense, no sparsity, at
the 700 W power limit), not readings of any card.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core and float32 (non-tensor
# core) peaks.  What a card reaches depends on its power limit.
H100_BF16_PEAK_FLOPS = 989.4e12
H100_FP32_PEAK_FLOPS = 67e12


MAX_RECORDS = 100_000
DROPPED = "profiling.dropped_records"


class SpanRecord(NamedTuple):
    name: str
    key: Optional[int]  # the batch, request or step index, where the caller has one
    start_ns: int  # wall clock (``time.time_ns``), the profiler events' clock
    end_ns: int
    thread: int  # ``threading.get_ident()`` of the thread that ran the span
    parent: Optional[str]  # the enclosing span's name on that thread


_LOCK = threading.Lock()
_RECORDS: Deque[SpanRecord] = collections.deque()
_TOTALS: Dict[str, List[int]] = {}  # name -> [count, nanoseconds]
_COUNTERS: Dict[str, float] = {}
_OPEN = threading.local()  # .names: the open spans of this thread, innermost last


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "key", "parent", "start_ns", "_region")

    def __init__(self, name: str, key: Optional[int]):
        self.name, self.key = name, key

    def __enter__(self):
        names = _OPEN.__dict__.setdefault("names", [])
        self.parent = names[-1] if names else None
        names.append(self.name)
        self._region = torch.profiler.record_function(self.name)
        self._region.__enter__()
        # after the enter: a session's first event on a thread sets up its
        # buffers before it stamps its start (0.3 ms on an H100 host)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._region.__exit__(*exc)
        end_ns = time.time_ns()
        _OPEN.names.pop()
        record = SpanRecord(self.name, self.key, self.start_ns, end_ns,
                            threading.get_ident(), self.parent)
        with _LOCK:
            if len(_RECORDS) >= MAX_RECORDS:
                _RECORDS.popleft()
                _COUNTERS[DROPPED] = _COUNTERS.get(DROPPED, 0) + 1
            _RECORDS.append(record)
            total = _TOTALS.setdefault(self.name, [0, 0])
            total[0] += 1
            total[1] += end_ns - self.start_ns
        return False


def span(name: str, key: Optional[int] = None):
    """A context manager: the named region, recorded while a profiler
    session is active (see the module docstring); ``NO_SPAN`` otherwise.
    Open it only on the thread that drives the card, and never across a
    ``yield``."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, key)


def recording() -> bool:
    """Whether a profiler session is active, so that spans and counts are
    recorded (for a count whose measure begins before the call)."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session is active."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def snapshot() -> dict:
    """The registry: ``records`` (the kept ``SpanRecord``s, oldest first),
    ``spans`` (name -> ``{"count", "seconds"}`` over every record, dropped
    ones included) and ``counters`` (name -> value)."""
    with _LOCK:
        return {"records": list(_RECORDS),
                "spans": {name: {"count": c, "seconds": ns / 1e9}
                          for name, (c, ns) in _TOTALS.items()},
                "counters": dict(_COUNTERS)}


def reset() -> None:
    """Empty the registry."""
    with _LOCK:
        _RECORDS.clear()
        _TOTALS.clear()
        _COUNTERS.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; write ``log_dir/trace.json`` (chrome format).  The
    registry is reset on entry and holds the block's spans and counters."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


def flops_estimate(fn: Callable, *args) -> float:
    """FLOPs of one call of ``fn(*args)``: the counterpart of the JAX
    package's ``flops_estimate``, which asks XLA's cost analysis of a jitted
    function and falls back to its jaxpr count.  The port has no compiler's
    estimate to ask, so this is :func:`analytic_flops`, the counterpart of
    that jaxpr count (0.0 where ``fn`` runs no matmul or convolution)."""
    return analytic_flops(fn, *args)


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
