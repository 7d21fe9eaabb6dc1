"""The traced window: ``torch.profiler`` over a short burst of the cell's own
work, reduced to device time by kernel name, the device's busy seconds, the
longest idle gaps and what the host was doing in each.

Busy time is the union of the intervals in which any device operation
(kernel, copy, set) ran, so work that overlaps on two streams counts once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Profile:
    window_s: float  # host clock over the burst, synchronised at both ends
    busy_s: float  # union of device operation intervals
    kernels: Dict[str, Tuple[float, int]]  # name -> (device seconds, count)
    idle_gaps: List[Tuple[str, float]]  # (host activity, seconds), longest first

    def kernel_seconds(self, *fragments: str) -> float:
        """Device seconds of the operations whose name holds any fragment."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(f in name for f in fragments))

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return [[name, s] for name, (s, _) in ranked[:top]]


def _is_device(event) -> bool:
    """A kernel, copy or set on the card; not a host span mirrored there."""
    return str(event.device_type()).endswith("CUDA") and not event.is_user_annotation()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def _host_activity(host: List[Tuple[int, int, str]], t: int) -> str:
    """The innermost host span (latest start) that holds time ``t``."""
    best: Optional[Tuple[int, int, str]] = None
    for start, end, name in host:
        if start <= t <= end and (best is None or start > best[0]):
            best = (start, end, name)
    return best[2] if best else "host: no span"


def reduce_events(events, window_start_ns: int, window_end_ns: int,
                  top_gaps: int = 10) -> Tuple[float, Dict[str, Tuple[float, int]],
                                                 List[Tuple[str, float]]]:
    """(busy seconds, kernels by name, longest idle gaps) of profiler events
    inside [window_start_ns, window_end_ns]."""
    device, host = [], []
    kernels: Dict[str, List[float]] = {}
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if end <= window_start_ns or start >= window_end_ns or e.duration_ns() <= 0:
            continue
        if _is_device(e):
            device.append((max(start, window_start_ns), min(end, window_end_ns)))
            acc = kernels.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e9
            acc[1] += 1
        elif not str(e.device_type()).endswith("CUDA"):
            host.append((start, end, e.name()))
    busy = _union(device)
    busy_s = sum(end - start for start, end in busy) / 1e9
    gaps = []
    edges = [window_start_ns] + [t for iv in busy for t in iv] + [window_end_ns]
    for i in range(0, len(edges), 2):
        start, end = edges[i], edges[i + 1]
        if end > start:
            gaps.append((end - start, start))
    gaps.sort(reverse=True)
    idle = [[_host_activity(host, start + length // 2), length / 1e9]
            for length, start in gaps[:top_gaps]]
    return busy_s, {k: (v[0], int(v[1])) for k, v in kernels.items()}, idle


def profile_burst(burst: Callable[[], None]) -> Profile:
    """Run ``burst()`` under the profiler, synchronised at both ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            burst()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    marks = [e for e in events if e.name() == "bench.window"]
    start = marks[0].start_ns() if marks else min(e.start_ns() for e in events)
    end = start + int(window_s * 1e9)
    busy_s, kernels, idle = reduce_events(events, start, end)
    return Profile(window_s=window_s, busy_s=busy_s, kernels=kernels, idle_gaps=idle)
