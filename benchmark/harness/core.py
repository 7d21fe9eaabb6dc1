"""One run of one cell: set-up, the measured window, the traced burst, the
per-layer readers, the import guard and the check of the outputs; then the
result as one JSON line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic in ``traffic/<traffic>.json`` (which names the driver,
``drivers/<driver>.py``), its limits in ``limits/<cell>.json`` and each
per-layer metric in ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "head_detector_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: start time in clock
    ticks after boot against the uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Check:
    """One number compared: correct when ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """Each number that ``limits`` names, against its limit."""
    return [Check(name, float(numbers[name]), float(limits[name])) for name in limits]


def verdict(checks: List[Check]) -> bool:
    """``correct``: some number was compared and every one is within its limit."""
    return bool(checks) and all(c.ok for c in checks)


@dataclasses.dataclass
class Window:
    """What a driver's measured window gives back."""

    metrics: Dict[str, float]  # end-to-end metrics of the window
    attempted: int
    failed: int
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)  # for the readers


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its files, the run's arguments."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    root: str = ROOT

    def path(self, relative: str) -> str:
        return os.path.join(self.root, relative)


@dataclasses.dataclass
class Run:
    """What a per-layer reader gets."""

    window: Window
    profile: Any  # trace.Profile or None
    peaks: Optional[dict]  # the card's row of harness/peaks.json, or None
    work: Dict[str, float]  # the driver's counts from shapes (flops, bytes)
    counters: Dict[str, float]


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]


def card_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def make_context(args, device, root: str = ROOT, traffic_overrides: Optional[dict] = None,
                 cell: Optional[dict] = None) -> Context:
    """The context of ``args.workload``, found in ``BENCHMARK.json``, or of
    ``cell`` (name, config, traffic) where a cell is not there yet; such a
    cell without a limits file is held to no limit."""
    bench = os.path.join(root, "benchmark")
    cell = cell or find_cell(read_json(root, "BENCHMARK.json"), args.workload)
    traffic = read_json(bench, "traffic", cell["traffic"] + ".json")
    traffic.update(traffic_overrides or {})
    limits = os.path.join(bench, "limits", cell["name"] + ".json")
    return Context(cell=cell, config=read_json(bench, "configs", cell["config"] + ".json"),
                   traffic=traffic, limits=read_json(limits) if os.path.exists(limits) else {},
                   seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device=device, root=root)


def run_cell(ctx: Context) -> dict:
    """Set up, measure, trace, read and check one cell -> the result dict."""
    import torch

    from benchmark.harness import trace as tracing

    bench = os.path.join(ctx.root, "benchmark")
    spec = read_json(ctx.root, "BENCHMARK.json")
    driver = load_module(os.path.join(bench, "drivers", ctx.traffic["driver"] + ".py"),
                         "bench_driver_" + ctx.traffic["driver"])
    on_card = ctx.device.type == "cuda"
    cell = driver.Cell(ctx)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the window's own peak
    setup_s = process_age_s()
    window = cell.window(ctx.seconds)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    window.metrics["setup_s"] = setup_s

    result: Dict[str, Any] = {"correct": False, "attempted": window.attempted,
                              "failed": window.failed, "metrics": {}, "device": {}}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    if ctx.trace:
        profile = tracing.profile_burst(cell.burst)
        peaks = read_json(bench, "harness", "peaks.json").get(device["kind"])
        run = Run(window=window, profile=profile, peaks=peaks, work=cell.work(),
                  counters=cell.counters())
        for m in cell_metrics(spec, ctx.cell["name"], "per_layer"):
            reader = load_module(os.path.join(bench, "metrics", m["name"] + ".py"),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        device["busy_s"] = profile.busy_s
        device["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": profile.device_ops(10),
                               "idle_gaps": profile.idle_gaps[:10]}
    else:
        for m in cell_metrics(spec, ctx.cell["name"], "end_to_end"):
            result["metrics"][m["name"]] = {"value": float(window.metrics[m["name"]]),
                                            "unit": m["unit"]}
    if on_card:
        device["power_limit"] = card_power_limit()
    result["device"] = device

    checks: List[Check] = cell.judge()
    result["correct"] = verdict(checks)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    result["_check_lines"] = [f"check {c.name} = {c.value!r} (limit {c.limit!r})"
                              f"{'' if c.ok else '  FAILED'}" for c in checks]
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: this benchmark measures the port on an NVIDIA card",
              file=sys.stderr)
        return 3
    spec = read_json(ROOT, "BENCHMARK.json")
    chips = find_cell(spec, args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 3
    ctx = make_context(args, torch.device("cuda", 0))
    result = run_cell(ctx)
    loaded = forbidden_modules()  # after the window and the check
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    for line in result.pop("_check_lines"):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
