"""Readings that the limits of ``correct`` are set from, in one process.

    python3 benchmark/controls/readings.py --workload <cell> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...] [--fault-seeds <n> ...]

For each ``--seeds`` seed, the cell's set-up, a window of ``--seconds`` and
its check, as a run does: every number the driver compares, whether or not
``limits/<cell>.json`` holds it (the lower readings).  For each
``--control-seeds`` seed, the control put in the program's place at the
cell's own size (the upper readings): the reference one precision step
below the configuration's (``control_outputs`` of the stream and detect
drivers; the training reference with float8 convolutions).  For each
``--fault-seeds`` seed, the faults of ``fault_numbers`` planted in the
reference in the program's place.  One JSON line a reading on standard
output, with the verdict that ``limits/<cell>.json`` gives it
(``correct``, and the numbers ``failed``): each control and fault has to
come out not correct.  Needs the card; not run by the benchmark's own
runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import core  # noqa: E402
from benchmark.harness.scenes import Scenes, batches  # noqa: E402


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_batches(ctx, seed: int):
    t = ctx.traffic
    scenes = Scenes(seed, t["checked_steps"] * t["batch"], t["image_size"], t["max_heads"],
                    ctx.device)
    return batches(scenes, t["batch"], ctx.config["recipe"]["max_gt_boxes"])


def train_numbers(ctx, driver, checked, **planted) -> dict:
    """The training reference with ``planted`` (``fp8`` or ``rows``) in the
    program's place, against the reference."""
    want = driver.reference_readings(ctx, checked)
    got = driver.reference_readings(ctx, checked, **planted)
    out = driver.compare(got["losses"], got["first_grad"], got["change"], got["ema_change"],
                         got["bn_change"], want)
    out.pop("where")
    return out


def served_inputs(ctx, seed: int):
    """The pool of a stream or detect cell and the sample the control reads
    (stream: pool indices; detect: requests of pool indices), from ``seed``."""
    t = ctx.traffic
    rng = np.random.default_rng([seed, 5])
    pool = Scenes(seed, t["pool"], t["scene_size"], t["max_heads"], ctx.device).host_images()
    if t["driver"] == "stream":
        return pool, sorted(int(i) for i in rng.integers(0, len(pool), t["check_images"]))
    return pool, [[(int(k) * t["batch"] + i) % len(pool) for i in range(t["batch"])]
                  for k in rng.integers(0, len(pool), t["check_requests"])]


def control_numbers(ctx, driver, seed: int) -> dict:
    """The control in the program's place at the cell's size."""
    if ctx.traffic["driver"] == "train":
        return train_numbers(ctx, driver, train_batches(ctx, seed), fp8=True)
    pool, sample = served_inputs(ctx, seed)
    if ctx.traffic["driver"] == "stream":
        return driver.judge_stream(ctx, pool, sample,
                                   driver.control_outputs(ctx, pool, sample)).numbers()
    return driver.judge_detect(ctx, pool, driver.control_outputs(ctx, pool, sample)).numbers()


def fault_numbers(ctx, driver, seed: int) -> dict:
    """{fault: numbers} of the faults planted in the reference put in the
    program's place: a training step that leaves out half of its batch
    (``half``); a detection's box moved (``box``) and half of a request's
    results left empty (``half``).  None for the stream cell."""
    if ctx.traffic["driver"] == "train":
        return {"half": train_numbers(ctx, driver, train_batches(ctx, seed),
                                      rows=ctx.traffic["batch"] // 2)}
    if ctx.traffic["driver"] != "detect":
        return {}
    pool, sample = served_inputs(ctx, seed)
    return {fault: driver.judge_detect(ctx, pool, driver.control_outputs(
        ctx, pool, sample, fault=fault)).numbers() for fault in ("box", "half")}


def judged(ctx, numbers: dict) -> dict:
    """``numbers`` with the verdict that the cell's limits give them."""
    checks = core.held(numbers, ctx.limits)
    return dict(numbers, correct=core.verdict(checks),
                failed=[c.name for c in checks if not c.ok])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cell", default=None,
                    help="JSON {name, config, traffic} of a cell not in BENCHMARK.json yet")
    ap.add_argument("--traffic", default="{}", help="JSON overrides of the traffic (rehearsals)")
    ap.add_argument("--recipe", default="{}",
                    help="JSON overrides of the configuration's recipe, for the program "
                         "seeds (a look at the program in another precision)")
    args = ap.parse_args()
    device = torch.device(args.device)
    base = core.parse_args(["--workload", args.workload, "--seed", "0",
                            "--seconds", str(args.seconds)])
    ctx = core.make_context(base, device, traffic_overrides=json.loads(args.traffic),
                            cell=json.loads(args.cell) if args.cell else None)
    if json.loads(args.recipe):
        ctx.config = dict(ctx.config, recipe=dict(ctx.config["recipe"], **json.loads(args.recipe)))
    driver = core.load_module(os.path.join(ROOT, "benchmark", "drivers",
                                           ctx.traffic["driver"] + ".py"), "driver")
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        ("fault", args.fault_seeds)):
        for seed in seeds:
            ctx.seed = seed
            t0 = time.perf_counter()
            if kind == "program":
                cell = driver.Cell(ctx)
                window = cell.window(args.seconds)
                t1 = time.perf_counter()
                cell.judge()
                readings = {"": dict(cell.numbers, window=window.metrics,
                                     judge_s=time.perf_counter() - t1)}
                del cell
            elif kind == "control":
                readings = {"": control_numbers(ctx, driver, seed)}
            else:
                readings = fault_numbers(ctx, driver, seed)
            free()
            for fault, numbers in readings.items():
                numbers = judged(ctx, numbers)
                numbers["seconds"] = time.perf_counter() - t0
                print(json.dumps({"workload": args.workload, "kind": kind, "fault": fault,
                                  "seed": seed, **numbers}), flush=True)


if __name__ == "__main__":
    main()
