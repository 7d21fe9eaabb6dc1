"""What the benchmark loads and reads: never JAX or the JAX package, never
the JAX package's benchmark files; the reference nothing of the port."""

import json
import os
import re
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY = {
    "stream.m.1024.b32": {"scene_size": 64, "image_size": 64, "pool": 4, "batch": 2,
                          "warm_batches": 1, "burst_batches": 1, "check_images": 2,
                          "reference_batch": 2, "shard_images": 4},
    "train.l.640.b32": {"image_size": 64, "batch": 2, "batches": 3, "burst_steps": 1},
    "detect.m.640.b8": {"scene_size": 64, "image_size": 64, "pool": 4, "batch": 2,
                        "warm_requests": 1, "burst_requests": 1, "check_requests": 2,
                        "period_ms": 10},
}

SETUP = r"""
import json, os, sys
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0])) if event == "open" else None)
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark.harness import core
args = core.parse_args(["--workload", {cell!r}, "--seed", "3000000777", "--seconds", "0.2"])
ctx = core.make_context(args, torch.device("cpu"), traffic_overrides={tiny!r})
driver = core.load_module(os.path.join({root!r}, "benchmark", "drivers",
                                       ctx.traffic["driver"] + ".py"), "driver")
cell = driver.Cell(ctx)
cell.window(0.2)
print(json.dumps({{"modules": sorted(sys.modules), "opened": opened}}))
"""

REFERENCE = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark.harness.scenes import Scenes, batches
from benchmark.harness.weights import initial_state
from benchmark.reference.flame import FlameModel
from benchmark.reference.pipeline import arch_from_dict, build_model, detect
from benchmark.reference.train_step import TrainStep, loss_config
from benchmark.reference.assets_io import get_indices
cfg = json.load(open({config!r}))
arch = arch_from_dict(cfg["arch"])
model = build_model(arch, initial_state(arch, 5, "cpu"), "cpu", train=True)
flame = FlameModel.from_assets(device="cpu")
data = batches(Scenes(5, 2, 64, 2, "cpu"), 2, 30)
TrainStep(model, flame, cfg["recipe"], loss_config(cfg["recipe"], np.asarray(get_indices()["head"])))(*data[0])
detect(model.eval(), flame, data[0][0].float() / 255)
print(json.dumps(sorted(sys.modules)))
"""


def top_names(modules):
    return {m.split(".")[0] for m in modules}


def run(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_bench_guard_cell_setup_loads_no_jax(cell):
    got = run(SETUP.format(root=ROOT, cell=cell, tiny=TINY[cell]))
    names = top_names(got["modules"])
    assert not names & {"jax", "jaxlib", "flax", "head_detector_tpu"}, names
    assert "head_detector_tpu_torch" in names
    read = [p for p in got["opened"] if os.path.basename(p) == "bench.py"
            or (os.path.basename(p).startswith("BENCH_") and p.endswith(".json"))]
    assert not read, read


def test_bench_guard_reference_loads_nothing_of_the_port():
    got = top_names(run(REFERENCE.format(
        root=ROOT, config=os.path.join(BENCH, "configs", "yolo_heads_l.json"))))
    assert not got & {"jax", "jaxlib", "flax", "head_detector_tpu", "head_detector_tpu_torch"}


def test_bench_guard_sources_name_no_jax_benchmark():
    """No file of the benchmark names JAX's modules or the JAX package's
    benchmark files in an import or a path."""
    bad = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|head_detector_tpu)\b"
                     r"|\bbench\.py|(?:BENCH|MULTICHIP)_\w*\.json", re.MULTILINE)
    for folder, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py") and "tests" not in folder.split(os.sep):
                with open(os.path.join(folder, name)) as f:
                    found = bad.findall(f.read())
                assert not found, (name, found)
