"""A new configuration, cell and per-layer metric are new files only: in a
copy of the benchmark, the harness finds and runs them with no edit to a
file that is there (``BENCHMARK.json`` gains entries)."""

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

METRIC = '''"""Steps in the window (a test's metric)."""


def read(run):
    return float(run.window.facts["steps"])
'''

RUN = r"""
import json, sys
sys.path.insert(0, {copy!r})
sys.path.insert(1, {root!r})
import torch
from benchmark.harness import core
assert core.ROOT == {copy!r}, core.ROOT
args = core.parse_args(["--workload", "train.s.64.b2", "--seed", "3000000999",
                        "--seconds", "0.5", "--trace", "1"])
result = core.run_cell(core.make_context(args, torch.device("cpu")))
result.pop("_check_lines")
print(json.dumps(result))
"""


def snapshot(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


def test_bench_additions_found_by_name(tmp_path):
    copy = str(tmp_path / "checkout")
    shutil.copytree(BENCH, os.path.join(copy, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    # the FLAME asset files the reference reads by path, as in a checkout
    os.symlink(os.path.join(ROOT, "head_detector_tpu"), os.path.join(copy, "head_detector_tpu"))
    before = snapshot(os.path.join(copy, "benchmark"))

    bench = os.path.join(copy, "benchmark")
    from head_detector_tpu_torch.models.presets import YOLO_HEADS_S
    from benchmark.reference.pipeline import arch_to_dict

    with open(os.path.join(bench, "configs", "yolo_heads_l.json")) as f:
        config = json.load(f)
    config.update(name="yolo_heads_s", arch=arch_to_dict(YOLO_HEADS_S))
    files = {
        "configs/yolo_heads_s.json": json.dumps(config),
        "traffic/train_device_fed_64_b2.json": json.dumps({
            "driver": "train", "why": "a test's traffic", "image_size": 64, "batch": 2,
            "batches": 3, "max_heads": 2, "checked_steps": 3, "burst_steps": 1}),
        "limits/train.s.64.b2.json": json.dumps({"loss": 1.0}),
        "metrics/train_s.steps.py": METRIC,
    }
    for rel, text in files.items():
        with open(os.path.join(bench, rel), "w") as f:
            f.write(text)
    with open(os.path.join(copy, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "yolo_heads_s", "source": "a test",
                            "file": "benchmark/configs/yolo_heads_s.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "train.s.64.b2", "config": "yolo_heads_s",
                              "traffic": "train_device_fed_64_b2", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "train_s.steps", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "Device",
                              "moves": "train_images_per_s", "workloads": ["train.s.64.b2"]})
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    out = subprocess.run([sys.executable, "-c", RUN.format(copy=copy, root=ROOT)],
                         capture_output=True, text=True, timeout=900, cwd=copy,
                         stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["train_s.steps"]["value"] >= 1
    assert list(result["checks"]) == ["loss"]
    after = snapshot(bench)
    assert {k: v for k, v in after.items() if k in before} == before
