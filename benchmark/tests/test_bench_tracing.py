"""The readers of the port's spans and counters: each returns a finite
number after a traced burst of its cell's driver (on the CPU at tiny sizes,
as ``test_bench_faults.py`` runs them), and ``None`` on an empty registry or
on a port without the registry; ``train.device_ops`` reads the device trace
and may be ``None`` on the CPU."""

import math
import os

import pytest

from benchmark.harness import core
from benchmark.harness import trace as tracing
from benchmark.tests.test_bench_faults import context, driver
from head_detector_tpu_torch import profiling

READERS = {
    "stream.m.1024.b32": ["stream.feed_wait_ms", "stream.upload_ms", "stream.step_ms",
                          "stream.emit_wait_ms", "stream.letterbox_ms", "stream.nms_sweeps"],
    "detect.m.640.b8": ["detect.nms_sweeps", "detect.letterbox_ms", "detect.build_heads_ms",
                        "detect.pncc_ms"],
    "train.l.640.b32": ["train.device_ops", "train.optimizer_ms", "train.ema_ms"],
}
DEVICE_ONLY = {"train.device_ops"}
# a burst inside a shard, as in the cell: the tiny shard of two batches ends
# in a drain that takes no batch
OVERRIDES = {"stream.m.1024.b32": {"shard_images": 16, "burst_batches": 2}}


def reader(name):
    return core.load_module(os.path.join(core.BENCH_DIR, "metrics", name + ".py"),
                            "bench_metric_" + name.replace(".", "_"))


def test_bench_tracing_readers_are_declared_for_their_cells():
    spec = core.read_json(core.ROOT, "BENCHMARK.json")
    for cell, names in READERS.items():
        declared = [m["name"] for m in core.cell_metrics(spec, cell, "per_layer")]
        assert set(names) <= set(declared), cell


@pytest.mark.parametrize("cell", list(READERS))
def test_bench_tracing_readers_read_a_traced_burst(monkeypatch, cell):
    ctx = context(cell, **OVERRIDES.get(cell, {}))
    run_cell = driver(ctx).Cell(ctx)
    profiling.reset()
    try:
        profile = tracing.profile_burst(run_cell.burst)
    finally:
        if hasattr(run_cell, "close"):
            run_cell.close()
    run = core.Run(window=core.Window(metrics={}, attempted=0, failed=0), profile=profile,
                   peaks=None, work={}, counters={})
    for name in READERS[cell]:
        value = reader(name).read(run)
        if name in DEVICE_ONLY and ctx.device.type == "cpu":
            assert value is None or math.isfinite(value), name
        else:
            assert value is not None and math.isfinite(value) and value > 0, (name, value)

    monkeypatch.delattr(profiling, "snapshot")  # a port without the registry
    assert all(reader(name).read(run) is None for name in READERS[cell])
    monkeypatch.undo()
    profiling.reset()
    assert all(reader(name).read(run) is None for name in READERS[cell])
