"""``stream.ring_wait_ms`` reads a finite value >= 0 after a traced burst of
the stream driver (on the CPU at tiny sizes, as ``test_bench_tracing.py``
runs the other readers), and ``None`` on an empty registry and on a port
without the registry."""

import math

from benchmark.harness import core
from benchmark.harness import trace as tracing
from benchmark.tests.test_bench_faults import context, driver
from benchmark.tests.test_bench_tracing import reader
from head_detector_tpu_torch import profiling

CELL, NAME = "stream.m.1024.b32", "stream.ring_wait_ms"
# a burst inside a shard, as in the cell: a shard of eight batches, so that
# the producer still takes slot sets while the burst's two batches are taken
# (the ring lets it run three sets ahead)
OVERRIDES = {"shard_images": 32, "burst_batches": 2}


def test_bench_ring_wait_is_declared_for_the_stream_cell():
    spec = core.read_json(core.ROOT, "BENCHMARK.json")
    metric = {m["name"]: m for m in core.cell_metrics(spec, CELL, "per_layer")}[NAME]
    assert metric["moves"] == "stream_images_per_s" and metric["better"] == "lower"


def test_bench_ring_wait_reads_a_traced_burst(monkeypatch):
    ctx = context(CELL, **OVERRIDES)
    run_cell = driver(ctx).Cell(ctx)
    profiling.reset()
    try:
        profile = tracing.profile_burst(run_cell.burst)
    finally:
        run_cell.close()
    run = core.Run(window=core.Window(metrics={}, attempted=0, failed=0), profile=profile,
                   peaks=None, work={}, counters={})
    value = reader(NAME).read(run)
    assert value is not None and math.isfinite(value) and value >= 0, value

    monkeypatch.delattr(profiling, "snapshot")  # a port without the registry
    assert reader(NAME).read(run) is None
    monkeypatch.undo()
    profiling.reset()
    assert reader(NAME).read(run) is None
