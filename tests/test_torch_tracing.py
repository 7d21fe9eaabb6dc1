"""The port's tracing registry (``profiling.py``) on the CPU.

Without a profiler session ``span`` is the shared no-op and nothing is
recorded; under ``torch.profiler.profile`` each span's record starts and
ends within 0.2 ms of its ``record_function`` event (the registry stamps
the profiler's own clock), counters count from any thread, and the buffer
keeps its newest records.  The instrumented paths at the TINY arch
(tests/test_model.py): ``StreamingDetector.run`` records its ``pipeline.*``
spans once a batch on the consumer's thread alone, none open across a
``yield``, one ``nms.calls`` a batch and one ``pipeline.letterbox_images``
an image; ``predict_batch`` + ``get_pncc`` record each ``detector.*`` span
once a call and ``pncc.render`` once an image; a train step records each
``trainer.*`` span once.  ``trace()`` resets the registry.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from head_detector_tpu_torch import profiling
from head_detector_tpu_torch.detector import HeadDetector
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models import build_model, init_model, presets
from head_detector_tpu_torch.pipeline import StreamingDetector
from head_detector_tpu_torch.train import trainer as tt
from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset, collate_samples
from head_detector_tpu_torch.train.loss import LossConfig
from test_model import TINY
from test_torch_options import port_arch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZE = 64
PIPELINE = ("pipeline.upload", "pipeline.step", "pipeline.emit", "pipeline.emit_wait")
DETECTOR = ("detector.letterbox", "detector.forward", "detector.nms", "detector.decode",
            "detector.to_host", "detector.build_heads")
TRAINER = ("trainer.step", "trainer.inputs", "trainer.forward_loss", "trainer.backward",
           "trainer.optimizer", "trainer.ema")


def session():
    return profile(activities=[ProfilerActivity.CPU])


def spans(name):
    return [r for r in profiling.snapshot()["records"] if r.name == name]


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def test_tracing_records_nothing_without_a_session():
    assert profiling.span("a") is profiling.NO_SPAN is profiling.span("b", key=3)
    with profiling.span("a"):
        profiling.count("c", 5)
    assert profiling.snapshot() == {"records": [], "spans": {}, "counters": {}}


def test_tracing_records_on_the_profilers_clock(monkeypatch):
    with torch.profiler.record_function("warm"):  # the op's first lookup
        pass
    def worker():
        profiling.count("worker.items", 2)

    with session() as prof:
        with profiling.span("outer", key=7):
            for i in range(3):
                with profiling.span("inner", key=i):
                    torch.ones(256).sum()
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")]
    records = profiling.snapshot()["records"]
    assert [(r.name, r.key) for r in records] == [("inner", 0), ("inner", 1), ("inner", 2),
                                                  ("outer", 7)]
    assert sorted(e.name() for e in events) == sorted(r.name for r in records)
    for r in records:
        e = min((e for e in events if e.name() == r.name),
                key=lambda e: abs(e.start_ns() - r.start_ns))
        assert abs(e.start_ns() - r.start_ns) < 200_000
        assert abs(e.start_ns() + e.duration_ns() - r.end_ns) < 200_000
        assert r.thread == threading.get_ident()
        assert r.parent == (None if r.name == "outer" else "outer")
    assert profiling.snapshot()["counters"] == {"worker.items": 2}
    totals = profiling.snapshot()["spans"]
    assert totals["inner"]["count"] == 3 and totals["outer"]["count"] == 1
    assert 0 < totals["inner"]["seconds"] < totals["outer"]["seconds"]

    profiling.reset()
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with session():
        for i in range(5):
            with profiling.span("many", key=i):
                pass
    snap = profiling.snapshot()
    assert [r.key for r in snap["records"]] == [2, 3, 4]
    assert snap["spans"]["many"]["count"] == 5
    assert snap["counters"] == {profiling.DROPPED: 2}


def test_tracing_streaming_run_records_each_batch_on_its_thread():
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (rng.randint(40, 90), rng.randint(40, 90), 3), np.uint8)
              for _ in range(10)]
    stream = StreamingDetector(model_name=port_arch(TINY), image_size=SIZE, batch_size=4,
                               confidence_threshold=1e-6, post_nms_max=10,
                               dtype=torch.float32, device="cpu", workers=2)
    batches = 3
    out = []
    with session() as prof:
        with torch.profiler.record_function("consumer"):
            pass
        for item in stream.run(images):
            assert profiling._OPEN.names == []  # no span open across a yield
            out.append(item)
    assert len(out) == len(images)
    snap = profiling.snapshot()
    me = threading.get_ident()
    assert all(r.thread == me for r in snap["records"])
    assert [r.key for r in spans("pipeline.start")] == [None]
    # the last wait is for the end of the input
    assert [r.key for r in spans("pipeline.feed_wait")] == list(range(batches + 1))
    for name in PIPELINE:
        assert sorted(r.key for r in spans(name)) == list(range(batches)), name
    assert {r.parent for r in spans("pipeline.emit_wait")} == {"pipeline.emit"}
    assert snap["counters"]["nms.calls"] == batches
    assert snap["counters"]["nms.sweeps"] >= batches
    assert snap["counters"]["pipeline.letterbox_images"] == len(images)
    assert snap["counters"]["pipeline.letterbox_ns"] > 0
    events = list(prof.profiler.kineto_results.events())
    consumer = {e.start_thread_id() for e in events if e.name() == "consumer"}
    threads = {e.start_thread_id() for e in events if e.name().startswith("pipeline.")}
    assert len(consumer) == 1 and threads == consumer


def test_tracing_predict_batch_and_pncc_record_each_call(monkeypatch):
    monkeypatch.setitem(presets.PRESETS, "tiny", port_arch(TINY))
    det = HeadDetector(model="tiny", image_size=SIZE, device="cpu", post_nms_max=4)
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 255, (SIZE, SIZE, 3), np.uint8) for _ in range(3)]
    with session():
        results = det.predict_batch(images, confidence_threshold=1e-6)
        maps = [r.get_pncc() for r in results]
    assert sum(len(r.heads) for r in results) > 0 and len(maps) == 3
    totals = profiling.snapshot()["spans"]
    for name in DETECTOR:
        assert totals[name]["count"] == 1, name
    assert totals["pncc.render"]["count"] == len(images)
    assert profiling.snapshot()["counters"]["nms.calls"] == 1


def test_tracing_train_step_records_each_part():
    net = build_model(port_arch(TINY), deploy=False)
    init_model(net, torch.Generator().manual_seed(0), (SIZE, SIZE))
    ds = SyntheticHeadsDataset(image_size=SIZE, length=2, max_heads=3, seed=3, device="cpu")
    images, targets = collate_samples([ds[0], ds[1]], 4)
    cfg = tt.TrainConfig(lr_warmup_steps=0, initial_lr=1e-2, max_steps=10)
    state = tt.TrainState(net, cfg)
    step = tt.make_train_step(net, FlameModel.from_assets(device="cpu"), LossConfig(), cfg)
    with session():
        for _ in range(2):
            step(state, images, targets)
    for name in TRAINER:
        assert [r.key for r in spans(name)] == [0, 1], name
    assert {r.parent for name in TRAINER[1:] for r in spans(name)} == {"trainer.step"}


def test_tracing_trace_resets_the_registry(tmp_path):
    with session():
        profiling.count("before")
        with profiling.span("before"):
            pass
    assert profiling.snapshot()["counters"] == {"before": 1}
    with profiling.trace(str(tmp_path)):
        assert profiling.snapshot() == {"records": [], "spans": {}, "counters": {}}
        with profiling.span("inside", key=1):
            profiling.count("inside", 3)
    snap = profiling.snapshot()
    assert [(r.name, r.key) for r in snap["records"]] == [("inside", 1)]
    assert snap["counters"] == {"inside": 3}
