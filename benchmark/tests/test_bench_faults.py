"""Runs of the harness with the timed path broken underneath come out not
correct; the same runs unbroken come out correct; the controls, put in the
program's place, come out not correct under each cell's limits.

On the CPU at tiny sizes, the cells computing in float32 (their sound runs
then agree with the reference to rounding), with each fault a cell can have
planted in the port: an answer altered where it is produced (a detection's
box, its vertices, a score), half of a batch left out, a step that returns
its state unchanged, or its EMA alone unchanged."""

import copy
import os

import pytest
import torch

from benchmark.harness import core

READINGS = core.load_module(os.path.join(core.BENCH_DIR, "controls", "readings.py"),
                            "bench_readings")
SEED = 3000000555

TINY = {
    "stream.m.1024.b32": {"scene_size": 256, "image_size": 256, "pool": 4, "batch": 4,
                          "warm_batches": 1, "burst_batches": 1, "check_images": 4,
                          "reference_batch": 4, "shard_images": 8, "dtype": "float32",
                          "verts_dtype": "float32"},
    "train.l.640.b32": {"image_size": 64, "batch": 2, "batches": 3, "burst_steps": 1},
    "detect.m.640.b8": {"scene_size": 256, "image_size": 256, "pool": 4, "batch": 4,
                        "warm_requests": 1, "burst_requests": 1, "check_requests": 2,
                        "period_ms": 10},
}


# the control's widest gaps need more heads than the tiny runs hold
CONTROL = {"detect.m.640.b8": {"pool": 32, "check_requests": 8}}


def context(cell, **overrides):
    torch.set_num_threads(4)
    args = core.parse_args(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5"])
    ctx = core.make_context(args, torch.device("cpu"),
                            traffic_overrides=dict(TINY[cell], **overrides))
    if "recipe" in ctx.config:
        ctx.config = copy.deepcopy(ctx.config)
        ctx.config["recipe"]["mixed_precision"] = "float32"
    return ctx


def run(cell):
    return core.run_cell(context(cell))


def driver(ctx):
    return core.load_module(os.path.join(core.BENCH_DIR, "drivers",
                                         ctx.traffic["driver"] + ".py"), "bench_driver")


def alter_detect(monkeypatch, fault: str):
    from head_detector_tpu_torch.detector import HeadDetector

    real = HeadDetector.predict_batch

    def broken(self, images, *args, **kwargs):
        results = real(self, images, *args, **kwargs)
        for i, r in enumerate(results):
            if fault == "half" and i % 2:
                r.heads = []
            for h in r.heads if fault != "half" else []:
                if fault == "box":
                    h.bbox = h.bbox._replace(x=h.bbox.x + 4, y=h.bbox.y + 4)
                else:
                    h.vertices_3d = h.vertices_3d + 3.0
        return results

    monkeypatch.setattr(HeadDetector, "predict_batch", broken)


def alter_stream(monkeypatch, fault: str):
    from head_detector_tpu_torch.pipeline import StreamingDetector

    real = StreamingDetector._emit

    def broken(self, outs, metas):
        for i, out in enumerate(real(self, outs, metas)):
            if fault == "half" and i % 2:
                out["valid"] = out["valid"] & False
            elif fault == "altered":
                out["scores"] = out["scores"] + 0.05
            elif fault == "verts":  # the head's vertices in another order
                out["vertices"] = {s: v.flip(0) for s, v in (out["vertices"] or {}).items()}
            yield out

    monkeypatch.setattr(StreamingDetector, "_emit", broken)


def alter_train(monkeypatch, fault: str):
    from head_detector_tpu_torch.train import trainer

    real = trainer.make_train_step

    def make(model, flame, loss_cfg, train_cfg, group=None):
        step = real(model, flame, loss_cfg, train_cfg, group)
        loss_fn = trainer.make_loss_fn(model, flame, loss_cfg)

        def unchanged(state, images, targets):
            with torch.no_grad():
                x = trainer.images_to_device(images, next(model.parameters()).device)
                _, comps = loss_fn(x, trainer.Targets(*targets))
            return state, comps

        def half(state, images, targets):
            rows = images.shape[0] // 2
            return step(state, images[:rows], tuple(t[:rows] for t in targets))

        return {"unchanged": unchanged, "half": half, "ema": step}[fault]

    monkeypatch.setattr(trainer, "make_train_step", make)
    if fault == "ema":  # the EMA alone left unchanged: a decay of 1
        monkeypatch.setattr(trainer, "_ema_decay", lambda step, cfg: 1.0)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_bench_faults_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell, fault", [
    ("detect.m.640.b8", "altered"), ("detect.m.640.b8", "half"), ("detect.m.640.b8", "box"),
    ("stream.m.1024.b32", "altered"), ("stream.m.1024.b32", "half"),
    ("stream.m.1024.b32", "verts"),
    ("train.l.640.b32", "unchanged"), ("train.l.640.b32", "half"), ("train.l.640.b32", "ema"),
])
def test_bench_faults_broken_run_is_not_correct(monkeypatch, cell, fault):
    if cell.startswith("detect"):
        alter_detect(monkeypatch, fault)
    elif cell.startswith("stream"):
        alter_stream(monkeypatch, fault)
    else:
        alter_train(monkeypatch, fault)
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_bench_faults_control_is_not_correct(cell):
    """The control that ``controls/readings.py`` reads the upper readings
    from, through the same limits and verdict as a run."""
    ctx = context(cell, **CONTROL.get(cell, {}))
    numbers = READINGS.judged(ctx, READINGS.control_numbers(ctx, driver(ctx), SEED))
    assert not numbers["correct"], numbers


@pytest.mark.parametrize("cell", ["detect.m.640.b8", "train.l.640.b32"])
def test_bench_faults_planted_in_the_reference_are_not_correct(cell):
    ctx = context(cell)
    readings = READINGS.fault_numbers(ctx, driver(ctx), SEED)
    assert readings
    for fault, numbers in readings.items():
        numbers = READINGS.judged(ctx, numbers)
        assert not numbers["correct"], (fault, numbers)
