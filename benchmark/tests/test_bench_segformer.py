"""The SegFormer cell ``train.segformer.640.b8`` on the CPU at a tiny size:
its sound run is correct, runs with the timed path broken underneath and the
control and faults that its limits are set from are not; its work count, its
reference's imports and its per-layer readers.

The tiny size: MiT-B0's widths at depth 1 a stage with the configuration's L
heads, 64 px scenes in batches of 2, float32 (so a sound run agrees with the
reference to rounding)."""

import copy
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import core, work, work_mit
from benchmark.harness import trace as tracing
from benchmark.reference.models import segformer as rs
from benchmark.reference.models.presets import get_arch
from benchmark.tests.test_bench_faults import alter_train
from head_detector_tpu_torch import profiling

CELL = "train.segformer.640.b8"
SEED = 3000000555
TINY = {"image_size": 64, "batch": 2, "batches": 3, "burst_steps": 1}
TINY_MIT = {"embed_dims": [32, 64, 160, 256], "depths": [1, 1, 1, 1]}
READINGS = core.load_module(os.path.join(core.BENCH_DIR, "controls", "readings_mit.py"),
                            "bench_readings_mit")
METRICS = ["segformer.mfu", "segformer.idle_share", "segformer.peak_mem_gib",
           "segformer.attention_share", "segformer.attention_ms", "segformer.ffn_ms"]
SPANS = ["segformer.attention_ms", "segformer.ffn_ms"]


def context():
    torch.set_num_threads(4)
    args = core.parse_args(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5"])
    ctx = core.make_context(args, torch.device("cpu"), traffic_overrides=TINY)
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["recipe"]["mixed_precision"] = "float32"
    ctx.config["arch"]["mit"].update(TINY_MIT)
    return ctx


def driver(ctx):
    return core.load_module(os.path.join(core.BENCH_DIR, "drivers",
                                         ctx.traffic["driver"] + ".py"), "bench_driver_mit")


def test_bench_segformer_sound_run_is_correct():
    result = core.run_cell(context())
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "ema"])
def test_bench_segformer_broken_run_is_not_correct(monkeypatch, fault):
    alter_train(monkeypatch, fault)
    result = core.run_cell(context())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("part", ["stage4_block0.attn", "stage1_block0.ffn"])
def test_bench_segformer_control_rounds_the_products(part):
    """The control's float8 operands reach the Linears and the attention's
    products (``stage4``'s attention has no convolution) as well as the
    convolutions; its readings at the cell's size are in ``PERF.md``."""
    ctx = context()
    mit = rs.mit_from_dict(ctx.config["arch"]["mit"])
    net = rs.MiTBackbone(mit).get_submodule(part)
    dim = mit.embed_dims[int(part[5]) - 1]
    x = torch.randn(2, 16, dim, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        plain = net(x, 4, 4)
        with driver(ctx).planted(control=True, fault=None):
            rounded = net(x, 4, 4)
    assert float((rounded - plain).norm() / plain.norm()) > 1e-2


def test_bench_segformer_faults_planted_in_the_reference_are_not_correct():
    ctx = context()
    readings = READINGS.fault_numbers(ctx, driver(ctx), SEED)
    assert set(readings) == {"unchanged", "ema", "half"}
    for fault, numbers in readings.items():
        numbers = READINGS.READINGS.judged(ctx, numbers)
        assert not numbers["correct"], (fault, numbers)


def forward_flops(net, x) -> int:
    with torch.no_grad():
        return work_mit.count(lambda: net(x))


@pytest.mark.parametrize("size", [64, 640])
def test_bench_segformer_work_is_three_forwards(size):
    """The step's count is a ``FlopCounterMode`` count of the reference: three
    times its forward (each product's output, input and weight gradients at
    the forward's MACs) less the input gradient of the first convolution,
    which no step computes, and the DFL decode's product, which the loss does
    not reach (under 1e-4 of the step)."""
    mit = rs.MiTCfg(**{k: tuple(v) for k, v in TINY_MIT.items()}) if size == 64 else rs.MiTCfg()
    arch = get_arch("yolo_heads_l")
    with torch.device("meta"):
        net = rs.SegFormerYoloHeads(mit, arch)
        x = torch.empty(1, 3, size, size)
    first = forward_flops(net.backbone.patch_embed1.proj, x)
    step = work_mit.train_step_flops(mit, arch, size)
    assert step == pytest.approx(3 * forward_flops(net, x) - first, rel=1e-4)
    if size == 640:  # MiT-B5 with the L heads: 299.3 GFLOPs forward
        assert step == pytest.approx(897.4774e9, rel=1e-6)


def test_bench_segformer_work_rule_is_torchs_where_no_convolution_is_grouped():
    """The convolutions' backward rule only changes grouped convolutions:
    YoloHeads L, which has none, counts as ``work.py`` counts it."""
    arch = get_arch("yolo_heads_l")
    from benchmark.reference.models.yolo_heads import YoloHeads

    with torch.device("meta"):
        net = YoloHeads(arch, deploy=False).train()
        x = torch.empty(1, 3, 64, 64)

    def step():
        _, raw = net(x)
        (raw.cls_score_list.sum() + raw.reg_distri_list.sum() + raw.flame_params.sum()).backward()

    assert work_mit.count(step) == work.train_step_flops(arch, 64)


REFERENCE = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark.harness.scenes import Scenes, batches
from benchmark.harness.weights_mit import initial_state
from benchmark.reference.assets_io import get_indices
from benchmark.reference.flame import FlameModel
from benchmark.reference.models import segformer
from benchmark.reference.pipeline import arch_from_dict
from benchmark.reference.train_step import TrainStep, loss_config
cfg = json.load(open({config!r}))
mit = segformer.mit_from_dict(dict(cfg["arch"]["mit"], **{tiny!r}))
arch = arch_from_dict(cfg["arch"]["heads"])
model = segformer.build_model(mit, arch, initial_state(mit, arch, 5, "cpu"), "cpu", train=True)
step = TrainStep(model, FlameModel.from_assets(device="cpu"), cfg["recipe"],
                 loss_config(cfg["recipe"], np.asarray(get_indices()["head"])))
step(*batches(Scenes(5, 2, 64, 2, "cpu"), 2, 30)[0])
print(json.dumps(sorted(sys.modules)))
"""


def test_bench_segformer_reference_loads_nothing_of_the_port():
    code = REFERENCE.format(root=core.ROOT, tiny=TINY_MIT, config=os.path.join(
        core.BENCH_DIR, "configs", "segformer_b5_l.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=core.ROOT, stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr[-3000:]
    names = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert not names & {"jax", "jaxlib", "flax", "head_detector_tpu", "head_detector_tpu_torch"}


def reader(name):
    return core.load_module(os.path.join(core.BENCH_DIR, "metrics", name + ".py"),
                            "bench_metric_" + name.replace(".", "_"))


def test_bench_segformer_readers_are_declared_for_the_cell():
    spec = core.read_json(core.ROOT, "BENCHMARK.json")
    declared = [m["name"] for m in core.cell_metrics(spec, CELL, "per_layer")]
    assert set(METRICS) <= set(declared)
    ends = [m["name"] for m in core.cell_metrics(spec, CELL, "end_to_end")]
    assert ends == ["train_images_per_s", "setup_s"]


def test_bench_segformer_readers_read_a_traced_burst(monkeypatch):
    """The span readers read the port's spans after a traced burst (and
    nothing without the registry or with an empty one); the device readers
    read a device trace, which the CPU has not, so they are given one."""
    ctx = context()
    cell = driver(ctx).Cell(ctx)
    profiling.reset()
    profile = tracing.profile_burst(cell.burst)
    run = core.Run(window=core.Window(metrics={}, attempted=1, failed=0,
                                      facts={"images": 16, "seconds": 2.0}),
                   profile=profile, peaks={"bf16_flops": 989.4e12}, work=cell.work(),
                   counters={"peak_bytes": 2.0 ** 33})
    for name in SPANS:
        value = reader(name).read(run)
        assert value is not None and math.isfinite(value) and value > 0, (name, value)
    assert reader("segformer.mfu").read(run) == pytest.approx(
        100 * cell.work()["flops_per_image"] * 8 / 989.4e12)
    assert reader("segformer.peak_mem_gib").read(run) == 8.0

    run.profile = tracing.Profile(window_s=1.0, busy_s=0.25, idle_gaps=[], kernels={
        "void cunn_SoftMaxForward<4, float>": (0.02, 3), "fmha_bwd_kernel": (0.01, 1),
        "sm90_xmma_gemm_bf16": (0.17, 9)})
    assert reader("segformer.idle_share").read(run) == pytest.approx(75.0)
    assert reader("segformer.attention_share").read(run) == pytest.approx(15.0)

    monkeypatch.delattr(profiling, "snapshot")  # a port without the registry
    assert all(reader(name).read(run) is None for name in SPANS)
    monkeypatch.undo()
    profiling.reset()
    assert all(reader(name).read(run) is None for name in SPANS)
