"""The plain reference against the port on the CPU at tiny sizes: the same
functions, so the reference can judge the port's outputs."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness.scenes import Scenes, batches
from benchmark.harness.weights import checkpoint_state, initial_state
from benchmark.reference import flame as ref_flame
from benchmark.reference import nms as ref_nms
from benchmark.reference import raster as ref_raster
from benchmark.reference.pipeline import arch_from_dict, build_model
from benchmark.reference.train_step import TrainStep, loss_config

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SEED = 2 ** 31 + 101


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_bench_reference_forward_matches_port_deploy():
    """The reference's training layout in eval mode computes what the port's
    deploy fusion of the shipped checkpoint computes."""
    from head_detector_tpu_torch.models import build_model as port_build, get_arch
    from head_detector_tpu_torch.weights import flax_from_state_dict, state_dict_from_flax

    cfg = config("yolo_heads_m")
    arch = arch_from_dict(cfg["arch"])
    state = checkpoint_state(os.path.join(ROOT, cfg["weights"]["checkpoint"]), "cpu")
    ref = build_model(arch, state, "cpu")
    port_arch = get_arch("yolo_heads_m")
    deploy_state, _ = state_dict_from_flax(flax_from_state_dict(state), port_arch)
    port = port_build(port_arch, deploy=True).eval()
    port.load_state_dict(deploy_state, strict=True)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = ref(x)
        got, _ = port(x)
    np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(), atol=2e-4)
    np.testing.assert_allclose(got.boxes_xyxy.numpy(), want.boxes_xyxy.numpy(), atol=2e-2)
    np.testing.assert_allclose(got.flame_params.numpy(), want.flame_params.numpy(),
                               rtol=1e-3, atol=2e-3)


def test_bench_reference_training_layout_equals_port():
    """From the benchmark's seeded weights, the reference's training layout
    and the port's give the same train-mode outputs."""
    from head_detector_tpu_torch.models import build_model as port_build, get_arch

    arch = arch_from_dict(config("yolo_heads_l")["arch"])
    state = initial_state(arch, SEED, "cpu")
    ref = build_model(arch, state, "cpu", train=True)
    port = port_build(get_arch("yolo_heads_l"), deploy=False).train()
    port.load_state_dict(state, strict=True)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    _, want = ref(x)
    _, got = port(x)
    for name in ("cls_score_list", "reg_distri_list", "flame_params"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_bench_reference_nms_flame_raster_match_port():
    from head_detector_tpu_torch.flame import FlameModel, fused_project_vertices
    from head_detector_tpu_torch.ops.nms import batched_nms
    from head_detector_tpu_torch.ops.rasterize import pncc_render_plain

    g = torch.Generator().manual_seed(3)
    xy = torch.rand(2, 300, 2, generator=g) * 200
    boxes = torch.cat([xy, xy + 20 + torch.rand(2, 300, 2, generator=g) * 60], -1)
    scores = torch.rand(2, 300, generator=g)
    params = torch.randn(2, 300, 413, generator=g) * 0.1
    a = ref_nms.batched_nms(boxes, scores, params, 0.5, 0.5, 100, 20)
    b = batched_nms(boxes, scores, params, confidence_threshold=0.5, iou_threshold=0.5,
                    pre_nms_max=100, post_nms_max=20)
    for x, y in zip(a, b):
        assert torch.equal(x, y)

    p = (torch.randn(3, 413, generator=g) * 0.1).float()
    p[:, 409:411] = 100.0
    p[:, 412] = 50.0
    want = ref_flame.fused_project_vertices(ref_flame.FlameModel.from_assets(device="cpu"), p)
    got = fused_project_vertices(FlameModel.from_assets(device="cpu"), p)
    for x, y in zip(want, got):
        assert torch.equal(x, y)

    tables = ref_raster.compute_ncc_color_codes(np.random.RandomState(0).rand(50, 3))
    v = torch.rand(2, 50, 3, generator=g) * torch.tensor([48.0, 48.0, 1.0])
    tri = torch.randint(0, 50, (90, 3), generator=g, dtype=torch.int32)
    colors = torch.as_tensor(tables, dtype=torch.float32)
    assert torch.equal(ref_raster.pncc_render_plain(v, tri, colors, 48, 48),
                       pncc_render_plain(v, tri, colors, 48, 48))


def test_bench_reference_train_step_matches_port_float32():
    """Three float32 steps of the reference and of the port's train step
    from the same weights and batches give the same losses and weights."""
    from head_detector_tpu_torch.assets_io import get_indices
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.models import build_model as port_build, get_arch
    from head_detector_tpu_torch.train.loss import LossConfig
    from head_detector_tpu_torch.train.trainer import TrainConfig, TrainState, make_train_step

    cfg = config("yolo_heads_l")
    recipe = cfg["recipe"]
    arch = arch_from_dict(cfg["arch"])
    data = batches(Scenes(SEED, 4, 64, 3, "cpu"), 2, recipe["max_gt_boxes"])
    start = initial_state(arch, SEED, "cpu")

    ref = build_model(arch, start, "cpu", train=True)
    step = TrainStep(ref, ref_flame.FlameModel.from_assets(device="cpu"), recipe,
                     loss_config(recipe, np.asarray(get_indices()["head"])))
    port = port_build(get_arch("yolo_heads_l"), deploy=False)
    port.load_state_dict(start, strict=True)
    crit = dict(recipe["criterion"], indexes_subset=get_indices()["head"])
    train_cfg = TrainConfig(initial_lr=recipe["initial_lr"], max_steps=recipe["max_steps"],
                            warmup_initial_lr=recipe["warmup_initial_lr"],
                            lr_warmup_steps=recipe["lr_warmup_steps"],
                            weight_decay=recipe["weight_decay"])
    state = TrainState(port, train_cfg)
    port_step = make_train_step(port, FlameModel.from_assets(device="cpu"), LossConfig(**crit),
                                train_cfg)
    for images, targets in data:
        want = step(images, targets)
        _, got = port_step(state, images, targets)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-6)
    for n, p in ref.named_parameters():
        torch.testing.assert_close(state.params()[n], p.detach(), rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(state.ema[n], step.ema[n], rtol=1e-6, atol=1e-9)
