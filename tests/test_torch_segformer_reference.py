"""The port's SegFormerYoloHeads against the benchmark's plain float32
reference (``benchmark/reference/models/segformer.py``) on the CPU: MiT-B0
widths at depths 2/1/2/1 with the N preset's heads, 64 px, one seeded state
(``benchmark/harness/weights_mit.py``) loaded into both.

Tolerances, and why:
- each submodule and the eval forward (boxes, scores, FLAME rows, DFL
  logits): 2e-5 of each output's largest magnitude.  Both sides are float32
  with TF32 off; they differ by reassociation and by the LayerNorm's variance
  (the port's E[x^2] - E[x]^2 against two passes) and the score scale (the
  port divides by sqrt(head_dim), the reference multiplies by its inverse):
  measured under 1.5e-6;
- one float32 step of ``make_train_step`` against the reference's
  ``TrainStep`` on 4 scenes: the loss components to relative 3e-5 (measured
  under 5e-6); each leaf's gradient to 2e-3 of the larger of its norm and
  the median leaf's (measured 4.8e-4, at the stride-8 FLAME towers' ``alpha``:
  a train-mode BatchNorm over 4 x 8 x 8 values magnifies float32 error),
  where the gradient is not exactly 0 (``EXACT_ZERO_GRAD``: both sides under
  1e-6 of the largest leaf's, measured 8e-9); the parameters' and the EMA's
  change, over the leaves whose gradient moves, to a median relative gap of
  1e-4 (measured 1e-7).  AdamW divides each gradient by its own RMS, so a
  leaf whose gradient is near float32 noise moves by the learning rate either
  way, and a bound on every leaf would measure that noise.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness.scenes import Scenes, batches
from benchmark.harness.weights_mit import initial_state
from benchmark.reference import precision
from benchmark.reference.assets_io import get_indices
from benchmark.reference.flame import FlameModel as RefFlame
from benchmark.reference.models import segformer as rs
from benchmark.reference.models.presets import get_arch as ref_arch
from benchmark.reference.train_step import TrainStep, decays, loss_config
from head_detector_tpu_torch import profiling
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models import build_model
from head_detector_tpu_torch.models import segformer as ps
from head_detector_tpu_torch.models.presets import get_arch
from head_detector_tpu_torch.train import trainer as tt
from head_detector_tpu_torch.train.loss import LossConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
MIT = dict(embed_dims=(32, 64, 160, 256), depths=(2, 1, 2, 1))
HEADS = "yolo_heads_n"
FRAC = 2e-5
LOSS_RTOL = 3e-5
GRAD_FRAC = 2e-3
ZERO_FRAC = 1e-6
CHANGE_MEDIAN = 1e-4
# leaves whose exact gradient is 0, float32 noise on both sides: the key
# bias (it adds q.b to every score of a query, which the softmax cancels),
# and shifts that only feed a train-mode BatchNorm (the QARepVGG branches'
# biases before ``post_bn``; the last stage's LayerNorm feeds only the
# stride-32 head's stems)
EXACT_ZERO_GRAD = ("attn.k.bias", "branch_1x1.bias", "branch_3x3_bn.bias",
                   "backbone.norm4.bias")


def ref_model():
    return rs.SegFormerYoloHeads(rs.MiTCfg(**MIT), ref_arch(HEADS))


def port_model():
    return ps.SegFormerYoloHeads(ps.MiTCfg(**MIT), get_arch(HEADS))


@pytest.fixture(scope="module")
def nets():
    precision.set_float32(False)
    state = initial_state(rs.MiTCfg(**MIT), ref_arch(HEADS), 7, "cpu")
    ref, port = ref_model(), port_model()
    ref.load_state_dict(state, strict=True)
    port.load_state_dict(state, strict=True)
    return state, ref.eval(), port.eval()


def close_to_max(got, want, frac, name):
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= frac * scale, (name, gap, scale)


@pytest.mark.parametrize("part", ["patch_embed1", "stage1_block0.attn", "stage4_block0.attn",
                                  "stage2_block0.ffn", "stage3_block1", "norm3"])
def test_submodule_matches_reference(nets, part):
    """Patch embed, attention at ``sr`` 8 and 1, Mix-FFN, a whole block and
    a stage's LayerNorm, on the same inputs."""
    _, ref, port = nets
    want_mod, got_mod = ref.backbone.get_submodule(part), port.backbone.get_submodule(part)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        if part == "patch_embed1":
            x = torch.rand(2, 3, SIZE, SIZE, generator=gen)
            want, got = want_mod(x)[0], got_mod(x)[0]
        elif part == "norm3":
            x = torch.randn(2, 16, MIT["embed_dims"][2], generator=gen)
            want, got = want_mod(x), got_mod(x)
        else:
            stage = int(part[5])
            side = SIZE // 2 ** (stage + 1)
            x = torch.randn(2, side * side, MIT["embed_dims"][stage - 1], generator=gen)
            want, got = want_mod(x, side, side), got_mod(x, side, side)
    close_to_max(got, want, FRAC, part)


def test_eval_forward_matches_reference(nets):
    _, ref, port = nets
    x = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        (want, want_raw), (got, got_raw) = ref(x), port(x)
    assert got.flame_params.shape == (2, 8 * 8 + 4 * 4 + 2 * 2, 413)
    for name in ("boxes_xyxy", "scores", "flame_params"):
        close_to_max(getattr(got, name), getattr(want, name), FRAC, name)
    close_to_max(got_raw.reg_distri_list, want_raw.reg_distri_list, FRAC, "dfl")


def leaf_norms(tensors):
    return {n: float(t.detach().norm()) for n, t in tensors.items()}


def test_train_step_matches_reference(nets):
    """One float32 step of the port's ``make_train_step`` and of the
    reference's ``TrainStep`` from the same state on the same batch."""
    state, _, _ = nets
    recipe = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                         "segformer_b5_l.json")))["recipe"]
    recipe = dict(recipe, lr_warmup_steps=0, initial_lr=1e-3)
    images, targets = batches(Scenes(11, 4, SIZE, 3, "cpu"), 4, recipe["max_gt_boxes"])[0]
    heads = np.asarray(get_indices()["head"])

    ref = rs.build_model(rs.MiTCfg(**MIT), ref_arch(HEADS), state, "cpu", train=True)
    ref_step = TrainStep(ref, RefFlame.from_assets(device="cpu"), recipe,
                         loss_config(recipe, heads))
    want = ref_step(images, targets)

    port = port_model()
    port.load_state_dict(state, strict=True)
    crit = dict(recipe["criterion"], indexes_subset=heads)
    cfg = tt.TrainConfig(
        initial_lr=recipe["initial_lr"], cosine_final_lr_ratio=recipe["cosine_final_lr_ratio"],
        warmup_initial_lr=recipe["warmup_initial_lr"], lr_warmup_steps=0,
        max_steps=recipe["max_steps"], weight_decay=recipe["weight_decay"],
        zero_weight_decay_on_bias_and_bn=True, ema=True, ema_decay=recipe["ema_decay"],
        ema_beta=recipe["ema_beta"])
    train_state = tt.TrainState(port, cfg)
    step = tt.make_train_step(port, FlameModel.from_assets(device="cpu"), LossConfig(**crit),
                              cfg)
    _, got = step(train_state, images, targets)

    assert int(got["num_pos"]) == int(want["num_pos"]) > 1
    for name, value in want.items():
        np.testing.assert_allclose(float(got[name]), float(value), rtol=LOSS_RTOL, err_msg=name)

    want_grad = {n: p.grad for n, p in ref.named_parameters()}
    got_grad = {n: p.grad for n, p in port.named_parameters()}
    norms = leaf_norms(want_grad)
    live = [n for n in norms if not n.endswith(EXACT_ZERO_GRAD)]
    median, largest = float(np.median([norms[n] for n in live])), max(norms.values())
    for n in live:
        gap = float((got_grad[n] - want_grad[n]).norm())
        assert gap <= GRAD_FRAC * max(norms[n], median), (n, gap, norms[n], median)
    for n in set(norms) - set(live):
        assert max(norms[n], float(got_grad[n].norm())) <= ZERO_FRAC * largest, n

    moving = [n for n in live if norms[n] >= 1e-3 * median]
    got_params, want_params = dict(port.named_parameters()), dict(ref.named_parameters())
    for got_after, want_after in ((got_params, want_params),
                                  (train_state.ema, ref_step.ema)):
        gaps = [float((got_after[n] - want_after[n]).detach().norm())
                / float((want_after[n] - state[n]).detach().norm()) for n in moving]
        assert float(np.median(gaps)) <= CHANGE_MEDIAN, np.median(gaps)


def test_weight_decay_groups_match_reference(nets):
    """The port's ``_wd_mask`` decays the leaves the reference's ``decays``
    decays: every kernel and ``Linear`` weight, no LayerNorm or BatchNorm
    leaf and no bias."""
    _, ref, port = nets
    got = {n for n, on in tt._wd_mask(port).items() if on}
    want = {n for n, p in ref.named_parameters() if decays(n, p)}
    assert got == want
    assert "backbone.stage1_block0.attn.q.weight" in got
    assert "backbone.stage1_block0.attn.sr.weight" in got
    assert not {n for n in got if "norm" in n.split(".")[-2] or n.endswith("bias")}


def attention_pairs(batch: int) -> int:
    """Sum over the blocks of B * heads * N * (N / sr^2)."""
    cfg, total = ps.MiTCfg(**MIT), 0
    for s, depth in enumerate(cfg.depths):
        n = (SIZE // (4 * 2 ** s)) ** 2
        total += depth * batch * cfg.num_heads[s] * n * (n // cfg.sr_ratios[s] ** 2)
    return total


def test_spans_recorded_per_block_under_a_session_only(nets):
    _, _, port = nets
    x = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(2))
    profiling.reset()
    with torch.no_grad():
        port(x)
    assert profiling.snapshot()["spans"] == {} and profiling.snapshot()["counters"] == {}

    blocks = sum(MIT["depths"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            port(x)
    snap = profiling.snapshot()
    profiling.reset()
    assert snap["spans"]["mit.attention"]["count"] == blocks
    assert snap["spans"]["mit.ffn"]["count"] == blocks
    assert snap["counters"]["mit.attention_pairs"] == attention_pairs(2)


def test_segformer_builds_on_the_meta_device():
    """The published configuration's shapes without memory, as the
    benchmark's counts build YoloHeads: the score scale is worked out on the
    CPU, not on the default device."""
    with torch.device("meta"):
        net = build_model("segformer", dtype=torch.bfloat16, deploy=False)
    assert sum(p.numel() for p in net.backbone.parameters()) == 81_443_008
    assert {b.attn.scale for b in net.backbone.modules() if isinstance(b, ps.MiTBlock)} == {8.0}
