"""The port's training-layout model and train step against the JAX package on
the CPU: the TINY arch (tests/test_model.py) at 64 px, batch 2, float32,
JAX-initialised weights carried across with ``train_state_dict_from_flax``.

Bars, and why:
- train-mode forward: scores, boxes and the dense FLAME rows to 1e-3 of
  their largest magnitude; BatchNorm running statistics after one train
  forward to relative 1e-4.  A random network in train mode normalises its
  deepest maps over 8 values (2 x 2 at stride 32, batch 2), which magnifies
  float32 reassociation; the eval-mode forward agrees to 1e-4.
- one full train step: loss components to relative 1e-3 (measured 7e-4 on
  ``loss_cls``, whose assigned scores go as IoU^6), Adam's first moment
  (0.1 g) and second moment to 2e-3 of their largest magnitude over the
  model (the gradients agree to 1.3e-3 of the largest one), BatchNorm
  statistics to relative 1e-4, and the parameter step ``p1 - p0`` to 1e-3
  of the learning rate wherever the gradient is above 1% of the largest
  one.  Adam's first step is ``lr * g / (|g| + eps)``, about ``lr * sign(g)``,
  so where the gradient is float32 noise the sign, and the step, may differ
  by 2 lr; those entries are held to that.  The EMA is checked exactly
  against the port's own parameters and to the same bars against JAX.
- the optimizer alone, fed the same gradients: parameters and moments to
  relative 1e-6 (absolute 5e-7, a few float32 steps of parameters of order
  1) after two steps (weight decay, mask and bias correction).
- the schedule at steps 0, warmup-1, warmup, warmup+1 and max-1, the EMA
  decay, and the weight-decay mask leaf by leaf: equal (schedule to 1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from head_detector_tpu.flame import FlameModel as JaxFlameModel
from head_detector_tpu.models import build_model as jax_build_model
from head_detector_tpu.models import init_model as jax_init_model
from head_detector_tpu.models.yolo_heads import calibrate_batch_stats as jax_calibrate
from head_detector_tpu.train import trainer as jt
from head_detector_tpu.train.loss import LossConfig as JaxLossConfig
from head_detector_tpu.train.loss import Targets as JaxTargets
from head_detector_tpu_torch import weights
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.models import build_model, calibrate_batch_stats, init_model
from head_detector_tpu_torch.train import trainer as tt
from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset, collate_samples
from head_detector_tpu_torch.train.loss import COMPONENT_NAMES, LossConfig
from test_model import TINY
from test_torch_options import port_arch

SIZE = 64
STEP_CFG = dict(lr_warmup_steps=0, initial_lr=1e-2, max_steps=10)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    model = jax_build_model(TINY)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_init_model(model, jax.random.PRNGKey(0), (SIZE, SIZE)))
    ds = SyntheticHeadsDataset(image_size=SIZE, length=2, max_heads=3, seed=3, device="cpu")
    images, targets = collate_samples([ds[0], ds[1]], 4)
    return model, variables, images, targets


def port_model(variables):
    state, used = weights.train_state_dict_from_flax(variables)
    assert used == weights.count_leaves(variables)
    net = build_model(port_arch(TINY), deploy=False)
    net.load_state_dict(state, strict=True)
    return net


def port_tree(net, tensors=None):
    """flax-layout tree of the net's state, or of ``tensors`` by parameter
    name (gradients, moments) with the net's running statistics beside."""
    state = net.state_dict()
    if tensors is not None:
        state = {**tensors, **{k: v for k, v in state.items() if "running" in k}}
    return weights.flax_from_state_dict(state)


def _close_to_max(got, want, frac, name):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=frac * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("train", [True, False])
def test_train_layout_forward_matches_flax(setup, train):
    model, variables, images, _ = setup
    x = images.astype(np.float32) / 255.0
    if train:
        (dec_j, raw_j), mutated = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    else:
        dec_j, raw_j = jax.jit(lambda v, x: model.apply(v, x, train=False))(
            variables, jnp.asarray(x))
    net = port_model(variables)
    net.train(train)
    with torch.no_grad():
        dec_t, raw_t = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    frac = 1e-3 if train else 1e-4
    _close_to_max(dec_t.scores.numpy(), np.asarray(dec_j.scores), frac, "scores")
    _close_to_max(dec_t.boxes_xyxy.numpy(), np.asarray(dec_j.boxes_xyxy), frac, "boxes")
    # train layout: the dense, globalised FLAME rows of every anchor
    assert dec_t.flame_params.shape == (2, raw_j.anchor_points.shape[0], 413)
    _close_to_max(raw_t.flame_params.numpy(), np.asarray(raw_j.flame_params), frac, "flame")
    if train:
        got, want = flat(port_tree(net)["batch_stats"]), flat(mutated["batch_stats"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4 * np.abs(want[k]).max(), err_msg=k)


def test_calibrate_batch_stats_matches_flax(setup):
    """Momentum 1: the running statistics become one batch's statistics;
    without the 0.97 of the old statistics that damps the train forward's
    update, they agree to 2e-3 of each leaf's largest value (measured 5e-4;
    a flax-style E[x^2] - E[x]^2 variance in the port measures the same)."""
    model, variables, images, _ = setup
    x = images.astype(np.float32) / 255.0
    want = flat(jax_calibrate(model, variables, jnp.asarray(x))["batch_stats"])
    net = port_model(variables)
    calibrate_batch_stats(net, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not net.training
    assert all(m.momentum == TINY.bn_momentum for m in net.modules() if hasattr(m, "running_var"))
    got = flat(port_tree(net)["batch_stats"])
    for k in want:
        _close_to_max(got[k], want[k], 2e-3, k)


def test_init_model_follows_flax_initialisers():
    """Random init: lecun-normal kernels (std sqrt(1/fan_in), truncated at 2
    std), zero biases but the classifier's focal prior, unit BN scales and
    alphas, running statistics calibrated, finite outputs."""
    net = init_model(build_model(port_arch(TINY), deploy=False),
                     torch.Generator().manual_seed(0), (SIZE, SIZE))
    w = net.backbone.stage4.blocks.conv3.conv.weight
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.1
    assert w.abs().max().item() <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-6
    assert torch.all(net.heads.head1.cls_pred.bias == -np.log(99.0)).item()
    assert torch.all(net.heads.head1.reg_pred.bias == 0).item()
    assert net.heads.head2.flame_rotation_pred.block0.alpha.item() == 1.0
    assert torch.all(net.neck.neck1.conv.bn.weight == 1).item()
    assert not torch.all(net.neck.neck1.conv.bn.running_var == 1).item()  # calibrated
    again = init_model(build_model(port_arch(TINY), deploy=False),
                       torch.Generator().manual_seed(0), (SIZE, SIZE))
    for (k, a), b in zip(net.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k  # seeded: the same draws
    with torch.no_grad():
        dec, _ = net(torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(1)))
    assert torch.isfinite(dec.scores).all() and torch.isfinite(dec.flame_params).all()


@pytest.fixture(scope="module")
def stepped(setup):
    """One train step of each package from the same weights and batch."""
    model, variables, images, targets = setup
    jcfg = jt.TrainConfig(**STEP_CFG)
    jstate = jt.create_train_state(model, variables, jcfg)
    jstep = jax.jit(jt.make_train_step(model, JaxFlameModel.from_assets(), JaxLossConfig(), jcfg))
    jnew, jcomp = jstep(jstate, jnp.asarray(images), JaxTargets(*map(jnp.asarray, targets)))

    net = port_model(variables)
    p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    cfg = tt.TrainConfig(**STEP_CFG)
    state = tt.TrainState(net, cfg)
    step = tt.make_train_step(net, FlameModel.from_assets(device="cpu"), LossConfig(), cfg)
    state, comp = step(state, images, targets)
    return jstate, jnew, jcomp, net, p0, state, comp


def test_train_step_matches_jax(stepped):
    jstate, jnew, jcomp, net, p0, state, comp = stepped
    assert state.step == int(jnew.step) == 1
    for name in COMPONENT_NAMES:
        np.testing.assert_allclose(float(comp[name]), float(jcomp[name]), rtol=1e-3,
                                   err_msg=name)
    assert int(comp["num_pos"]) == int(jcomp["num_pos"]) > 0

    adam = jnew.opt_state[0]
    moments = {n: state.optimizer.state[p] for n, p in net.named_parameters()}
    mu_t = flat(port_tree(net, {n: m["exp_avg"] for n, m in moments.items()})["params"])
    nu_t = flat(port_tree(net, {n: m["exp_avg_sq"] for n, m in moments.items()})["params"])
    mu_j, nu_j = flat(adam.mu), flat(adam.nu)
    mu_max = max(np.abs(v).max() for v in mu_j.values())
    nu_max = max(np.abs(v).max() for v in nu_j.values())
    for k in mu_j:
        np.testing.assert_allclose(mu_t[k], mu_j[k], atol=2e-3 * mu_max, rtol=0, err_msg=k)
        np.testing.assert_allclose(nu_t[k], nu_j[k], atol=2e-3 * nu_max, rtol=0, err_msg=k)
    for m in moments.values():
        assert int(m["step"]) == int(adam.count) == 1

    lr = STEP_CFG["initial_lr"]
    old = flat(jstate.params)
    new_t, new_j = flat(port_tree(net)["params"]), flat(jnew.params)
    for k in new_j:
        dt, dj = new_t[k] - old[k], new_j[k] - old[k]
        strong = np.abs(mu_j[k]) > 1e-2 * mu_max
        np.testing.assert_allclose(dt[strong], dj[strong], atol=1e-3 * lr, rtol=0, err_msg=k)
        np.testing.assert_array_less(np.abs(dt - dj), 2 * lr * (1 + 1e-4), err_msg=k)

    got, want = flat(port_tree(net)["batch_stats"]), flat(jnew.batch_stats)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max(), err_msg=k)

    d = tt._ema_decay(1, tt.TrainConfig(**STEP_CFG))
    for n, p in net.named_parameters():
        np.testing.assert_allclose(state.ema[n].numpy(),
                                   (p0[n] * d + p.detach() * (1 - d)).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    ema_t, ema_j = flat(port_tree(net, state.ema)["params"]), flat(jnew.ema_params)
    for k in ema_j:
        np.testing.assert_allclose(ema_t[k], ema_j[k], atol=2 * (1 - d) * lr * (1 + 1e-4),
                                   rtol=0, err_msg=k)


def test_optimizer_alone_matches_optax(setup):
    """Two AdamW steps on the same gradients: the port's groups, decay and
    bias correction against optax.adamw with ``_wd_mask``."""
    _, variables, _, _ = setup
    net = port_model(variables)
    cfg = tt.TrainConfig(lr_warmup_steps=1, initial_lr=1e-2, max_steps=5, weight_decay=0.1)
    opt = tt.make_optimizer(cfg, net)
    schedule = tt.make_lr_schedule(cfg)
    params_j = variables["params"]
    tx = jt.make_optimizer(jt.TrainConfig(**dataclasses.asdict(cfg)), params_j)
    opt_state = tx.init(params_j)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    rng = np.random.RandomState(0)
    for step in range(2):
        grads = {n: torch.from_numpy(np.asarray(rng.randn(*p.shape), np.float32))
                 for n, p in net.named_parameters()}
        for n, p in net.named_parameters():
            p.grad = grads[n].clone()
        for g in opt.param_groups:
            g["lr"] = schedule(step)
        opt.step()
        grads_j = port_tree(net, grads)["params"]
        params_j, opt_state = update(grads_j, opt_state, params_j)
    got, want = flat(port_tree(net)["params"]), flat(params_j)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=5e-7, err_msg=k)
    mu = flat(port_tree(net, {n: opt.state[p]["exp_avg"]
                              for n, p in net.named_parameters()})["params"])
    for k, v in flat(opt_state[0].mu).items():
        np.testing.assert_allclose(mu[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("which", ["zero", "warmup-1", "warmup", "warmup+1", "max-1"])
def test_lr_schedule_and_ema_decay_match_optax(which):
    cfg = tt.TrainConfig(lr_warmup_steps=16, max_steps=100)
    step = {"zero": 0, "warmup-1": 15, "warmup": 16, "warmup+1": 17, "max-1": 99}[which]
    want = jt.make_lr_schedule(jt.TrainConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(tt.make_lr_schedule(cfg)(step), float(want(step)), rtol=1e-7)
    jcfg = jt.TrainConfig(**dataclasses.asdict(cfg))
    assert tt._ema_decay(step + 1, cfg) == float(jt._ema_decay(jnp.asarray(step + 1), jcfg))


def test_weight_decay_mask_matches_jax(setup):
    _, variables, _, _ = setup
    net = port_model(variables)
    mask = tt._wd_mask(net)
    got = flat(port_tree(net, {n: torch.tensor(float(m)) .expand_as(p).clone()
                               for (n, p), m in zip(net.named_parameters(), mask.values())})
               ["params"])
    want = flat(jt._wd_mask(variables["params"]))
    assert got.keys() == want.keys()
    for k in want:
        assert bool(np.all(got[k] == 1.0)) == bool(want[k]), k
    assert any(mask.values()) and not all(mask.values())
