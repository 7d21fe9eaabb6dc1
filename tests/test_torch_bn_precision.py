"""The model gradient of a float32 train-mode step against float64, the
port on the CPU against the JAX package's own float32, at a state both
packages build: the shipped ``yolo_heads_m`` checkpoint (every leaf
float32), one params-wire batch of the flagship renderer's scenes made on
the CPU and kept in ``card_probes.BN_BATCH_FILE`` (another machine's torch
and cv2 render other bytes), ``tools/grad_precision.py``'s loss settings.
The yardstick is the port's float64 network, FLAME model and targets on the
CPU (``grad_precision.step_gradients``).

JAX's reading is its ``make_loss_fn`` under ``jax.value_and_grad``, the
gradient tree carried to the port's names by ``weights``.  It is pinned as
``card_probes.JAX_F32_ERROR``, the yardstick that ``card_probes
bn-precision`` and ``chip_smoke.py`` hold the card to (the card's machine
has no jax): this file holds the pin to JAX's reading within
``PIN_TOLERANCE`` (XLA's float32 reductions may round in another order on
another CPU).  Errors are relative L2 over the leaves whose exact gradient
is not 0; the others (``card_probes.exact_zero_leaves``, enumerated from
the module structure) are read apart, as a norm over the model's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from head_detector_tpu import config as jconfig
from head_detector_tpu.flame import FlameModel as JaxFlameModel
from head_detector_tpu.models import build_model as jax_build_model
from head_detector_tpu.train import param_wire as jpw
from head_detector_tpu.train import trainer as jt
from head_detector_tpu_torch import config, weights
from head_detector_tpu_torch.models import build_model
from head_detector_tpu_torch.models.blocks import QARepVGGBlock, YoloNASUpStage
from head_detector_tpu_torch.tools import card_probes as cp
from head_detector_tpu_torch.tools import grad_precision as gp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PIN_TOLERANCE = 0.25  # of the pinned JAX error
CPU_FACTOR = cp.BN_RATIO  # the port's CPU float32 against JAX's float32
ZERO_FLOAT32 = 1e-6  # the exactly-zero leaves' norm over the model's, float32
ZERO_FLOAT64 = 1e-12  # ... in float64


def _jax_gradients(images, targets) -> dict:
    """JAX's float32 model gradient at the state, under the port's names
    (float64 CPU tensors), and its loss components."""
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       weights.load_variables(cp.CHECKPOINT))
    path = f"{config.CONFIG_DIR}/{cp.BN_ARCH}.yaml"
    loss_cfg = jconfig.run_config_from_dict(jconfig.load_config(path)).loss
    loss_fn = jt.make_loss_fn(jax_build_model(cp.BN_ARCH), JaxFlameModel.from_assets(), loss_cfg)
    x = jnp.asarray(images.astype(np.float32) / np.float32(255.0))
    (_, (comps, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], x,
        jpw.ParamTargets(*map(jnp.asarray, targets)))
    tree = {"params": jax.tree_util.tree_map(np.asarray, grads),
            "batch_stats": variables["batch_stats"]}
    flat = weights.train_state_dict_from_flax(tree)[0]
    return ({k: float(v) for k, v in comps.items()},
            {n: t.double() for n, t in flat.items() if "running" not in n
             and "num_batches" not in n})


@pytest.fixture(scope="module")
def readings():
    state, (images, targets), loss_cfg = cp.bn_state(), cp.bn_batch(), cp.bn_loss_cfg()
    comps, grads = {}, {}
    for side, dtype in (("float64", torch.float64), ("port", torch.float32)):
        comps[side], grads[side] = gp.step_gradients(cp.BN_ARCH, state, images, targets,
                                                     loss_cfg, CPU, dtype, loss_dtype=dtype)
    comps["jax"], grads["jax"] = _jax_gradients(images, targets)
    zero = cp.exact_zero_leaves(build_model(cp.BN_ARCH, deploy=False))
    errors = {s: cp.split_error(grads[s], grads["float64"], zero) for s in grads}
    print({s: {k: e[k] for k in ("model", "nonzero", "zero_over_model")}
           for s, e in errors.items()})
    return {"comps": comps, "grads": grads, "zero": zero, "errors": errors, "state": state}


def test_the_sides_take_one_step(readings):
    """Every side's loss components at the state agree to float32: one
    state, one batch, one assignment (74 positives)."""
    comps = readings["comps"]
    for side in ("port", "jax"):
        assert comps[side]["num_pos"] == comps["float64"]["num_pos"] > 0
        for k in (k for k in comps["float64"] if k.startswith("loss")):
            assert abs(comps[side][k] - comps["float64"][k]) <= 1e-5 * abs(
                comps["float64"][k]) + 1e-7, (side, k)
    assert set(readings["grads"]["jax"]) == set(readings["grads"]["float64"])


def test_jax_float32_error_is_the_pinned_yardstick(readings):
    got = readings["errors"]["jax"]["nonzero"]
    assert abs(got - cp.JAX_F32_ERROR) <= PIN_TOLERANCE * cp.JAX_F32_ERROR, got


def test_port_cpu_float32_within_the_bar_of_jax(readings):
    """The port's CPU float32 on the non-zero leaves is no farther from
    float64 than ``BN_RATIO`` times JAX's float32 (it reads ~7.7e-5 in one
    torch thread, ~1.6e-6 in four, against JAX's ~2.8e-4: most of it is in
    the convolutions' weight-gradient sums, which more threads split)."""
    errors = readings["errors"]
    assert errors["port"]["nonzero"] <= CPU_FACTOR * errors["jax"]["nonzero"]
    assert errors["port"]["model"] <= CPU_FACTOR * errors["jax"]["model"]


def test_exact_zero_leaves_from_the_module_structure(readings):
    """The enumerated leaves are the two branch biases of every QARepVGG
    block and each up stage's upsample bias; float64 reads them as 0 to its
    rounding, and both float32 sides as small against the model's norm."""
    net = build_model(cp.BN_ARCH, deploy=False)
    blocks = [m for m in net.modules() if isinstance(m, QARepVGGBlock)]
    ups = [m for m in net.modules() if isinstance(m, YoloNASUpStage)]
    zero = readings["zero"]
    assert len(zero) == 2 * len(blocks) + len(ups) == 172
    params = dict(net.named_parameters())
    assert all(name in params and name.endswith(".bias") for name in zero)
    errors = readings["errors"]
    assert errors["float64"]["zero_over_model"] <= ZERO_FLOAT64
    for side in ("port", "jax"):
        assert errors[side]["zero_over_model"] <= ZERO_FLOAT32, side
    # a leaf that is not in the list is not zero in float64
    g64 = readings["grads"]["float64"]
    norm = float(torch.linalg.norm(torch.cat([g.reshape(-1) for g in g64.values()])))
    near_zero = {n for n, g in g64.items() if float(torch.linalg.norm(g)) <= ZERO_FLOAT64 * norm}
    assert near_zero - set(zero) <= {n for n in g64 if n.startswith("heads.head")}
    assert set(zero) <= near_zero


def test_batchnorm_alone_on_the_cpu(readings):
    """``card_probes.batchnorm_alone`` on the CPU: float32 against float64
    at the rounding of one reduction, float64 against itself exactly."""
    net = build_model(cp.BN_ARCH, deploy=False)
    net.load_state_dict(readings["state"], strict=True)
    bn = net.neck.neck2.blocks.conv3.bn
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.standard_normal((4, bn.num_features, 16, 16)) * 3.0 + 1.0)
    g = torch.as_tensor(rng.standard_normal(x.shape) * 1e-3)
    ref = cp.batchnorm_alone(bn, x, g, CPU, torch.float64)
    got = cp.batchnorm_alone(bn, x, g, CPU, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(cp.batchnorm_alone(bn, x, g, CPU,
                                                                    torch.float64), ref))
    assert [tuple(t.shape) for t in got] == [tuple(x.shape), tuple(x.shape),
                                             (bn.num_features,), (bn.num_features,)]
    for a, b in zip(got, ref):
        assert cp._rel(a, b) <= 1e-5


def test_the_kept_batch_is_the_renderers(tmp_path):
    """``BN_BATCH_FILE`` holds ``card_probes.render_bn_batch``'s batch: the
    FLAME parameters (numpy draws) equal, the boxes and offsets (a float64
    FLAME placement) and the images (rasterized, JPEG) as this machine
    renders them, up to another build's rounding."""
    images, targets = cp.bn_batch()
    path = str(tmp_path / "batch.npz")
    cp.write_bn_batch(path)
    with np.load(path) as f:
        np.testing.assert_array_equal(f["gt_flame"], targets.gt_flame)
        np.testing.assert_array_equal(f["pad_gt_mask"], targets.pad_gt_mask)
        for key in ("gt_bboxes", "gt_offsets"):
            np.testing.assert_allclose(f[key], getattr(targets, key), atol=1e-2)
        assert np.abs(f["images"].astype(np.int16) - images).mean() < 1.0
    assert images.shape == (cp.BN_BATCH, cp.BN_SIZE, cp.BN_SIZE, 3)
