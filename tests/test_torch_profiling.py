"""The port's profiling helpers on the CPU: ``analytic_flops`` equal to the
JAX package's count (2 x MACs of matmuls and convolutions, a transposed
convolution counted over its output positions as JAX's lhs-dilated
convolution counts it) on the yolo_heads_n deploy forward at 64 px
(370,115,168), a grouped conv, a transposed conv, a matmul and an
elementwise-only function; ``time_fn``, ``trace`` / ``span`` and
``mfu`` run on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu import export as jax_export
from head_detector_tpu import profiling as jax_profiling
from head_detector_tpu_torch import export, profiling
from head_detector_tpu_torch.detector import random_variables
from head_detector_tpu_torch.models import get_arch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_deploy_forward_flops_equal_jax():
    variables = random_variables(get_arch("yolo_heads_n"), 64, "cpu")
    model, fused = export.build_deploy("yolo_heads_n", variables, device="cpu")
    jmodel, _ = jax_export.build_deploy("yolo_heads_n", variables, dtype=jnp.float32)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    want = jax_profiling.analytic_flops(
        lambda im: jmodel.apply(fused, im, train=False), jnp.asarray(x))
    got = profiling.analytic_flops(model, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got == want == 370_115_168


def test_grouped_conv_flops_equal_jax():
    x = np.zeros((1, 8, 4, 4), np.float32)
    w = np.zeros((8, 2, 3, 3), np.float32)  # OIHW, I = Cin / groups
    got = profiling.analytic_flops(
        lambda a, b: torch.nn.functional.conv2d(a, b, padding=1, groups=4),
        torch.from_numpy(x), torch.from_numpy(w))
    want = jax_profiling.analytic_flops(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=4),
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)))
    assert got == want == 2.0 * (1 * 4 * 4 * 8) * (3 * 3 * 2)


def test_transposed_conv_flops_equal_jax():
    """The neck's 2x2/s2 upsample: JAX counts 4x its real MACs, and so does
    the port (torch's own counter would count the real ones)."""
    x = np.zeros((2, 8, 4, 4), np.float32)
    w = np.zeros((8, 16, 2, 2), np.float32)  # [in, out, kh, kw]
    got = profiling.analytic_flops(
        lambda a, b: torch.nn.functional.conv_transpose2d(a, b, stride=2),
        torch.from_numpy(x), torch.from_numpy(w))
    want = jax_profiling.analytic_flops(
        lambda a, b: jax.lax.conv_transpose(
            a, b, (2, 2), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 0, 1)))
    real = 2.0 * 2 * (4 * 4) * 8 * 16 * 2 * 2
    assert got == want == 4 * real


def test_matmul_and_elementwise_flops_equal_jax():
    a, b = np.zeros((128, 256), np.float32), np.zeros((256, 64), np.float32)
    got = profiling.analytic_flops(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    want = jax_profiling.analytic_flops(lambda p, q: p @ q, jnp.asarray(a), jnp.asarray(b))
    assert got == want == 2.0 * 128 * 256 * 64
    x = np.zeros((64, 64), np.float32)
    assert profiling.analytic_flops(lambda t: torch.tanh(t) + t * 2.0,
                                    torch.from_numpy(x)) == 0.0
    assert jax_profiling.analytic_flops(lambda t: jnp.tanh(t) + t * 2.0,
                                        jnp.asarray(x)) == 0.0


def test_time_fn_trace_annotate_mfu_on_cpu(tmp_path):
    x = torch.rand(32, 32)
    calls = []

    def fn(t):
        calls.append(1)
        return t @ t

    ms, out = profiling.time_fn(fn, x, warmup=2, iters=5)
    assert ms > 0.0 and len(calls) == 7
    torch.testing.assert_close(out, x @ x)
    with profiling.trace(str(tmp_path)):
        with profiling.span("matmul_region"):
            fn(x)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul_region" for e in events)
    assert profiling.snapshot()["spans"]["matmul_region"]["count"] == 1
    assert profiling.mfu(1e9, 100.0, peak_flops=1e12) == pytest.approx(0.1)
    assert profiling.mfu(0.0, 100.0) == 0.0
    assert profiling.H100_BF16_PEAK_FLOPS == 989.4e12
