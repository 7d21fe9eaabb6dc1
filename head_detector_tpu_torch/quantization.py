"""Post-training quantization: INT8 PTQ (weights + activations) and FP16.

Counterpart of ``head_detector_tpu/quantization.py``, the reference's
export-time quantization surface (``exportable_mesh_model.py:141-146,
175-184``: ``quantization_mode`` INT8|FP16, a calibration loader,
``calibration_method='percentile'`` at 99.99 over 16 batches, a selective
quantizer).  The reference hands the work to pytorch-quantization and
TensorRT; the JAX package rebuilt it, and the port does the same on its own
model:

* **Weights**: symmetric per-output-channel int8 of every conv kernel of a
  flax tree (numpy leaves, so the int8 values and scales are bit-equal to
  the JAX package's); :func:`save_quantized` writes int8 kernels + f32
  scales, every other leaf verbatim.
* **Activations**: symmetric per-tensor int8.  :func:`calibrate_activations`
  observes the input of every ``nn.Conv2d`` / ``nn.ConvTranspose2d`` with a
  global forward pre-hook, removed on exit, and keeps the largest
  per-batch percentile of ``|x|`` (numpy's linear interpolation, computed
  on the input's device from two order statistics).  The keys are the flax
  scope paths (``backbone/stem/conv/rbr_reparam``): the port's module names
  follow the flax scope names, so a torch module path with ``/`` for ``.``
  is the key ``flax`` gives, and ``skip`` regexes, act-scale tables and
  artifact keys mean the same in both packages.
* **Execution**: fake-quant (quantize -> dequantize) inside the same deploy
  model: weights in the tree (:func:`fake_quant_variables`), conv inputs by
  the same kind of hook (:func:`quantized_apply`), ``round(x / s)`` clipped
  to +-127 times ``s`` in float32 on the input's device.  int8 here is an
  accuracy and artifact-size contract, not an int8 kernel.
* **FP16** (:func:`fp16_variables`): weights rounded through half
  precision (``QuantizationMode.FP16``, ``exportable_mesh_model.py:177``).
"""

from __future__ import annotations

import contextlib
import copy
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from head_detector_tpu_torch.weights import state_dict_from_flax, train_state_dict_from_flax

__all__ = [
    "quantize_array",
    "dequantize_array",
    "quantize_weights",
    "fake_quant_variables",
    "calibrate_activations",
    "quantized_apply",
    "ptq",
    "PTQResult",
    "fp16_variables",
    "save_quantized",
    "load_quantized",
]


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------- #
# Weight quantization
# --------------------------------------------------------------------------- #


def quantize_array(
    w: np.ndarray, axis: int = -1
) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization of ``w`` with per-slice scales along
    ``axis`` (the output-channel axis: flax kernels are ``[..., out]``).

    Returns ``(q int8, scale f32)`` with ``scale`` keepdims-shaped so that
    ``q * scale`` broadcasts back to ``w``'s shape."""
    w = np.asarray(w, np.float32)
    axis = axis % w.ndim if w.ndim else 0
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.max(np.abs(w), axis=red, keepdims=True) if red else np.abs(w)
    scale = np.where(amax > 0.0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_array(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


def _is_kernel_scope(v: Any) -> bool:
    return (
        isinstance(v, dict)
        and "kernel" in v
        and not isinstance(v["kernel"], dict)
        and np.ndim(v["kernel"]) >= 2
    )


def _walk_kernels(params: Dict[str, Any], path: Tuple[str, ...] = ()):
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            if _is_kernel_scope(v):
                yield path + (k,), v
            yield from _walk_kernels(v, path + (k,))


def _skipped(key: str, skip: Sequence[str]) -> bool:
    return any(re.search(pat, key) for pat in skip)


def quantize_weights(
    variables: Dict[str, Any], skip: Sequence[str] = ()
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-channel int8 of every conv/dense kernel in the variables tree.

    Returns a flat dict ``{"a/b/c": {"q": int8, "scale": f32}}`` keyed by
    the kernel scope's slash-joined path.  ``skip`` is a list of regexes
    matched against that key (the reference's ``selective_quantizer``
    escape hatch)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for path, scope in _walk_kernels(variables.get("params", variables)):
        key = "/".join(path)
        if _skipped(key, skip):
            continue
        q, scale = quantize_array(np.asarray(scope["kernel"]), axis=-1)
        out[key] = {"q": q, "scale": scale}
    return out


def fake_quant_variables(
    variables: Dict[str, Any], skip: Sequence[str] = ()
) -> Tuple[Dict[str, Any], Dict[str, Dict[str, np.ndarray]]]:
    """Variables pytree with every kernel replaced by dequant(quant(kernel)).

    Drop-in for ``model.apply`` — the deploy graph runs unchanged, now with
    int8-representable weights."""
    qmap = quantize_weights(variables, skip=skip)

    def rebuild(p: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
        new = {}
        for k in p:
            v = p[k]
            if isinstance(v, dict):
                sub = rebuild(v, path + (k,))
                key = "/".join(path + (k,))
                if key in qmap:
                    sub = dict(sub)
                    sub["kernel"] = dequantize_array(qmap[key]["q"], qmap[key]["scale"])
                new[k] = sub
            else:
                new[k] = v
        return new

    if "params" in variables:
        out = dict(variables)
        out["params"] = rebuild(variables["params"], ())
    else:
        out = rebuild(variables, ())
    return out, qmap


# --------------------------------------------------------------------------- #
# Activation calibration + fake-quant execution
# --------------------------------------------------------------------------- #

_QUANT_MODULES = (nn.Conv2d, nn.ConvTranspose2d)


@contextlib.contextmanager
def _conv_inputs(fn: Callable[[str, torch.Tensor], Optional[torch.Tensor]]):
    """Call ``fn(key, x)`` on the input of every conv a forward runs, inside
    the block; a tensor it returns replaces the input.  ``key`` is the conv's
    path under the first module called (the model), ``/``-joined: the flax
    scope path.  Global hooks, so the caller's function keeps its signature."""
    state: Dict[str, Any] = {"root": None, "names": {}}

    def pre(module, args):
        if state["root"] is None:
            state["root"] = module
            state["names"] = {m: name for name, m in module.named_modules()}
        if isinstance(module, _QUANT_MODULES) and args:
            key = state["names"].get(module, "?").replace(".", "/")
            new = fn(key, args[0])
            if new is not None:
                return (new,) + tuple(args[1:])
        return None

    def post(module, args, output):
        if module is state["root"]:
            state["root"] = None

    hooks = (nn.modules.module.register_module_forward_pre_hook(pre),
             nn.modules.module.register_module_forward_hook(post))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def abs_percentile(x: torch.Tensor, percentile: float) -> float:
    """``np.percentile(np.abs(x), percentile)`` of a float32 ``x`` (numpy's
    linear interpolation, whose rank and weight numpy computes in the
    array's float32) on ``x``'s device: the two order statistics around the
    rank come from one ``topk`` of the largest values (``torch.quantile``
    refuses inputs above 2^24 elements), and only they are downloaded."""
    a = x.detach().reshape(-1).to(torch.float32).abs()
    n = a.numel()
    if n == 0:
        return 0.0
    f32 = np.float32
    rank = f32(n - 1) * (f32(percentile) / f32(100))
    lo = min(int(np.floor(rank)), n - 1)
    g = f32(float(rank) - lo)
    top = torch.topk(a, n - lo, sorted=True).values  # descending: top[-1] is rank lo
    below, above = (top[-2:].flip(0) if lo < n - 1 else top[-1:].repeat(2)).cpu().numpy()
    d = above - below
    return float(above - d * (f32(1) - g) if g >= 0.5 else below + d * g)


def calibrate_activations(
    apply_fn: Callable[[Any], Any],
    batches: Iterable[Any],
    percentile: float = 99.99,
    max_batches: int = 16,
) -> Dict[str, float]:
    """Percentile amax of every conv input, keyed by flax scope path: for
    each conv the largest over batches of the per-batch percentile of
    ``|x|``.  ``apply_fn(batch)`` runs the model; defaults are the
    reference calibrator's (99.99, 16 batches,
    ``exportable_mesh_model.py:144-146``)."""
    stats: Dict[str, float] = {}

    def observe(key, x):
        stats[key] = max(stats.get(key, 0.0), abs_percentile(x, percentile))

    for i, batch in enumerate(batches):
        if i >= max_batches:
            break
        with torch.no_grad(), _conv_inputs(observe):
            apply_fn(batch)
    return stats


def _fake_quant_inputs(act_scales: Dict[str, float], skip: Sequence[str]):
    def quant(key, x):
        amax = act_scales.get(key, 0.0)
        if amax <= 0.0 or _skipped(key, skip):
            return None
        s = torch.full((), amax / 127.0, dtype=torch.float32, device=x.device)
        q = torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127)
        return (q * s).to(x.dtype)

    return quant


def _loaded(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """A copy of the port's ``model`` (deploy or training layout) holding the
    flax tree ``variables``, in eval mode."""
    state, _ = (state_dict_from_flax(variables, model.arch) if model.deploy
                else train_state_dict_from_flax(variables))
    out = copy.deepcopy(model)
    out.load_state_dict(state, strict=True)
    return out.eval()


def quantized_apply(
    model: nn.Module,
    fq_variables: Dict[str, Any],
    act_scales: Optional[Dict[str, float]] = None,
    skip: Sequence[str] = (),
    **apply_kwargs,
) -> Callable:
    """Forward of a copy of ``model`` holding ``fq_variables`` (int8
    representable weights) with every conv input fake-quantized at its
    ``act_scales`` entry (skipping keys matching ``skip``): the W8A8
    accuracy surface of the graph."""
    qmodel = _loaded(model, fq_variables)
    quant = _fake_quant_inputs(act_scales or {}, skip)

    def fn(*args, **kwargs):
        with torch.no_grad(), _conv_inputs(quant):
            return qmodel(*args, **apply_kwargs, **kwargs)

    return fn


@dataclass
class PTQResult:
    """Outcome of :func:`ptq`: everything needed to run, ship or audit the
    quantized model."""

    variables: Dict[str, Any]
    weight_qmap: Dict[str, Dict[str, np.ndarray]]
    act_scales: Dict[str, float]
    report: Dict[str, float] = field(default_factory=dict)


def ptq(
    model: nn.Module,
    variables: Dict[str, Any],
    calibration_batches: Optional[Iterable[Any]] = None,
    percentile: float = 99.99,
    max_batches: int = 16,
    skip: Sequence[str] = (),
    **apply_kwargs,
) -> PTQResult:
    """One-call INT8 PTQ, the counterpart of the reference's ``ptq(model,
    selective_quantizer, calibration_loader, ...)``
    (``exportable_mesh_model.py:398-405``): per-channel int8 weights (minus
    ``skip``), percentile calibration of the conv inputs of ``model``
    holding them over ``calibration_batches`` (none: weight-only), and a
    weight-error report."""
    fq_vars, qmap = fake_quant_variables(variables, skip=skip)

    act_scales: Dict[str, float] = {}
    if calibration_batches is not None:
        qmodel = _loaded(model, fq_vars)
        act_scales = calibrate_activations(
            lambda batch: qmodel(batch, **apply_kwargs), calibration_batches,
            percentile=percentile, max_batches=max_batches)

    # weight quantization error: mean |w - dq(q(w))| / amax per kernel
    errs: List[float] = []
    for path, scope in _walk_kernels(variables.get("params", variables)):
        key = "/".join(path)
        if key not in qmap:
            continue
        w = np.asarray(scope["kernel"], np.float32)
        dq = dequantize_array(qmap[key]["q"], qmap[key]["scale"])
        amax = float(np.max(np.abs(w))) or 1.0
        errs.append(float(np.mean(np.abs(w - dq))) / amax)
    report = {
        "kernels_quantized": float(len(qmap)),
        "mean_weight_err_rel": float(np.mean(errs)) if errs else 0.0,
        "max_weight_err_rel": float(np.max(errs)) if errs else 0.0,
        "activations_calibrated": float(len(act_scales)),
    }
    return PTQResult(fq_vars, qmap, act_scales, report)


# --------------------------------------------------------------------------- #
# FP16
# --------------------------------------------------------------------------- #


def fp16_variables(variables: Dict[str, Any]) -> Dict[str, Any]:
    """Weights round-tripped through IEEE half precision, the reference's
    ``QuantizationMode.FP16`` (``exportable_mesh_model.py:177``): float
    leaves come back float32 with float16-representable values, integer
    leaves pass through."""
    if isinstance(variables, dict):
        return {k: fp16_variables(v) for k, v in variables.items()}
    a = np.asarray(variables)
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float16).astype(np.float32)
    return variables


# --------------------------------------------------------------------------- #
# Quantized artifact
# --------------------------------------------------------------------------- #


def save_quantized(path: str, variables: Dict[str, Any], skip: Sequence[str] = ()) -> Dict[str, float]:
    """Write an int8-weight artifact: kernels as int8 + per-channel scales,
    every other leaf verbatim (f32).  Returns size accounting."""
    qmap = quantize_weights(variables, skip=skip)
    flat: Dict[str, np.ndarray] = {}
    has_params = "params" in variables

    def walk(p, path):
        for k in sorted(p):
            v = p[k]
            sub = path + (k,)
            if isinstance(v, dict):
                walk(v, sub)
            else:
                key = "/".join(sub)
                # qmap keys are relative to the 'params' subtree
                rel = sub[:-1][1:] if has_params and sub[:1] == ("params",) else sub[:-1]
                parent = "/".join(rel)
                if k == "kernel" and parent in qmap:
                    flat["q8:" + key] = qmap[parent]["q"]
                    flat["sc:" + key] = qmap[parent]["scale"]
                else:
                    flat["f:" + key] = np.asarray(v)

    walk(variables, ())
    np.savez(path, **flat)
    f32_bytes = sum(np.asarray(v).size * 4 for v in _leaves(variables))
    q_bytes = sum(a.nbytes for a in flat.values())
    return {"f32_bytes": float(f32_bytes), "quantized_bytes": float(q_bytes)}


def load_quantized(path: str) -> Dict[str, Any]:
    """Reconstruct a fake-quant variables pytree from :func:`save_quantized`
    output (kernels dequantized to f32)."""
    data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
    tree: Dict[str, Any] = {}
    for key in data.files:
        kind, rest = key.split(":", 1)
        parts = rest.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if kind == "q8":
            node.setdefault("__q8__", {})[parts[-1]] = data[key]
        elif kind == "sc":
            node.setdefault("__sc__", {})[parts[-1]] = data[key]
        else:
            node[parts[-1]] = data[key]

    def resolve(node):
        if not isinstance(node, dict):
            return node
        q8 = node.pop("__q8__", {})
        sc = node.pop("__sc__", {})
        out = {k: resolve(v) for k, v in node.items()}
        for k, q in q8.items():
            out[k] = dequantize_array(q, sc[k])
        return out

    return resolve(tree)
