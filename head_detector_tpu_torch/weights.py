"""Checkpoints: a flax-msgpack reader, QARepVGG fusion, flax tree -> torch.

Counterparts: ``head_detector_tpu/detector.py:load_variables`` (the msgpack
path) and ``head_detector_tpu/export.py:_fuse_one`` / ``fuse_qarepvgg``.

* :func:`load_variables` decodes a flax ``msgpack_serialize`` file with plain
  ``msgpack``: arrays are ext type 1 holding a packed ``(shape, dtype name,
  C-order bytes)`` triple, numpy scalars ext type 3.  (flax also packs
  complex numbers as type 2, refused here, and splits leaves above 1 GiB
  into chunk dictionaries; no checkpoint of these models has either.)
* :func:`state_dict_from_flax` turns a ``{params, batch_stats}`` tree, in the
  training layout (QARepVGG branches, folded here) or the deploy layout
  (``rbr_reparam``), into the port's state dict: HWIO kernels become OIHW,
  transposed-conv kernels are flipped into torch's layout, BatchNorm
  scale/bias/mean/var become weight/bias/running stats, and every leaf
  becomes float32 before any arithmetic (the shipped checkpoint is float16).
  The reference folds in the leaves' own dtype, so its fused weights of that
  checkpoint carry float16 rounding and the port's do not; on rendered scenes
  the two detectors then differ by 4e-4 in score and 7e-5 relative in the
  posed vertices, inside the 1e-3 bar
  (``tests/test_torch_detector.py::test_shipped_m_checkpoint_matches_jax``),
  so the port keeps the more exact fold.
* :func:`train_state_dict_from_flax` carries a training-layout tree into the
  port's training-layout model unfused (the same leaf-by-leaf layout moves,
  every leaf float32), and :func:`flax_from_state_dict` is its inverse: a
  port state dict as a flax ``{params, batch_stats}`` tree of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import msgpack
import numpy as np
import torch

from head_detector_tpu_torch.models.presets import ArchCfg

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported by this reader")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def load_variables(path: str) -> Dict[str, Any]:
    """Read a flax msgpack checkpoint into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    return 1


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _is_qarepvgg_scope(p) -> bool:
    return isinstance(p, dict) and "branch_3x3_conv" in p and "post_bn" in p


def fuse_qarepvgg_block(params: Dict[str, Any], stats: Dict[str, Any],
                        eps: float) -> Tuple[np.ndarray, np.ndarray]:
    """Training QARepVGG scope -> fused 3x3 (kernel HWIO, bias), in float32:
    fold BN into the 3x3 branch, add alpha * the 1x1 branch at the center
    tap, add the identity when in == out and there is no alpha, fold the
    post-BN."""
    w3 = _f32(params["branch_3x3_conv"]["kernel"])  # [3, 3, in, out]
    g1 = _f32(params["branch_3x3_bn"]["scale"])
    b1 = _f32(params["branch_3x3_bn"]["bias"])
    m1 = _f32(stats["branch_3x3_bn"]["mean"])
    v1 = _f32(stats["branch_3x3_bn"]["var"])
    w1 = _f32(params["branch_1x1"]["kernel"])  # [1, 1, in, out]
    bias1 = _f32(params["branch_1x1"]["bias"])
    alpha = float(_f32(params["alpha"])) if "alpha" in params else 1.0
    g2 = _f32(params["post_bn"]["scale"])
    b2 = _f32(params["post_bn"]["bias"])
    m2 = _f32(stats["post_bn"]["mean"])
    v2 = _f32(stats["post_bn"]["var"])

    s1 = g1 / np.sqrt(v1 + eps)
    w = w3 * s1[None, None, None, :]
    b = b1 - m1 * s1

    w_pad = np.zeros_like(w)
    w_pad[1, 1] = alpha * w1[0, 0]
    w = w + w_pad
    b = b + alpha * bias1

    cin, cout = w3.shape[2], w3.shape[3]
    if cin == cout and "alpha" not in params:
        ident = np.zeros_like(w)
        ident[1, 1, np.arange(cin), np.arange(cin)] = 1.0
        w = w + ident

    s2 = g2 / np.sqrt(v2 + eps)
    w = w * s2[None, None, None, :]
    b = (b - m2) * s2 + b2
    return w, b


def _conv_weight(kernel: np.ndarray, transposed: bool) -> np.ndarray:
    k = _f32(kernel)
    if transposed:
        # flax ConvTranspose [kh, kw, in, out], unflipped -> torch [in, out, kh, kw]
        return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW


def _from_flax(variables: Dict[str, Any],
               fuse_eps: Optional[float]) -> Tuple[Dict[str, torch.Tensor], int]:
    """The walk behind both converters: every QARepVGG training scope is
    fused into ``rbr_reparam`` at BatchNorm epsilon ``fuse_eps``, or carried
    unfused (``alpha`` a scalar) when it is None."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    used = 0

    def put(key, value):
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))

    def walk(p, s, path):
        nonlocal used
        prefix = ".".join(path)
        if fuse_eps is not None and _is_qarepvgg_scope(p):
            w, b = fuse_qarepvgg_block(p, s, fuse_eps)
            put(f"{prefix}.rbr_reparam.weight", _conv_weight(w, False))
            put(f"{prefix}.rbr_reparam.bias", b)
            used += count_leaves(p) + count_leaves(s)
            return
        leaves = {k: v for k, v in p.items() if not isinstance(v, dict)}
        if "scale" in leaves:  # BatchNorm
            put(f"{prefix}.weight", leaves["scale"])
            put(f"{prefix}.bias", leaves["bias"])
            put(f"{prefix}.running_mean", s["mean"])
            put(f"{prefix}.running_var", s["var"])
            out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
            used += 4
        else:  # Conv / ConvTranspose, and a QARepVGG block's alpha
            if "kernel" in leaves:
                put(f"{prefix}.weight",
                    _conv_weight(leaves["kernel"], path[-1] == "upsample"))
            for name in ("bias", "alpha"):
                if name in leaves:
                    put(f"{prefix}.{name}", leaves[name])
            used += len(leaves)
        for key, sub in p.items():
            if isinstance(sub, dict):
                walk(sub, s.get(key, {}) if isinstance(s, dict) else {}, path + [key])

    walk(params, stats, [])
    return out, used


def state_dict_from_flax(
    variables: Dict[str, Any], arch: ArchCfg
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Flax ``{params, batch_stats}`` (numpy leaves) -> (deploy-layout torch
    state dict, number of flax leaves it consumed).  Every leaf of the tree
    is consumed exactly once, so a complete conversion returns
    ``count_leaves(variables)``."""
    return _from_flax(variables, arch.bn_eps)


def train_state_dict_from_flax(
    variables: Dict[str, Any],
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Flax ``{params, batch_stats}`` in the training layout (numpy leaves)
    -> (the port's unfused training-layout state dict, number of flax leaves
    it consumed), by the same leaf moves as :func:`state_dict_from_flax`."""
    return _from_flax(variables, None)


def flax_from_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A port state dict (either layout) -> flax ``{params, batch_stats}``
    of float32 numpy arrays, the inverse of :func:`train_state_dict_from_flax`
    (and of :func:`state_dict_from_flax` on a deploy-layout tree)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    bn_scopes = {k[: -len(".running_mean")] for k in state if k.endswith(".running_mean")}

    def node(tree, path):
        for part in path:
            tree = tree.setdefault(part, {})
        return tree

    for key, value in state.items():
        scope, _, leaf = key.rpartition(".")
        path = scope.split(".")
        v = value.detach().to("cpu", torch.float32).numpy()
        if scope in bn_scopes:
            if leaf in ("weight", "bias"):
                node(params, path)["scale" if leaf == "weight" else "bias"] = v
            elif leaf in ("running_mean", "running_var"):
                node(stats, path)["mean" if leaf == "running_mean" else "var"] = v
        elif leaf == "weight":
            if path[-1] == "upsample":  # torch [in, out, kh, kw] -> flax, unflipped
                k = np.transpose(v, (2, 3, 0, 1))[::-1, ::-1]
            else:  # OIHW -> HWIO
                k = np.transpose(v, (2, 3, 1, 0))
            node(params, path)["kernel"] = np.ascontiguousarray(k)
        elif leaf in ("bias", "alpha"):
            node(params, path)[leaf] = v
    return {"params": params, "batch_stats": stats}
