"""Flax msgpack checkpoints read into the reference's training layout.

A frozen copy of the port's reader (``weights.py``: the msgpack ext types
of ``flax.serialization`` and the flax-scope to torch-key walk), without
the deploy fusion.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import msgpack
import numpy as np
import torch

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


def _load_msgpack(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    return 1


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv_weight(kernel: np.ndarray, transposed: bool) -> np.ndarray:
    k = _f32(kernel)
    if transposed:
        # flax ConvTranspose [kh, kw, in, out], unflipped -> torch [in, out, kh, kw]
        return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW


def train_state_dict_from_flax(
        variables: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], int]:
    """Flax ``{params, batch_stats}`` in the training layout (numpy leaves)
    -> (the training-layout torch state dict, number of flax leaves it
    consumed).  QARepVGG scopes stay unfused: the reference runs the
    training layout, whose eval-mode forward is the deploy fusion's
    function."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    used = 0

    def put(key, value):
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))

    def walk(p, s, path):
        nonlocal used
        prefix = ".".join(path)
        leaves = {k: v for k, v in p.items() if not isinstance(v, dict)}
        if "scale" in leaves and isinstance(s, dict) and "mean" in s:  # BatchNorm
            put(f"{prefix}.weight", leaves["scale"])
            put(f"{prefix}.bias", leaves["bias"])
            put(f"{prefix}.running_mean", s["mean"])
            put(f"{prefix}.running_var", s["var"])
            out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
            used += 4
        elif "scale" in leaves:  # LayerNorm: no statistics
            put(f"{prefix}.weight", leaves["scale"])
            put(f"{prefix}.bias", leaves["bias"])
            used += 2
        else:  # Conv / ConvTranspose / Dense, and a QARepVGG block's alpha
            if "kernel" in leaves:
                kernel = leaves["kernel"]
                put(f"{prefix}.weight",
                    _f32(kernel).T if np.ndim(kernel) == 2  # Dense [in, out]
                    else _conv_weight(kernel, path[-1] == "upsample"))
            for name in ("bias", "alpha"):
                if name in leaves:
                    put(f"{prefix}.{name}", leaves[name])
            used += len(leaves)
        for key, sub in p.items():
            if isinstance(sub, dict):
                walk(sub, s.get(key, {}) if isinstance(s, dict) else {}, path + [key])

    walk(params, stats, [])
    return out, used
