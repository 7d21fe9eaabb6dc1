"""Model export: QARepVGG fusion (deploy layout), the space-to-depth stem and
serialized graphs.

Counterpart of ``head_detector_tpu/export.py``.  The reference ships its
models as ``.trcd`` TorchScript (``exportable_mesh_model.py:440-442``); the
JAX package rebuilt that as StableHLO bytes (``jax.export``).  Here:

* :func:`fuse_qarepvgg` folds every training-layout QARepVGG scope of a flax
  tree into one 3x3 conv + bias (``rbr_reparam``) and returns the deploy
  tree, numpy leaves, with the fold of ``weights.fuse_qarepvgg_block`` (in
  float32 whatever the leaves' dtype);
* :func:`build_deploy` gives the port's deploy ``YoloHeads`` loaded with
  that tree, on the requested device (``s2d_stem``: the stem in its
  space-to-depth form, kernel re-laid by :func:`s2d_stem_kernel`);
* :func:`export_serialized` / :func:`load_serialized` are the portable graph:
  ``torch.export.export`` of a module, saved with ``torch.export.save``
  (an ``ExportedProgram``, the counterpart of the StableHLO bytes);
  ``torch_mirror.export_torchscript`` writes the ``.trcd``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from head_detector_tpu_torch.device import resolve_device
from head_detector_tpu_torch.models import build_model, get_arch
from head_detector_tpu_torch.models.presets import ArchCfg
from head_detector_tpu_torch.models.yolo_heads import YoloHeads
from head_detector_tpu_torch.weights import fuse_qarepvgg_block, state_dict_from_flax


def _is_qarepvgg_scope(p) -> bool:
    return isinstance(p, dict) and "branch_3x3_conv" in p and "post_bn" in p


def s2d_stem_kernel(w: np.ndarray) -> np.ndarray:
    """Re-lay a fused 3x3/s2 stem kernel [3,3,C,O] (HWIO) for the
    space-to-depth stem: output (i, j) of the dense conv (pad 1) reads input
    rows 2i-1..2i+1, which after a 2x2 space-to-depth (channel order
    ``(di*2+dj)*C + c``) are s2d rows {i-1, i}, so the same arithmetic is a
    2x2/s1 conv (pad (1,0)) whose kernel [2,2,4C,O] scatters the 9 dense
    taps into 9 of the 16 (ky, kx, di, dj) slots; the rest stay zero."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"stem kernel must be 3x3, got {w.shape}")
    k = np.zeros((2, 2, 4 * cin, cout), w.dtype)
    for ky in range(2):
        for di in range(2):
            u = 2 * ky + di - 1  # dense tap row (0..2); -1 is the zero pad
            if not 0 <= u <= 2:
                continue
            for kx in range(2):
                for dj in range(2):
                    v = 2 * kx + dj - 1
                    if not 0 <= v <= 2:
                        continue
                    blk = (di * 2 + dj) * cin
                    k[ky, kx, blk:blk + cin] = w[u, v]
    return k


def fuse_qarepvgg(variables: Dict[str, Any], arch: ArchCfg) -> Dict[str, Any]:
    """Training-layout flax tree -> deploy tree ``{params, batch_stats}``:
    every QARepVGG scope replaced by its fused ``rbr_reparam`` {kernel,
    bias} (float32), every other leaf passed through as numpy."""
    eps = arch.bn_eps

    def walk(p, s):
        # BN scopes hold {scale, bias} in params and {mean, var} in stats under
        # the same key, so the union of keys is walked
        if _is_qarepvgg_scope(p):
            w, b = fuse_qarepvgg_block(p, s, eps)
            return {"rbr_reparam": {"kernel": w, "bias": b}}, None
        if isinstance(p, dict):
            new_p, new_s = {}, {}
            s = s if isinstance(s, dict) else {}
            for key in sorted(set(p) | set(s)):
                if key not in p:  # stats-only subtree (BN mean/var)
                    new_s[key] = np.asarray(s[key])
                    continue
                fp, fs = walk(p[key], s.get(key))
                new_p[key] = fp
                if fs:
                    new_s[key] = fs
            return new_p, new_s
        return np.asarray(p), s

    params, stats = walk(variables["params"], variables.get("batch_stats", {}))
    return {"params": params, "batch_stats": stats or {}}


def build_deploy(
    name_or_arch,
    variables: Dict[str, Any],
    dtype: torch.dtype = torch.float32,
    defer_globalization: bool = False,
    skip_flame: bool = False,
    s2d_stem: bool = False,
    device="cuda",
) -> Tuple[YoloHeads, Dict[str, Any]]:
    """(the port's deploy ``YoloHeads`` loaded and in eval mode on ``device``,
    the fused tree) from a training-layout flax tree."""
    arch = name_or_arch if isinstance(name_or_arch, ArchCfg) else get_arch(name_or_arch)
    fused = fuse_qarepvgg(variables, arch)
    if s2d_stem:
        stem = fused["params"]["backbone"]["stem"]["conv"]["rbr_reparam"]
        stem["kernel"] = s2d_stem_kernel(stem["kernel"])
    model = build_model(arch, defer_globalization=defer_globalization,
                        skip_flame=skip_flame, dtype=dtype, deploy=True, s2d_stem=s2d_stem)
    state, _ = state_dict_from_flax(fused, arch)
    model.load_state_dict(state, strict=True)
    return model.to(resolve_device(device)).eval(), fused


class _FunctionModule(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_serialized(fn_or_module, example_args, path: str) -> None:
    """Write ``torch.export.export`` of a module (or of a function, wrapped
    in one) at ``example_args`` to ``path``: the graph with its weights and
    constants, on the examples' device, at their shapes."""
    module = fn_or_module if isinstance(fn_or_module, nn.Module) else _FunctionModule(fn_or_module)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    torch.export.save(program, path)


def load_serialized(path: str):
    """The callable module of a program written by :func:`export_serialized`."""
    return torch.export.load(path).module()
