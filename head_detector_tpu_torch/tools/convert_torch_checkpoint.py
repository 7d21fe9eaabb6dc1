"""PyTorch (SuperGradients) checkpoint -> flax-tree converter, on numpy.

Counterpart of ``tools/convert_torch_checkpoint.py`` (the port keeps its own
copy).  The reference trains with SuperGradients and ships its weights as
torch state dicts.  This tool maps such a state dict onto the flax
``{params, batch_stats}`` tree that ``weights.load_variables`` returns, so
that

* a reference user's trained checkpoint runs through the port's
  ``HeadDetector(checkpoint=...)`` (``weights.load_variables`` calls
  :func:`convert` for ``.pth``/``.pt``/``.ckpt`` paths), and
* COCO YOLO-NAS detection weights seed training by key matching
  (``train/checkpoint.restore_key_matching``).

Mapping rules (torch module path -> flax scope path):

====================  =============================================
torch                  flax
====================  =============================================
``<wrapper>.backbone.X``   ``backbone/X``  (any wrapper prefix up to the
                           first backbone/neck/heads segment is stripped)
``.seq.``              dropped (SG ConvBNAct wraps conv/bn/act in ``seq``)
``branch_3x3.conv``    ``branch_3x3_conv``   (QARepVGG block)
``branch_3x3.bn``      ``branch_3x3_bn``
``bottlenecks.N``      ``bottleneckN``       (CSP layer)
``cls_convs.N``        ``cls_conv``          (single-conv towers)
``reg_convs.N``        ``reg_conv``
``flame_*_pred.N``     ``flame_*_pred.blockN`` for QARepVGG blocks,
                       ``flame_*_pred.pred`` for the final 1x1 conv
``bottlenecks.N.alpha``  folded into ``bottleneckN/cv2/post_bn``
                       (scale/bias *= alpha): SG's YoloNASBottleneck
                       computes ``x + alpha * cv2(cv1(x))``, and scaling
                       cv2's post-BN affine by alpha is that exact
                       multiply; our flax bottleneck has no alpha param.
====================  =============================================

Leaf/value rules:

* conv ``weight [O,I,kh,kw]``      -> ``kernel [kh,kw,I,O]``
* conv-transpose ``weight [I,O,kh,kw]`` (path contains ``upsample``)
                                   -> ``kernel [kh,kw,I,O]`` + spatial flip
                                      (validated exact in tests/test_convert.py)
* linear ``weight [O,I]``          -> ``kernel [I,O]``
* BN ``weight/bias``               -> params ``scale``/``bias``
* BN ``running_mean/running_var``  -> batch_stats ``mean``/``var``
* ``num_batches_tracked``          -> dropped
* ``alpha``                        -> scalar ``alpha``

Usage::

    python -m head_detector_tpu_torch.tools.convert_torch_checkpoint \
        ckpt.pth out.msgpack [--arch yolo_heads_l] [--ema]

The output is a flax msgpack file (``weights.save_variables``).  With
``--arch`` the converted tree is matched by name and shape against the
port's training-layout model of that preset
(``train/checkpoint.restore_key_matching``) and the count is printed.
"""

from __future__ import annotations

import argparse
import pickle
import re
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

_ROOTS = ("backbone.", "neck.", "heads.")
_BN_STATS = ("running_mean", "running_var")


def _strip_wrapper(key: str) -> Optional[str]:
    """Cut any training-wrapper prefix: keep from the first backbone/neck/heads."""
    positions = [key.find(r) for r in _ROOTS if key.find(r) != -1]
    if not positions:
        return None
    return key[min(positions):]


def normalize_state_dict(raw: Dict[str, Any], prefer_ema: bool = False) -> Dict[str, np.ndarray]:
    """Flatten an SG checkpoint payload into {model_key: np.ndarray}.

    SG ``ckpt_best.pth`` files hold dicts with ``net`` (and optionally
    ``ema_net``) state dicts; bare state dicts and traced-module dicts are
    handled identically: every tensor key is cut down to its
    backbone/neck/heads path.
    """
    candidates: Iterable[Tuple[str, Any]]
    if any(k in raw for k in ("net", "ema_net", "state_dict", "model_state_dict")):
        source = None
        if prefer_ema:
            if "ema_net" not in raw:
                # never silently hand back raw weights when EMA was asked
                # for: that would score the wrong parameter set
                raise KeyError(
                    "prefer_ema=True but the checkpoint has no 'ema_net' "
                    f"entry (keys: {sorted(raw)[:8]}). Re-run without --ema "
                    "to convert the raw 'net' weights."
                )
            source = raw["ema_net"]
        else:
            for k in ("net", "state_dict", "model_state_dict", "ema_net"):
                if k in raw:
                    source = raw[k]
                    break
        candidates = source.items()
    else:
        candidates = raw.items()

    out: Dict[str, np.ndarray] = {}
    for key, value in candidates:
        if key.endswith("num_batches_tracked"):
            continue
        model_key = _strip_wrapper(key)
        if model_key is None:
            continue
        arr = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        out[model_key] = arr
    return out


_FLAME_TOWER = re.compile(r"^(flame_\w+_pred)\.(\d+)$")


def _translate_segments(parts: List[str], bn_scopes: set) -> Optional[List[str]]:
    """torch module path pieces -> flax scope path pieces (no leaf)."""
    # join then apply segment-level rewrites
    path = ".".join(parts)
    path = path.replace(".seq.", ".")
    path = path.replace("branch_3x3.conv", "branch_3x3_conv")
    path = path.replace("branch_3x3.bn", "branch_3x3_bn")
    path = re.sub(r"bottlenecks\.(\d+)", r"bottleneck\1", path)
    path = re.sub(r"cls_convs\.\d+", "cls_conv", path)
    path = re.sub(r"reg_convs\.\d+", "reg_conv", path)

    # flame towers: numeric child is blockN unless it is the final conv —
    # decided by the caller (leaf-rank aware), marked with a placeholder here
    return path.split(".")


def convert_state_dict(
    sd: Dict[str, np.ndarray],
) -> Tuple[Dict[str, Any], Dict[str, Any], List[str]]:
    """Translate a normalized torch state dict into (params, batch_stats).

    Returns (params_tree, batch_stats_tree, notes) where notes lists folds and
    drops for the conversion report.
    """
    # scopes that are batch-norms: they own running stats
    bn_scopes = {k.rsplit(".", 1)[0] for k in sd if k.endswith(_BN_STATS[0])}
    notes: List[str] = []

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def insert(tree: Dict[str, Any], path: List[str], leaf: np.ndarray):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    alphas: Dict[str, np.ndarray] = {}

    for key, value in sd.items():
        scope, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        is_bn = scope in bn_scopes

        m = re.search(r"(bottleneck(?:s\.|)\d+)\.alpha$", key)
        if m and leaf == "alpha" and "flame" not in key:
            # CSP bottleneck residual-branch scale: fold into cv2 post_bn below
            alphas[scope] = value
            continue

        parts = _translate_segments(scope.split("."), bn_scopes)
        if parts is None:
            notes.append(f"dropped (unmapped): {key}")
            continue

        # flame tower numeric children: QARepVGG sub-blocks vs final 1x1 conv
        new_parts: List[str] = []
        for i, p in enumerate(parts):
            if p.isdigit() and i > 0 and parts[i - 1].startswith("flame_") and parts[i - 1].endswith("_pred"):
                # final conv has its weight/bias directly at this level
                is_final_conv = i == len(parts) - 1 and leaf in ("weight", "bias")
                new_parts.append("pred" if is_final_conv else f"block{p}")
            else:
                new_parts.append(p)
        parts = new_parts

        if leaf == "alpha":
            insert(params, parts + ["alpha"], np.asarray(value).reshape(()))
            continue
        if is_bn:
            if leaf == "weight":
                insert(params, parts + ["scale"], value)
            elif leaf == "bias":
                insert(params, parts + ["bias"], value)
            elif leaf == "running_mean":
                insert(stats, parts + ["mean"], value)
            elif leaf == "running_var":
                insert(stats, parts + ["var"], value)
            else:
                notes.append(f"dropped (unknown bn leaf): {key}")
            continue
        if leaf == "weight":
            if value.ndim == 4:
                if "upsample" in parts:
                    # torch ConvTranspose2d [I,O,kh,kw] -> flax [kh,kw,I,O]
                    # plus a spatial flip: flax ConvTranspose runs the kernel
                    # as correlation where torch's transposed conv places it
                    # flipped (verified exact in tests/test_convert.py)
                    kernel = np.ascontiguousarray(
                        np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
                    )
                else:
                    kernel = np.transpose(value, (2, 3, 1, 0))
            elif value.ndim == 2:
                kernel = np.transpose(value, (1, 0))
            else:
                notes.append(f"dropped (odd weight rank {value.ndim}): {key}")
                continue
            insert(params, parts + ["kernel"], kernel)
            continue
        if leaf == "bias":
            insert(params, parts + ["bias"], value)
            continue
        notes.append(f"dropped (unknown leaf): {key}")

    # fold bottleneck residual alphas: x + alpha*cv2(cv1(x)) == scale cv2's
    # output affine (post_bn in train layout, rbr_reparam bias/kernel in
    # deploy layout) by alpha
    for scope, alpha in alphas.items():
        a = float(np.asarray(alpha).reshape(()))
        parts = _translate_segments(scope.split("."), bn_scopes)
        node = params
        ok = True
        for p in parts:
            if p not in node:
                ok = False
                break
            node = node[p]
        if ok and "cv2" in node and "post_bn" in node["cv2"]:
            node["cv2"]["post_bn"]["scale"] = node["cv2"]["post_bn"]["scale"] * a
            node["cv2"]["post_bn"]["bias"] = node["cv2"]["post_bn"]["bias"] * a
            notes.append(f"folded {scope}.alpha={a:.6f} into cv2/post_bn")
        else:
            notes.append(f"UNFOLDED bottleneck alpha at {scope} (no cv2/post_bn)")
    return params, stats, notes


def convert(raw: Dict[str, Any], prefer_ema: bool = False) -> Tuple[Dict[str, Any], List[str]]:
    sd = normalize_state_dict(raw, prefer_ema=prefer_ema)
    params, stats, notes = convert_state_dict(sd)
    return {"params": params, "batch_stats": stats}, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="torch .pth/.pt checkpoint path")
    ap.add_argument("output", help="output flax msgpack path")
    ap.add_argument("--arch", default=None, help="validate against this preset's tree")
    ap.add_argument("--ema", action="store_true", help="prefer the EMA weights")
    args = ap.parse_args(argv)

    import torch

    from head_detector_tpu_torch.weights import save_variables

    try:
        raw = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a global that weights_only refuses
        # SG checkpoints are mostly plain tensor dicts; fall back to full
        # pickle loading only for the ones that are not, with a notice —
        # this CLI is an explicit user action on a checkpoint they chose.
        print("note: weights_only=True failed; falling back to full pickle load")
        raw = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    variables, notes = convert(raw if isinstance(raw, dict) else raw.state_dict(),
                               prefer_ema=args.ema)

    for n in notes:
        print("note:", n)

    if args.arch:
        from head_detector_tpu_torch.models import build_model
        from head_detector_tpu_torch.train.checkpoint import restore_key_matching

        target = build_model(args.arch, deploy=False).state_dict()
        _, matched, total = restore_key_matching(target, variables)
        print(f"key_matching vs {args.arch}: {matched}/{total} leaves matched")

    save_variables(variables, args.output)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
