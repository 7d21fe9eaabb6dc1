"""YAML config system: composition + interpolation + CLI overrides.

Counterpart of ``head_detector_tpu/config.py``: a ``defaults`` list composes
sub-configs, ``${a.b}`` interpolates values, and command-line dot-overrides
(``training_hyperparams.initial_lr=1e-4``) patch the tree; then the composed
dict maps onto the port's typed Run/Loss/Train configs.  The config files
are the JAX package's, read by path (``CONFIG_DIR``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Optional

import yaml

from head_detector_tpu_torch.train.loss import LossConfig
from head_detector_tpu_torch.train.runner import RunConfig
from head_detector_tpu_torch.train.trainer import TrainConfig

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "head_detector_tpu", "configs")

_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _lookup(tree: Dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def _interpolate(node: Any, root: Dict) -> Any:
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:
            return _interpolate(_lookup(root, m.group(1)), root)
    return node


def load_config(path: str, overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """Load a YAML config, composing its ``defaults`` list (group/name entries
    resolve to ``{config_dir}/{group}/{name}.yaml``), applying ``key=value``
    dot-overrides, then resolving ``${...}`` interpolations."""
    path = os.path.abspath(path)
    config_dir = os.path.dirname(path)
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    merged: Dict[str, Any] = {}
    for entry in cfg.pop("defaults", []) or []:
        if entry in ("_self_",):
            merged = _deep_merge(merged, cfg)
            cfg = {}
            continue
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            sub_path = os.path.join(config_dir, group, f"{name}.yaml")
            sub = load_config(sub_path)
            merged = _deep_merge(merged, {group: sub})
        else:
            sub_path = os.path.join(config_dir, f"{entry}.yaml")
            merged = _deep_merge(merged, load_config(sub_path))
    merged = _deep_merge(merged, cfg)

    for ov in overrides or []:
        key, _, value = ov.partition("=")
        parsed = yaml.safe_load(value)
        # YAML 1.1 reads "1e-4" as a string; accept scientific notation
        if isinstance(parsed, str) and re.match(
            r"^-?\d+(\.\d+)?[eE][-+]?\d+$", parsed
        ):
            parsed = float(parsed)
        node = merged
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = parsed

    return _interpolate(merged, merged)


def _filtered_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def run_config_from_dict(cfg: Dict[str, Any]) -> RunConfig:
    """Map a composed config dict (reference knob names) onto RunConfig."""
    hp = cfg.get("training_hyperparams", {})
    crit = hp.get("criterion_params", {})
    opt = hp.get("optimizer_params", {})
    ema = hp.get("ema_params", {})

    loss = LossConfig(**_filtered_kwargs(LossConfig, crit))
    if isinstance(crit.get("indexes_subset"), str):
        from head_detector_tpu_torch.assets_io import get_indices

        loss = dataclasses.replace(
            loss, indexes_subset=get_indices()[crit["indexes_subset"]]
        )

    train = TrainConfig(
        initial_lr=hp.get("initial_lr", 3e-4),
        cosine_final_lr_ratio=hp.get("cosine_final_lr_ratio", 0.1),
        warmup_initial_lr=hp.get("warmup_initial_lr", 1e-6),
        lr_warmup_steps=hp.get("lr_warmup_steps", 128),
        weight_decay=opt.get("weight_decay", 1e-6),
        zero_weight_decay_on_bias_and_bn=hp.get(
            "zero_weight_decay_on_bias_and_bn", True
        ),
        ema=hp.get("ema", True),
        ema_decay=ema.get("decay", 0.9997),
        ema_beta=ema.get("beta", 50.0),
    )

    ds = cfg.get("dataset_params", {})
    run_kwargs = dict(
        arch=cfg.get("architecture", cfg.get("arch", "yolo_heads_l")),
        image_size=ds.get("image_size", 640),
        batch_size=ds.get("batch_size", 8),
        max_gt_boxes=ds.get("max_gt_boxes", 30),
        num_workers=ds.get("num_workers", 4),
        max_epochs=hp.get("max_epochs", 50),
        epochs_per_run=hp.get("epochs_per_run"),
        ckpt_max_to_keep=hp.get("ckpt_max_to_keep", 10),
        mixed_precision=hp.get("mixed_precision", True),
        ckpt_dir=cfg.get("ckpt_root_dir", "checkpoints")
        + "/"
        + str(cfg.get("experiment_name", "run")),
        resume=hp.get("resume", False),
        metric_to_watch=hp.get("metric_to_watch", "KeypointsNME"),
        greater_metric_to_watch_is_better=hp.get(
            "greater_metric_to_watch_is_better", False
        ),
        loss=loss,
        train=train,
    )
    run_kwargs.update(_filtered_kwargs(RunConfig, cfg))
    # don't let the raw dicts leak over typed fields
    run_kwargs["loss"] = loss
    run_kwargs["train"] = train
    return RunConfig(**run_kwargs)
