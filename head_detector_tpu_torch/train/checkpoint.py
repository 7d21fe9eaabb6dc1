"""Checkpoint / resume / transfer-learning restore.

Counterpart of ``head_detector_tpu/train/checkpoint.py`` with the same API
and semantics, stored with ``torch.save`` (one ``{step}/state.pt`` per
save) instead of orbax:

* :class:`CheckpointManager` — save / restore of the full train state
  (parameters, BatchNorm statistics, EMA, optimizer state, step), the
  latest ``max_to_keep`` steps on disk, best-by-``metric_to_watch``
  (``best.json``) and a per-save ``metrics.jsonl`` history with
  :meth:`~CheckpointManager.best_steps` (the ``average_best_models`` set);
* :func:`average_trees` — the uniform leaf-wise average of weight trees;
* :func:`restore_key_matching` — name-and-shape intersection restore (the
  ``strict_load: key_matching`` warm start) from a port state dict or from
  the flax ``{params, batch_stats}`` tree that ``weights.load_variables``
  reads.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from head_detector_tpu_torch.weights import train_state_dict_from_flax

_STATE_FILE = "state.pt"


class CheckpointManager:
    """Step directories under ``ckpt_dir`` with best-metric bookkeeping."""

    def __init__(self, ckpt_dir: str, metric_to_watch: str = "KeypointsNME",
                 greater_is_better: bool = False, max_to_keep: int = 10):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.metric_to_watch = metric_to_watch
        self.greater_is_better = greater_is_better
        self.max_to_keep = max_to_keep
        self._best_path = os.path.join(self.ckpt_dir, "best.json")
        self._history_path = os.path.join(self.ckpt_dir, "metrics.jsonl")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, str(int(step)))

    def all_steps(self) -> list:
        """Steps with a complete checkpoint on disk, ascending."""
        steps = []
        for name in os.listdir(self.ckpt_dir):
            if name.isdigit() and os.path.isfile(os.path.join(self.ckpt_dir, name, _STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def save(self, step: int, tree: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None) -> None:
        step_dir = self._step_dir(step)
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, _STATE_FILE + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(step_dir, _STATE_FILE))
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if metrics:
            with open(self._history_path, "a") as f:
                json.dump({"step": int(step),
                           **{k: float(v) for k, v in metrics.items()}}, f)
                f.write("\n")
        if metrics and self.metric_to_watch in metrics:
            value = float(metrics[self.metric_to_watch])
            best = self.best_metric()
            improved = best is None or (
                value > best if self.greater_is_better else value < best)
            if improved:
                with open(self._best_path, "w") as f:
                    json.dump({"step": int(step), "value": value}, f)

    def best_metric(self) -> Optional[float]:
        if os.path.isfile(self._best_path):
            with open(self._best_path) as f:
                return float(json.load(f)["value"])
        return None

    def best_step(self) -> Optional[int]:
        if os.path.isfile(self._best_path):
            with open(self._best_path) as f:
                return int(json.load(f)["step"])
        return None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics_history(self) -> list:
        """Per-save metric records ``[{"step": s, <metric>: v, ...}, ...]``;
        a truncated record (a kill mid-append) is skipped."""
        if not os.path.isfile(self._history_path):
            return []
        out = []
        with open(self._history_path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return out

    def best_steps(self, k: int) -> list:
        """The up-to-k best on-disk steps by ``metric_to_watch``; non-finite
        values (a diverged epoch) are excluded, and a step logged twice (a
        resumed epoch) keeps its last record."""
        on_disk = set(self.all_steps())
        recs = [r for r in self.metrics_history()
                if r.get("step") in on_disk
                and np.isfinite(r.get(self.metric_to_watch, np.nan))]
        by_step = {r["step"]: r[self.metric_to_watch] for r in recs}
        ranked = sorted(by_step, key=lambda s: by_step[s], reverse=self.greater_is_better)
        return ranked[:k]

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The tree saved at ``step`` (the latest by default), on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.ckpt_dir}")
        return torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                          map_location="cpu", weights_only=True)


def average_trees(trees: list):
    """Uniform leaf-wise average of nested dicts of tensors, as checkpoints
    hold them (SG ModelWeightAveraging), in float64; every other leaf (step
    counts, integer buffers) takes the first tree's value."""
    if not trees:
        raise ValueError("average_trees needs at least one tree")
    first = trees[0]
    if isinstance(first, dict):
        return {k: average_trees([t[k] for t in trees]) for k in first}
    if not (isinstance(first, torch.Tensor) and first.is_floating_point()):
        return first
    acc = torch.zeros(first.shape, dtype=torch.float64)
    for leaf in trees:
        acc += leaf.detach().cpu().to(torch.float64)
    return (acc / len(trees)).to(first.dtype)


def _counted(key: str) -> bool:
    # num_batches_tracked has no flax counterpart and is never read
    return not key.endswith("num_batches_tracked")


def restore_key_matching(
    target: Dict[str, torch.Tensor], source: Dict[str, Any]
) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Copy entries of ``source`` into the state dict ``target`` wherever the
    key and the shape match (the ``strict_load: key_matching`` semantics).
    ``source`` is a port state dict, a port checkpoint tree (``params`` and
    ``batch_stats`` of such keys), or a flax ``{params, batch_stats}`` tree of
    arrays (converted leaf by leaf with ``weights.train_state_dict_from_flax``).
    Values take the target's dtype and device.  Returns (merged state dict,
    matched count, total target entries), ``num_batches_tracked`` not counted."""
    if "params" in source and isinstance(source["params"], dict):
        params = source["params"]
        if params and all(isinstance(v, torch.Tensor) for v in params.values()):
            flat = {**params, **source.get("batch_stats", {})}
        else:
            flat, _ = train_state_dict_from_flax(source)
    else:
        flat = source
    merged, matched, total = {}, 0, 0
    for key, leaf in target.items():
        cand = flat.get(key)
        counted = _counted(key)
        total += counted
        if cand is not None and tuple(cand.shape) == tuple(leaf.shape):
            merged[key] = torch.as_tensor(cand).to(device=leaf.device, dtype=leaf.dtype)
            matched += counted
        else:
            merged[key] = leaf
    return merged, matched, total
