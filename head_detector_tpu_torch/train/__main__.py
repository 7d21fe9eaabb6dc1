"""Training entry point of the port.

Usage::

    python -m head_detector_tpu_torch.train --config-name flagship_campaign \
        dataset_params.data_dir=DIR \
        pretrained_weights=checkpoints/flagship_ema.msgpack

    python -m head_detector_tpu_torch.train --config-name yolo_heads_m \
        dataset_params.render=true

The flags are the JAX entry point's (``--config-name``, ``--config-dir``,
``key=value`` dot overrides) plus ``--device`` (default ``cuda``: without a
card it raises; ``--device cpu`` runs the plain versions of the kernels).

With ``dataset_params.data_dir`` the loop reads the on-disk VGGHeads layout
(``head_detector_tpu_torch.tools.render_synthetic_dataset`` writes one):
with ``params_wire`` the ``RenderedHeadsDataset`` ships DAD parameters that
the step decodes on the card, augmented by ``ConformalAugs`` and
``PhotometricAugs``; without it the dense ``DAD3DHeadsDataset`` decodes on
the host behind ``default_train_transforms``.  Validation reads
``val_splits`` with the dense reader, cached after its first pass.  Without
``data_dir`` the procedural ``SyntheticHeadsDataset`` drives the loop
(``render=true`` draws every scene with the port's rasterizer).

Several cards (data parallelism, one process a rank, ``distributed.py``):
under ``torchrun --nproc-per-node N -m head_detector_tpu_torch.train ...``
(``RANK`` and ``WORLD_SIZE`` set) each process joins that world on card
``LOCAL_RANK``; otherwise the entry point spawns the JAX package's rule over
the visible cards, ``data_world(batch_size, torch.cuda.device_count())``
ranks, NCCL, one card each (one card: one rank, in this process).
:func:`run_data_parallel` asks for a world explicitly (two gloo ranks on one
card, say) and returns each rank's summary.  The global ``batch_size``
splits over the ranks; the result equals the one-rank run's.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import os
import sys
import time
from typing import List, Optional, Sequence

import torch

from head_detector_tpu_torch import distributed
from head_detector_tpu_torch.config import CONFIG_DIR, load_config, run_config_from_dict


class _CachedDataset:
    """In-memory sample cache for a deterministic (validation) dataset: the
    first pass's host decode is reused by every later validation."""

    def __init__(self, dataset):
        self.dataset = dataset
        self._cache = {}

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        if index not in self._cache:
            self._cache[index] = self.dataset[index]
        return self._cache[index]


def _disk_datasets(ds_cfg, image_size: int):
    # the training readers key their random draws by sample (SampleDraws):
    # a sample does not depend on the loader thread or the rank.
    # ``keyed_draws: false`` draws the photometric augmentations from
    # PhotometricAugs' own shared stream instead, as the JAX reader does
    # (the conformal draws stay keyed); one rank only, and not reproducible
    from head_detector_tpu_torch.train.dataset import DAD3DHeadsDataset
    from head_detector_tpu_torch.train.transforms import (
        PhotometricAugs,
        default_train_transforms,
        default_val_transforms,
    )

    data_dir = ds_cfg["data_dir"]
    keyed_draws = bool(ds_cfg.get("keyed_draws", True))
    val_splits = ds_cfg.get("val_splits")
    if ds_cfg.get("params_wire"):
        from head_detector_tpu_torch.train.param_wire import ConformalAugs, RenderedHeadsDataset

        train_ds = RenderedHeadsDataset(data_dir, splits=ds_cfg.get("train_splits"),
                                        augs=ConformalAugs(image_size),
                                        photometric=PhotometricAugs(), keyed_draws=keyed_draws)
    else:
        train_ds = DAD3DHeadsDataset(data_dir, splits=ds_cfg.get("train_splits"),
                                     transforms=default_train_transforms(image_size),
                                     photometric=PhotometricAugs(), keyed_draws=keyed_draws)
    val_ds = (_CachedDataset(DAD3DHeadsDataset(
        data_dir, splits=val_splits, transforms=default_val_transforms(image_size)))
        if val_splits else None)
    return train_ds, val_ds


def _parse(argv):
    """(args, the config dict, its ``RunConfig``) of ``argv``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-name", default="yolo_heads_l")
    ap.add_argument("--config-dir", default=CONFIG_DIR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value dot overrides")
    args = ap.parse_args(argv)
    cfg = load_config(os.path.join(args.config_dir, f"{args.config_name}.yaml"),
                      args.overrides)
    return args, cfg, run_config_from_dict(cfg)


def build_trainer(argv=None, group=None, device=None):
    """The ``Trainer`` (and its datasets) that ``main`` runs for ``argv``;
    with ``group``, one rank of a data-parallel run on ``device`` (which
    then stands for ``--device``)."""
    args, cfg, run_cfg = _parse(argv)
    ds_cfg = cfg.get("dataset_params", {})

    from head_detector_tpu_torch.device import resolve_device
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.train.runner import Trainer

    device = resolve_device(args.device if device is None else device)
    image_size = ds_cfg.get("image_size", 640)
    if ds_cfg.get("data_dir"):
        train_ds, val_ds = _disk_datasets(ds_cfg, image_size)
    else:
        from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset

        common = dict(flame_model=FlameModel.from_assets(device=device), image_size=image_size,
                      max_heads=int(ds_cfg.get("max_heads", 3)),
                      render=bool(ds_cfg.get("render", False)), device=device)
        train_ds = SyntheticHeadsDataset(length=int(ds_cfg.get("train_length", 256)), **common)
        val_ds = SyntheticHeadsDataset(length=int(ds_cfg.get("val_length", 32)), seed=1,
                                       **common)
    return Trainer(run_cfg, train_ds, val_dataset=val_ds, device=device, group=group)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(trainer, n: int, epoch: int = 0) -> List[float]:
    """Host ms of ``n`` more steps of ``trainer``, each alone (synchronised),
    on this rank's rows of the first ``n`` batches of ``epoch`` (in turn,
    again from the first where the epoch has fewer), images and targets
    uploaded before the clock starts."""
    batches = []
    for images, targets in trainer.train_loader(epoch):
        batches.append((torch.as_tensor(images).to(trainer.device),
                        targets.to(trainer.device)))
        if len(batches) == n:
            break
    ms = []
    for i in range(n):
        images, targets = batches[i % len(batches)]
        _synchronize(trainer.device)
        t0 = time.perf_counter()
        trainer.step_fn(trainer.state, images, targets)
        _synchronize(trainer.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def state_digest(state) -> str:
    """sha256 of a ``TrainState``'s parameters, BatchNorm statistics and
    EMA, in name order: equal digests are bit-equal replicas."""
    h = hashlib.sha256()
    for tree in (state.params(), state.batch_stats(), state.ema):
        for name in sorted(tree):
            h.update(name.encode())
            h.update(tree[name].detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _train_rank(rank: int, world: int, device: torch.device, group, runs: list,
                options: dict) -> List[dict]:
    """One rank of :func:`run_data_parallel`: each run in turn through
    ``build_trainer`` and ``train``, with the rasterizer's launch counts
    zeroed before each; a summary of each, on the CPU."""
    from head_detector_tpu_torch.models import presets
    from head_detector_tpu_torch.ops import rasterize as r

    presets.PRESETS.update(options.get("presets", {}))
    out = []
    for argv, run_options in runs:
        opts = {**options, **run_options}
        r.rasterize_zbuffer_cuda.launches = 0
        r.pncc_render_cuda.launches = 0
        trainer = build_trainer(argv, group=group, device=device)
        first_epoch = trainer.state.step // trainer.steps_per_epoch
        summary = {"rank": rank, "world": world, "device": str(device)}
        if opts.get("first_batch"):
            summary["first_batch"] = next(iter(trainer.train_loader(first_epoch)))
        metrics = trainer.train()
        _synchronize(device)
        summary.update(
            step=trainer.state.step, metrics=metrics, history=trainer.history,
            timings=trainer.timings, digest=state_digest(trainer.state),
            components=[{k: float(v) for k, v in c.items()} for c in trainer.step_components],
            launches={"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                      "pncc_render": r.pncc_render_cuda.launches})
        if opts.get("return_state"):
            state = trainer.state
            summary["state"] = distributed.to_cpu({
                "params": state.params(), "batch_stats": state.batch_stats(),
                "ema_params": state.ema,
                "grads": {n: p.grad for n, p in trainer.model.named_parameters()
                          if p.grad is not None}})
        if opts.get("validate"):  # at the weights returned above
            summary["validation"] = trainer.validate()
        if opts.get("timed_steps"):
            summary["step_ms"] = time_steps(trainer, int(opts["timed_steps"]), first_epoch)
        out.append(summary)
    return out


def run_data_parallel(argv, world: int, devices: Sequence, backend: Optional[str] = None,
                      timeout_s: float = distributed.DEFAULT_TIMEOUT_S,
                      **options) -> List[List[dict]]:
    """Train ``argv`` (the entry point's flags; ``--device`` is replaced by
    each rank's) with ``world`` ranks on ``devices`` (``distributed.spawn``:
    NCCL on distinct cards, else ``backend="gloo"``) and return, by rank, a
    summary of each run: the step, metrics, history, timings, loss
    components, a digest of the state (:func:`state_digest`), the
    rasterizer's launches in that rank.  ``argv`` may be a list of runs, run
    in turn by the same ranks, each an argv or an ``(argv, options)`` pair.
    Options: ``return_state`` (the parameters, BatchNorm statistics, EMA and
    last gradients), ``first_batch`` (the rank's rows of its first batch),
    ``timed_steps`` (ms of that many more steps, :func:`time_steps`),
    ``validate`` (``validate()`` at the end), ``presets`` (more
    architectures the ranks know by name)."""
    if argv and isinstance(argv[0], str):
        argv = [argv]
    runs = [(list(a), {}) if isinstance(a[0], str) else (list(a[0]), dict(a[1])) for a in argv]
    # by the module's package name: under ``python -m`` this module is
    # ``__main__``, which the ranks would not import
    entry = importlib.import_module("head_detector_tpu_torch.train.__main__")
    return distributed.spawn(entry._train_rank, world, devices, backend, args=(runs, options),
                             timeout_s=timeout_s)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args, _, run_cfg = _parse(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        group, device = distributed.init_from_env(args.device)
        try:
            metrics = build_trainer(argv, group=group, device=device).train()
        finally:
            distributed.destroy()
        if int(os.environ["RANK"]):
            return metrics
    else:
        from head_detector_tpu_torch.device import resolve_device

        device = resolve_device(args.device)
        world = (distributed.data_world(run_cfg.batch_size, torch.cuda.device_count())
                 if device.type == "cuda" else 1)
        if world > 1:
            metrics = run_data_parallel(argv, world, [f"cuda:{i}" for i in range(world)],
                                        "nccl")[0][0]["metrics"]
        else:
            metrics = build_trainer(argv).train()
    print(f"[train] final metrics: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
