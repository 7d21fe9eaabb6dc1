"""Training entry point of the port.

Usage::

    python -m head_detector_tpu_torch.train --config-name yolo_heads_m \
        dataset_params.render=true \
        pretrained_weights=checkpoints/flagship_ema.msgpack

The flags are the JAX entry point's (``--config-name``, ``--config-dir``,
``key=value`` dot overrides) plus ``--device`` (default ``cuda``: without a
card it raises; ``--device cpu`` runs the plain versions of the kernels).
The synthetic procedural dataset drives the loop (``render=true`` draws
every scene with the port's rasterizer); ``dataset_params.data_dir`` (the
on-disk VGGHeads reader) is not ported.
"""

from __future__ import annotations

import argparse
import os

from head_detector_tpu_torch.config import CONFIG_DIR, load_config, run_config_from_dict


def build_trainer(argv=None):
    """The ``Trainer`` (and its datasets) that ``main`` runs for ``argv``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-name", default="yolo_heads_l")
    ap.add_argument("--config-dir", default=CONFIG_DIR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value dot overrides")
    args = ap.parse_args(argv)

    cfg = load_config(os.path.join(args.config_dir, f"{args.config_name}.yaml"),
                      args.overrides)
    run_cfg = run_config_from_dict(cfg)
    ds_cfg = cfg.get("dataset_params", {})
    if ds_cfg.get("data_dir"):
        raise NotImplementedError(
            "dataset_params.data_dir: the on-disk VGGHeads reader is not ported; "
            "leave it unset to train on the synthetic dataset")

    from head_detector_tpu_torch.device import resolve_device
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset
    from head_detector_tpu_torch.train.runner import Trainer

    device = resolve_device(args.device)
    flame_model = FlameModel.from_assets(device=device)
    image_size = ds_cfg.get("image_size", 640)
    common = dict(flame_model=flame_model, image_size=image_size,
                  max_heads=int(ds_cfg.get("max_heads", 3)),
                  render=bool(ds_cfg.get("render", False)), device=device)
    train_ds = SyntheticHeadsDataset(length=int(ds_cfg.get("train_length", 256)), **common)
    val_ds = SyntheticHeadsDataset(length=int(ds_cfg.get("val_length", 32)), seed=1, **common)

    return Trainer(run_cfg, train_ds, val_dataset=val_ds, device=device)


def main(argv=None):
    metrics = build_trainer(argv).train()
    print(f"[train] final metrics: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
