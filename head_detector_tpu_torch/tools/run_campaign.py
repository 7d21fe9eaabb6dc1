"""Campaign runner: render the set if it is absent, then train a
configuration to its last epoch in chunks, one process and one log a chunk.

Counterpart of ``tools/run_campaign.sh``, which drives the JAX trainer.  Each
chunk runs ``python -m head_detector_tpu_torch.train --config-name CONFIG
training_hyperparams.resume=true`` (plus the overrides given) until the
configuration's ``epochs_per_run`` (one chunk when it is unset) and writes
``LOG_DIR/chunk_<n>.log``; a chunk whose log exists is taken as done, so a
run that was stopped picks up where it was.  The runner stops when a log
shows ``[epoch LAST] val``, when a chunk fails without the trainer's
``epochs_per_run`` marker (as the shell script does), when a chunk validates
no epoch after the last one validated (or, with no validation split, ends
without the marker), or when the next chunk would not fit in
``--time-budget-s``.

The shell script's ``nice -n 19`` and four-hour ``timeout`` chunks worked
round a leak of the TPU host relay (``flagship_campaign.yaml:13-15``) beside
one shared host core; the port has no relay, so they are left out (a budget
bounds each chunk instead).

The set: where ``dataset_params.data_dir`` lacks a split of the
configuration, ``tools/render_synthetic_dataset`` renders it in this process
(``train`` from seed 0, ``val`` from seed 1, as README's commands do), from
the first missing scene on.

Usage::

    python -m head_detector_tpu_torch.tools.run_campaign --config-name flagship_r4 \\
        --data-dir runs/synth512 --log-dir runs/campaign_logs [--last-epoch 11] \\
        [--train-count 16384 --val-count 512 --min-visibility 0.5] \\
        [--time-budget-s 3000] [--device cpu] [key=value ...]
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAX_CHUNKS = 32


def _scenes_on_disk(split_dir: str) -> int:
    """Scenes ``0..n-1`` whose image and annotation both exist."""
    n = 0
    while (os.path.isfile(os.path.join(split_dir, "annotations", f"{n:06d}.npz"))
           and os.path.isfile(os.path.join(split_dir, "images", f"{n:06d}.jpg"))):
        n += 1
    return n


def render_absent(data_dir: str, splits: Sequence[str], counts: dict, image_size: int,
                  min_visibility: float, device, print_fn=print) -> dict:
    """Render what ``data_dir`` lacks of ``splits`` (``counts[split]``
    scenes each, ``train`` from seed 0, anything else from seed 1); returns
    {split: {"scenes", "heads", "seconds"}} of what was rendered."""
    from head_detector_tpu_torch.tools.render_synthetic_dataset import render_split

    done = {}
    for split in splits:
        have = _scenes_on_disk(os.path.join(data_dir, split))
        if have >= counts[split]:
            continue
        print_fn(f"[campaign] rendering {split}: scenes {have}..{counts[split] - 1} at "
                 f"{image_size} px into {data_dir}")
        done[split] = render_split(data_dir, split, counts[split], image_size,
                                   seed=0 if split == "train" else 1, start=have,
                                   min_visibility=min_visibility, device=device)
        print_fn(f"[campaign] {split}: {done[split]}")
    return done


def _val_epochs(text: str) -> List[int]:
    return [int(e) for e in re.findall(r"\[epoch (\d+)\] val", text)]


def run_campaign(config_name: str = "flagship_campaign", log_dir: str = "runs/campaign_logs",
                 last_epoch: Optional[int] = None, data_dir: Optional[str] = None,
                 train_count: int = 16384, val_count: int = 512,
                 min_visibility: float = 0.25, overrides: Sequence[str] = (),
                 device: str = "cuda", time_budget_s: Optional[float] = None,
                 print_fn=print) -> dict:
    """Render what is absent, then run the chunks (module docstring).
    Returns the rendering, each chunk's exit code, seconds and validated
    epochs, why the runner stopped, and the data and checkpoint directories."""
    from head_detector_tpu_torch.config import CONFIG_DIR, load_config, run_config_from_dict

    t_start = time.perf_counter()
    overrides = list(overrides)
    if data_dir is not None:
        overrides.append(f"dataset_params.data_dir={os.path.abspath(data_dir)}")
    cfg = load_config(os.path.join(CONFIG_DIR, f"{config_name}.yaml"), overrides)
    run_cfg = run_config_from_dict(cfg)
    ds_cfg = cfg.get("dataset_params", {})
    data_dir = ds_cfg.get("data_dir")
    last = run_cfg.max_epochs - 1 if last_epoch is None else last_epoch
    out = {"config": config_name, "data_dir": data_dir, "ckpt_dir": run_cfg.ckpt_dir,
           "log_dir": log_dir, "last_epoch": last, "rendered": {}, "chunks": []}
    if data_dir:
        splits = list(ds_cfg.get("train_splits", ["train"])) + list(ds_cfg.get("val_splits", []))
        counts = {s: train_count if s == "train" else val_count for s in splits}
        out["rendered"] = render_absent(data_dir, splits, counts,
                                        int(ds_cfg.get("image_size", 640)), min_visibility,
                                        device, print_fn)
    os.makedirs(log_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "head_detector_tpu_torch.train", "--config-name", config_name,
           "--device", str(device), "training_hyperparams.resume=true", *overrides]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    out["stopped"] = "max_chunks"
    longest, reached = 0.0, -1
    for chunk in range(MAX_CHUNKS):
        log = os.path.join(log_dir, f"chunk_{chunk}.log")
        if os.path.isfile(log) and os.path.getsize(log):
            with open(log) as f:
                if last in _val_epochs(f.read()):
                    out["stopped"] = "complete"
                    break
            continue  # done by an earlier run
        remaining = None
        if time_budget_s is not None:
            remaining = time_budget_s - (time.perf_counter() - t_start)
            if remaining < longest or remaining <= 0:
                out["stopped"] = "budget"
                break
        print_fn(f"[campaign] chunk {chunk} start")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            try:
                rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                                    timeout=remaining).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        seconds = time.perf_counter() - t0
        longest = max(longest, seconds)
        with open(log) as f:
            text = f.read()
        epochs = _val_epochs(text)
        out["chunks"].append({"chunk": chunk, "rc": rc, "seconds": seconds, "epochs": epochs})
        print_fn(f"[campaign] chunk {chunk} exit {rc} after {seconds:.1f} s, validated "
                 f"epochs {epochs}")
        if last in epochs:
            out["stopped"] = "complete"
            break
        if rc != 0 and "epochs_per_run" not in text:
            out["stopped"] = "failed"
            print_fn(f"[campaign] chunk {chunk} failed without a progress marker; "
                     f"stopping. Its log ends:\n{text[-2000:]}")
            break
        # progress: a new epoch validated, or (no validation split) the marker
        if max(epochs, default=-1) <= reached and (epochs or "epochs_per_run" not in text):
            out["stopped"] = "no_progress"
            break
        reached = max(epochs, default=reached)
    out["seconds"] = time.perf_counter() - t_start
    print_fn(f"[campaign] stopped ({out['stopped']}) after {out['seconds']:.1f} s")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-name", default="flagship_campaign")
    ap.add_argument("--log-dir", default="runs/campaign_logs")
    ap.add_argument("--last-epoch", type=int, default=None,
                    help="stop once this epoch is validated (default: the config's last)")
    ap.add_argument("--data-dir", default=None, help="overrides dataset_params.data_dir")
    ap.add_argument("--train-count", type=int, default=16384)
    ap.add_argument("--val-count", type=int, default=512)
    ap.add_argument("--min-visibility", type=float, default=0.25)
    ap.add_argument("--time-budget-s", type=float, default=None,
                    help="start no chunk that would end after this many seconds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value passed to every chunk")
    args = ap.parse_args(argv)
    out = run_campaign(args.config_name, args.log_dir, args.last_epoch, args.data_dir,
                       args.train_count, args.val_count, args.min_visibility, args.overrides,
                       args.device, args.time_budget_s)
    if out["stopped"] == "failed":
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
