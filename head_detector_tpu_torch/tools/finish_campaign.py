"""End of a campaign: score the best step and the average of the best N on
the validation split, export their EMA weights, and run the protocols.

Counterpart of ``tools/finish_campaign.sh:17-29`` (which drives the JAX
package's tools):

1. the best step of ``best.json``, EMA weights, through
   ``tools/eval_checkpoint`` on the on-disk validation split, exported as
   ``OUT/best_ema.msgpack`` (log ``eval_best.log``);
2. the average of the best N steps by the watched metric
   (``eval_checkpoint --average-best N``), exported as
   ``OUT/avg<N>_ema.msgpack`` (log ``eval_avg<N>.log``);
3. where the DAD and FDDB stand-ins are given, ``tools/run_protocols`` on the
   best export (``protocols.json``, log ``protocols.log``).

The shell script's last step runs ``bench.py``'s loaded modes with the
campaign's checkpoint; the port's benchmark is a later piece of work, so
that step is not here yet.

Usage::

    python -m head_detector_tpu_torch.tools.finish_campaign --ckpt-dir runs/campaign/flagship_r4 \\
        --data-dir runs/synth512 [--arch yolo_heads_m --image-size 512] \\
        [--average-best 10] [--out runs/finish_campaign] \\
        [--dad-json D/dataset.json --dad-base D --fddb-dir F] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Optional


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


@contextlib.contextmanager
def tee_to(path: str):
    """Print to the console and to ``path``."""
    with open(path, "w") as f, contextlib.redirect_stdout(_Tee(sys.stdout, f)):
        yield


def finish_campaign(ckpt_dir: str, data_dir: str, arch: str = "yolo_heads_m",
                    image_size: int = 512, out: str = "runs/finish_campaign",
                    average_best: int = 10, dad_json: Optional[str] = None,
                    dad_base: Optional[str] = None, fddb_dir: Optional[str] = None,
                    device: str = "cuda") -> dict:
    """The steps of the module docstring; returns each step's metrics and
    the paths of the exports."""
    from head_detector_tpu_torch.tools import eval_checkpoint, run_protocols

    os.makedirs(out, exist_ok=True)
    with open(os.path.join(ckpt_dir, "best.json")) as f:
        best = json.load(f)
    common = ["--ckpt-dir", ckpt_dir, "--arch", arch, "--image-size", str(image_size),
              "--data-dir", data_dir, "--which", "ema", "--device", str(device)]
    result = {"best_step": int(best["step"])}
    best_export = os.path.join(out, "best_ema.msgpack")
    with tee_to(os.path.join(out, "eval_best.log")):
        print(f"=== best single checkpoint (step {best['step']}), EMA, on-disk val split ===")
        result["best"] = eval_checkpoint.main(
            common + ["--step", str(best["step"]), "--export-msgpack", best_export])["ema"]
    avg_export = os.path.join(out, f"avg{average_best}_ema.msgpack")
    with tee_to(os.path.join(out, f"eval_avg{average_best}.log")):
        print(f"=== average of the best {average_best} checkpoints by the watched metric ===")
        result["average"] = eval_checkpoint.main(
            common + ["--average-best", str(average_best), "--export-msgpack", avg_export])["ema"]
    result["exports"] = [best_export, avg_export]
    if dad_json and fddb_dir:
        with tee_to(os.path.join(out, "protocols.log")):
            print("=== DAD and FDDB protocols on the best export ===")
            result["protocols"] = run_protocols.main(
                ["--checkpoint", best_export, "--arch", arch, "--image-size", str(image_size),
                 "--dad-json", dad_json, "--dad-base", dad_base or os.path.dirname(dad_json),
                 "--fddb-dir", fddb_dir, "--out", os.path.join(out, "protocols.json"),
                 "--device", str(device)])
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--arch", default="yolo_heads_m")
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--out", default="runs/finish_campaign")
    ap.add_argument("--average-best", type=int, default=10)
    ap.add_argument("--dad-json", default=None)
    ap.add_argument("--dad-base", default=None)
    ap.add_argument("--fddb-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return finish_campaign(args.ckpt_dir, args.data_dir, args.arch, args.image_size, args.out,
                           args.average_best, args.dad_json, args.dad_base, args.fddb_dir,
                           args.device)


if __name__ == "__main__":
    main()
