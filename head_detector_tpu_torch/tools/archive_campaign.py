"""Copy a campaign's record into ``campaigns/<name>/``, which git keeps.

Counterpart of ``tools/archive_campaign.sh``: the run's ``metrics.jsonl``
and ``best.json`` (its checkpoint directory) and the logs given (the
chunk logs of ``run_campaign``, the finish step's logs) go into ``DEST/NAME``, so that
the curve behind a published number outlives the git-ignored ``runs/``
tree.  ``tools/campaign_report.py`` reads the archived chunk logs as they
are.

Usage::

    python -m head_detector_tpu_torch.tools.archive_campaign runs/campaign/flagship_r4 \\
        [--name flagship_torch_r1] [--dest campaigns] --logs runs/campaign_logs/*.log
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def archive_campaign(run_dir: str, name: Optional[str] = None, dest: Optional[str] = None,
                     logs: Sequence[str] = (), print_fn=print) -> str:
    """Copy the record (module docstring); returns the archive directory."""
    target = os.path.join(dest or os.path.join(REPO, "campaigns"),
                          name or os.path.basename(os.path.normpath(run_dir)))
    os.makedirs(target, exist_ok=True)
    files = [os.path.join(run_dir, f) for f in ("metrics.jsonl", "best.json")]
    for path in files + list(logs):
        if os.path.isfile(path):
            shutil.copy(path, os.path.join(target, os.path.basename(path)))
    print_fn(f"[archive] {target}: {sorted(os.listdir(target))}")
    return target


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="the campaign's checkpoint directory")
    ap.add_argument("--name", default=None, help="default: the run directory's name")
    ap.add_argument("--dest", default=None, help="default: the repository's campaigns/")
    ap.add_argument("--logs", nargs="*", default=[])
    args = ap.parse_args(argv)
    return archive_campaign(args.run_dir, args.name, args.dest, args.logs)


if __name__ == "__main__":
    main()
