"""Convert a rendered VGGHeads-layout split into FDDB layout for
``evaluation/evaluate_fddb.py``: ``label.txt`` with '# path' headers and
``x y x1 y1`` box lines, and the images under ``images/``.

The port's copy of ``tools/make_fddb_standin.py``.  Channel convention: the
training pipeline reads renders with raw ``cv2.imread`` (array ch0 =
NCC-x), while the eval CLIs convert BGR->RGB before the predictor.  Images
are therefore re-written channel-swapped so that imread + BGR2RGB
reproduces exactly the arrays the checkpoint was trained on.

Usage::

    python -m head_detector_tpu_torch.tools.make_fddb_standin \\
        --src runs/synth512 --split val --out runs/fddb_standin
"""

from __future__ import annotations

import argparse
import glob
import os

import cv2
import numpy as np


def make_fddb_standin(src: str, out: str, split: str = "val", limit: int = 256) -> int:
    """Write the first ``limit`` images of ``src/split`` to ``out``; returns
    how many."""
    img_dir = os.path.join(src, split, "images")
    ann_dir = os.path.join(src, split, "annotations")
    out_img = os.path.join(out, "images")
    os.makedirs(out_img, exist_ok=True)

    lines = []
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(img_dir, "*.jpg")))[:limit]
    for name in names:
        stem = os.path.splitext(name)[0]
        ann = np.load(os.path.join(ann_dir, stem + ".npz"))
        img = cv2.imread(os.path.join(img_dir, name), cv2.IMREAD_COLOR)
        # swap so the eval CLI's BGR2RGB restores the training-time array
        cv2.imwrite(os.path.join(out_img, name), cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        lines.append(f"# {name}")
        for x, y, w, h in np.asarray(ann["bbox"], np.float64):
            lines.append(
                f"{int(round(x))} {int(round(y))} "
                f"{int(round(x + w))} {int(round(y + h))}"
            )
    with open(os.path.join(out, "label.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--out", required=True)
    ap.add_argument("--limit", type=int, default=256)
    args = ap.parse_args(argv)
    n = make_fddb_standin(args.src, args.out, args.split, args.limit)
    print(f"done: {n} images -> {args.out}")
    return n


if __name__ == "__main__":
    main()
