"""Count the floating-point operations of one training step of the port.

    python3 tools/torch_train_flops.py [--model yolo_heads_m] [--size 128]
        [--target-size 640] [--batch 8]

Counts, with ``torch.utils.flop_counter`` on the CPU, the convolution and
matrix-product operations of the training-layout model's forward and
backward at ``--size`` px and one image, and scales them by area to
``--target-size`` and by ``--batch`` (the convolutions are linear in the
pixel count; the count is taken at a small size so that it runs in seconds
on a CPU).  The loss's FLAME decode does not scale with area: it is counted
apart, at its fixed ``max_positives`` rows.  Prints one JSON line.  These are
operation counts, not times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from head_detector_tpu_torch.flame import FlameModel, reproject_spatial_vertices  # noqa: E402
from head_detector_tpu_torch.models import build_model  # noqa: E402


def count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolo_heads_m")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--target-size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-positives", type=int, default=256)
    args = ap.parse_args()

    net = build_model(args.model, deploy=False).train()
    x = torch.rand(1, 3, args.size, args.size)

    def forward():
        decoded, raw = net(x)
        return raw.cls_score_list.sum() + raw.reg_distri_list.sum() + raw.flame_params.sum()

    fwd = count(forward)
    both = count(lambda: forward().backward())
    flame = FlameModel.from_assets(device="cpu")
    rows = torch.zeros(args.max_positives, 413, requires_grad=True)
    with torch.no_grad():
        rows[:, [403, 407, 412]] = 1.0

    def decode():
        verts, rot, proj = reproject_spatial_vertices(flame, rows, to_2d=True)
        return verts.sum() + proj.sum() + rot.sum()

    decode_fwd = count(decode)
    decode_both = count(lambda: decode().backward())
    scale = (args.target_size / args.size) ** 2 * args.batch
    print(json.dumps({
        "model": args.model, "counted_at": args.size, "scaled_to": args.target_size,
        "batch": args.batch,
        "model_forward_flop": fwd * scale,
        "model_forward_backward_flop": both * scale,
        "loss_flame_decode_forward_backward_flop": decode_both,
        "loss_flame_decode_forward_flop": decode_fwd,
        "step_flop": both * scale + decode_both,
    }))


if __name__ == "__main__":
    main()
