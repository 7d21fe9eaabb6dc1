"""Work counted from the configuration's shapes, on the reference network.

The counts never look at the port: a later PR that fuses, replaces or
reorders the port's layers reads the same numbers.  FLOPs are 2 x MACs of
every convolution and matrix product, counted by
``torch.utils.flop_counter`` on a network built on the meta device (no
memory, no time); elementwise work counts 0, so a share of a peak built on
these counts is never too high.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.models.yolo_heads import YoloHeads


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def deploy_forward_flops(arch, size: int) -> float:
    """FLOPs of one image's forward in the deploy form at ``size`` px: every
    QARepVGG block one 3x3 convolution, the FLAME towers left out (the
    serving paths run them at the kept anchors only, a few rows an image,
    which this count leaves out)."""
    with torch.device("meta"):
        net = YoloHeads(arch, deploy=True, skip_flame=True).eval()
        x = torch.empty(1, 3, size, size)
    with torch.no_grad():
        return float(_count(lambda: net(x)))


@functools.lru_cache(maxsize=None)
def train_step_flops(arch, size: int) -> float:
    """FLOPs of one image's training forward and backward at ``size`` px in
    the training layout (QARepVGG branches, dense FLAME towers); the loss's
    FLAME decode of at most ``max_positives`` rows a batch is left out."""
    with torch.device("meta"):
        net = YoloHeads(arch, deploy=False).train()
        x = torch.empty(1, 3, size, size)

    def step():
        _, raw = net(x)
        (raw.cls_score_list.sum() + raw.reg_distri_list.sum()
         + raw.flame_params.sum()).backward()

    return float(_count(step))


def pncc_render_bytes(heads: int, vertices: int, triangles: int, height: int,
                      width: int) -> int:
    """Bytes one ``pncc_render`` call must move at least: each input read
    once (float32 vertices [N, V, 3], int32 triangles [F, 3], float32
    colours [V, 3]) and the uint8 canvas [H, W, 3] written once."""
    return heads * vertices * 12 + triangles * 12 + vertices * 12 + height * width * 3
