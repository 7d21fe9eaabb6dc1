"""Work of a SegFormer cell counted from the configuration's shapes, on the
reference network (``work.py``'s rule: 2 x MACs of every convolution and
matrix product, counted by ``torch.utils.flop_counter`` on the meta device;
elementwise work counts 0).  The count holds the Linears, the attention's two
batched products and the ``sr`` and depthwise convolutions.

``FlopCounterMode`` counts the weight gradient of a grouped convolution as
if the convolution were dense, ``groups`` times its MACs: 1,280 times for
stage 3's depthwise 3x3, which would make the MiT-B5 step's count 3.1 TFLOPs
an image where it is 0.9.  So the backward of a convolution is counted here
by :func:`conv_backward_flops`.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from benchmark.reference.models.segformer import MiTCfg, SegFormerYoloHeads


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """FLOPs of ``aten.convolution_backward``: the input gradient as torch
    counts it (a transposed convolution of the output gradient by the
    weight), and the weight gradient at the forward's MACs, each output
    element's product with each tap of its group's inputs."""
    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0], not transposed)
    if output_mask[1]:
        flops += conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return flops


def count(fn) -> int:
    """FLOPs of ``fn()``, convolutions' backward by :func:`conv_backward_flops`."""
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: conv_backward_flops}) as counter:
        fn()
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def train_step_flops(mit: MiTCfg, arch, size: int) -> float:
    """FLOPs of one image's training forward and backward at ``size`` px;
    the loss's FLAME decode of at most ``max_positives`` rows a batch is
    left out."""
    with torch.device("meta"):
        net = SegFormerYoloHeads(mit, arch).train()
        x = torch.empty(1, 3, size, size)

    def step():
        _, raw = net(x)
        (raw.cls_score_list.sum() + raw.reg_distri_list.sum()
         + raw.flame_params.sum()).backward()

    return float(count(step))
