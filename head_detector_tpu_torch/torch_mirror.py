"""SuperGradients names and the ``.trcd`` TorchScript export of the port's model.

Counterpart of ``head_detector_tpu/torch_mirror.py``.  The JAX package needs
a torch twin of its flax model for two jobs that the port, being torch, does
on its own model:

* :func:`sg_state_dict` gives a flax tree's state dict under the
  SuperGradients module paths the reference trains and ships (the table of
  ``tools/convert_torch_checkpoint.py``, inverted): ``.seq.`` around every
  ConvBNReLU, ``branch_3x3.conv`` / ``branch_3x3.bn`` in QARepVGG blocks,
  ``bottlenecks.N`` (with SG's residual ``alpha``, 1.0: the flax tree has
  folded it into ``cv2/post_bn``), ``cls_convs.0`` / ``reg_convs.0`` and
  ``flame_*_pred.N`` (the tower's blocks, then its final 1x1 conv);
* :func:`export_torchscript` traces the port's deploy model with dense FLAME
  towers and saves the ``.trcd`` the reference publishes: ``[B, 3, H, W]``
  float 0..1 in, ``(boxes_xyxy [B,A,4], scores [B,A,1], flame [B,A,413])``
  out, FLAME globalised.  The trace bakes the anchors of ``image_size`` in
  as constants (as the reference's ``cache_anchors`` does).  It is traced on
  the CPU and loaded with ``map_location``, which moves the weights and the
  constants; the decode creates no tensor on a fixed device.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from head_detector_tpu_torch.device import exact_float32, resolve_device
from head_detector_tpu_torch.models import build_model, get_arch
from head_detector_tpu_torch.models.presets import ArchCfg
from head_detector_tpu_torch.weights import state_dict_from_flax

_BOTTLENECK = re.compile(r"^bottleneck(\d+)$")
_TOWER_BLOCK = re.compile(r"^block(\d+)$")
_HEAD = re.compile(r"^head(\d+)$")


def _sg_segments(key: str, parent: Tuple[str, ...], node: Dict[str, Any],
                 tower_depth: int) -> list:
    """SG module path pieces of the child ``key`` of the flax scope
    ``parent`` whose parameter dict is ``node``."""
    if key in ("conv", "bn") and "conv" in node and "bn" in node:  # ConvBNReLU
        return ["seq", key]
    if parent and parent[-1].startswith("flame_") and parent[-1].endswith("_pred"):
        m = _TOWER_BLOCK.match(key)
        return [m.group(1) if m else str(tower_depth)]  # blocks, then the 1x1 pred
    m = _BOTTLENECK.match(key)
    if m:
        return ["bottlenecks", m.group(1)]
    if key in ("cls_conv", "reg_conv"):
        return [key + "s", "0"]
    if key in ("branch_3x3_conv", "branch_3x3_bn"):
        return ["branch_3x3", key[len("branch_3x3_"):]]
    return [key]


def sg_state_dict(variables: Dict[str, Any], arch) -> Dict[str, torch.Tensor]:
    """Flax ``{params, batch_stats}`` (training or deploy layout, numpy
    leaves) -> the SuperGradients-named state dict, float32 (``alpha``
    scalars, ``num_batches_tracked`` int64 zeros): conv kernels OIHW, the
    upsamples' transposed kernels flipped into torch's layout, BatchNorm
    scale/bias/mean/var as weight/bias/running stats.
    ``tools.convert_torch_checkpoint.convert`` maps it back leaf for leaf."""
    arch = arch if isinstance(arch, ArchCfg) else get_arch(arch)
    out: Dict[str, torch.Tensor] = {}

    def put(key, value):
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))

    def walk(p, s, path, sg):
        prefix = ".".join(sg)
        leaves = {k: v for k, v in p.items() if not isinstance(v, dict)}
        if "scale" in leaves:  # BatchNorm
            put(f"{prefix}.weight", leaves["scale"])
            put(f"{prefix}.bias", leaves["bias"])
            put(f"{prefix}.running_mean", s["mean"])
            put(f"{prefix}.running_var", s["var"])
            out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        else:  # Conv / ConvTranspose, and a QARepVGG block's alpha
            if "kernel" in leaves:
                k = np.asarray(leaves["kernel"], np.float32)
                if path[-1] == "upsample":  # flax [kh,kw,I,O] unflipped -> [I,O,kh,kw]
                    k = np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
                else:  # HWIO -> OIHW
                    k = np.transpose(k, (3, 2, 0, 1))
                put(f"{prefix}.weight", k)
            if "bias" in leaves:
                put(f"{prefix}.bias", leaves["bias"])
            if "alpha" in leaves:
                put(f"{prefix}.alpha", np.reshape(leaves["alpha"], ()))
        if path and _BOTTLENECK.match(path[-1]):  # SG's residual alpha
            put(f"{prefix}.alpha", np.float32(1.0))
        depth = 0
        if len(path) >= 2 and _HEAD.match(path[-2]):
            depth = arch.heads[int(path[-2][4:]) - 1].flame_regression_blocks
        for key, sub in p.items():
            if isinstance(sub, dict):
                walk(sub, s.get(key, {}) if isinstance(s, dict) else {}, path + (key,),
                     sg + _sg_segments(key, path, p, depth))

    walk(variables["params"], variables.get("batch_stats", {}), (), [])
    return out


class DecodedOutputs(nn.Module):
    """The ``.trcd`` contract around a deploy ``YoloHeads`` built with dense
    towers and globalisation: ``(boxes_xyxy, scores, flame)``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor):
        decoded, _ = self.model(images)
        return decoded.boxes_xyxy, decoded.scores, decoded.flame_params


def decoded_outputs(model_name, variables: Dict[str, Any]) -> DecodedOutputs:
    """The float32 deploy model of ``variables`` (either layout) with dense
    towers, globalised, behind :class:`DecodedOutputs`, on the CPU, in eval
    mode."""
    arch = model_name if isinstance(model_name, ArchCfg) else get_arch(model_name)
    net = build_model(arch, defer_globalization=False, skip_flame=False, deploy=True)
    state, _ = state_dict_from_flax(variables, arch)
    net.load_state_dict(state, strict=True)
    return DecodedOutputs(net).eval()


def trace_decoded(model: DecodedOutputs, image_size: Tuple[int, int]) -> torch.jit.ScriptModule:
    """``torch.jit.trace`` of ``model`` on a CPU example of ``image_size``
    (the batch stays dynamic).  One forward runs first, so that the heads'
    anchors of this size exist and the trace holds them as constants, which
    load on any device (``YoloHeadsNDFLHeads._constants``).  The trace runs
    with TF32 off: each recorded convolution keeps the flag it was traced
    with, so the graph computes in full float32 on the card as the port
    does (``device.py``)."""
    example = torch.rand(1, 3, image_size[0], image_size[1])
    with torch.no_grad(), exact_float32(), warnings.catch_warnings():
        # the shape checks and the anchors' sizes are constants of this size
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        model(example)
        return torch.jit.trace(model, example, check_trace=False)


def export_torchscript(
    model_name, variables: Dict[str, Any], path: str,
    image_size: Tuple[int, int] = (640, 640), device="cuda",
) -> torch.jit.ScriptModule:
    """Trace the port's deploy model of ``variables`` on the CPU, save it to
    ``path`` (the ``.trcd`` format of the reference) and return it loaded on
    ``device``."""
    dev = resolve_device(device)
    traced = trace_decoded(decoded_outputs(model_name, variables), image_size)
    traced.save(path)
    return torch.jit.load(path, map_location=dev)
