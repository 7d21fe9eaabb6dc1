"""The reference's serving path: letterbox, the float32 training-layout
forward, NMS, the FLAME decode, un-letterbox and the PNCC map.

Plain PyTorch on the frozen copies beside this file.  The network runs in
the training layout in eval mode (QARepVGG branches and BatchNorms apart),
whose function the port's deploy fusion reproduces, and its FLAME rows come
from the dense towers at every anchor, gathered after NMS, where the port
runs sparse towers at the kept anchors only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import cv2
import numpy as np
import torch

from benchmark.reference.assets_io import get_indices, load_flame_assets
from benchmark.reference.flame import FlameModel, fused_project_vertices
from benchmark.reference.models.presets import ArchCfg, HeadCfg, NeckStageCfg, StageCfg
from benchmark.reference.models.yolo_heads import YoloHeads
from benchmark.reference.nms import batched_nms, compact_detections
from benchmark.reference.raster import compute_ncc_color_codes, pncc_render_plain


def arch_from_dict(arch: dict) -> ArchCfg:
    """A configuration file's ``arch`` group -> the reference's ``ArchCfg``."""
    fields = dict(arch)
    fields["stages"] = tuple(StageCfg(**s) for s in arch["stages"])
    fields["neck_up"] = tuple(NeckStageCfg(**s) for s in arch["neck_up"])
    fields["neck_down"] = tuple(NeckStageCfg(**s) for s in arch["neck_down"])
    fields["heads"] = tuple(HeadCfg(**h) for h in arch["heads"])
    fields["spp_k"] = tuple(arch["spp_k"])
    return ArchCfg(**fields)


def arch_to_dict(arch) -> dict:
    """Any ``ArchCfg``-shaped dataclass -> plain JSON types (tuples as lists)."""
    return json_types(dataclasses.asdict(arch))


def require_port_arch(config: dict, port_arch) -> None:
    """The port's preset of the configuration's name has its widths."""
    if arch_to_dict(port_arch) != config["arch"]:
        raise ValueError(f"the port's {config['name']} differs from its benchmark configuration")


def json_types(x):
    if isinstance(x, dict):
        return {k: json_types(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_types(v) for v in x]
    return x


def build_model(arch: ArchCfg, state: Optional[Dict[str, torch.Tensor]], device,
                train: bool = False) -> YoloHeads:
    """The float32 training-layout network, with ``state`` loaded when given."""
    net = YoloHeads(arch, deploy=False).to(device)
    if state is not None:
        net.load_state_dict(state, strict=True)
    return net.train(train)


def letterbox_host(image: np.ndarray, size: int):
    """The streaming letterbox, worked out again: cv2 INTER_LINEAR to
    ``int(side * scale + 0.5)``, centred on a canvas of 127 -> (canvas,
    scale, (left, top))."""
    h, w = image.shape[:2]
    scale = min(size / h, size / w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((size, size, 3), 127, np.uint8)
    top, left = (size - nh) // 2, (size - nw) // 2
    out[top:top + nh, left:left + nw] = resized
    return out, scale, (left, top)


@dataclasses.dataclass
class Detections:
    """One image's detections, float32 numpy, in score order."""

    boxes: np.ndarray  # [n, 4] xyxy
    scores: np.ndarray  # [n]
    params: np.ndarray  # [n, 413] globalised FLAME params
    verts: np.ndarray  # [n, V, 3] projected vertices


@torch.no_grad()
def detect(model: YoloHeads, flame: FlameModel, images: torch.Tensor,
           confidence_threshold: float = 0.5, iou_threshold: float = 0.5,
           pre_nms_max: int = 1000, post_nms_max: int = 100) -> List[Detections]:
    """images [B, S, S, 3] float in [0, 1] (letterboxed) -> one
    ``Detections`` per image, in letterbox pixels."""
    decoded, _ = model(images.permute(0, 3, 1, 2).contiguous())
    res = batched_nms(decoded.boxes_xyxy, decoded.scores, decoded.flame_params,
                      confidence_threshold=confidence_threshold,
                      iou_threshold=iou_threshold, pre_nms_max=pre_nms_max,
                      post_nms_max=post_nms_max)
    cres = compact_detections(res, res.valid.numel())
    keep = cres.valid.nonzero()[:, 0]
    _, verts = fused_project_vertices(flame, cres.flame_params[keep], to_2d=False)
    bi = cres.batch_idx[keep].cpu().numpy()
    boxes, scores, params = (t[keep].float().cpu().numpy()
                             for t in (cres.boxes, cres.scores, cres.flame_params))
    verts = verts.float().cpu().numpy()
    return [Detections(boxes[bi == i], scores[bi == i], params[bi == i], verts[bi == i])
            for i in range(images.shape[0])]


def head_indices() -> np.ndarray:
    return np.asarray(get_indices()["head"])


class PnccTables:
    """The triangles wholly inside ``head_w_ears`` and their NCC colours, as
    ``PredictionResult.get_pncc`` draws them."""

    def __init__(self, device):
        assets = load_flame_assets()
        idx = assets.head_w_ears_indices
        inside = np.isin(assets.faces, idx).all(axis=1)
        colors = compute_ncc_color_codes(assets.v_template.astype(np.float64), idx)
        self.triangles = torch.as_tensor(assets.faces[inside].astype(np.int32), device=device)
        self.colors = torch.as_tensor(colors.astype(np.float32), device=device)

    def render(self, verts: np.ndarray, height: int, width: int) -> np.ndarray:
        """uint8 [H, W, 3] PNCC map of heads ``verts`` [n, V, 3] (image
        pixels, depth as projected)."""
        if len(verts) == 0:
            return np.zeros((height, width, 3), np.uint8)
        v = torch.as_tensor(np.asarray(verts, np.float32), device=self.colors.device).clone()
        v[:, :, 2] *= -1
        return pncc_render_plain(v, self.triangles, self.colors, height, width).cpu().numpy()
