"""HeadDetector: image(s) in, PredictionResult(s) out, on one torch device.

Counterpart of ``head_detector_tpu/detector.py`` with deploy-fused weights,
sparse FLAME towers and deferred globalisation.  Per batch the path is:

1. one uint8 upload per input shape, lanczos4 letterbox on the device;
2. the deploy YoloHeads forward in the compute ``dtype`` with the FLAME
   towers skipped;
3. DFL decode, fixed-size greedy NMS (with the fusion neighbours when
   ``param_fusion``), compaction of the top-m detections;
4. the FLAME towers at the kept anchors only (at every neighbour's anchor,
   then the weighted mean, with ``param_fusion``), globalisation, FLAME LBS
   in float32 with the 6DoF transform folded in (``fused_project_vertices``);
5. un-letterbox and roll/pitch/yaw, the vertices cast to the wire dtype on
   the device, then one download of the valid rows.

``__call__`` is step 1-5 on one image with a budget of ``compact_wire``
detections, or of ``post_nms_max`` (every NMS survivor) without a compact
wire, and then returns float32 vertices as the reference does.  Float32
operations run with TF32 off (see ``device.py``).  Weights load from a flax
msgpack checkpoint (``checkpoint=`` or ``HDT_CHECKPOINT``) in the training
or the deploy layout; without one the training-layout model is initialised
at random (``models.init_model``, seed 0, BatchNorm calibrated at
``image_size``).  ``deploy=False`` keeps the training layout (QARepVGG
branches, the dense FLAME towers, whose rows at the kept anchors are
gathered after NMS); by default the blocks are fused and the towers run
sparsely at the kept anchors.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import cv2
import numpy as np
import torch
from PIL import Image

from head_detector_tpu_torch.detection_result import PredictionResult
from head_detector_tpu_torch.device import exact_float32, resolve_device
from head_detector_tpu_torch.flame import FlameModel, fused_project_vertices
from head_detector_tpu_torch.head_info import NUM_FLAME_PARAMS, Bbox, FlameParams, HeadMetadata, RPY
from head_detector_tpu_torch.models import build_model, get_arch, globalize_flame, init_model
from head_detector_tpu_torch.models.heads import RawOutputs
from head_detector_tpu_torch.ops.letterbox import letterbox_batch, letterbox_spec
from head_detector_tpu_torch.ops.nms import batched_nms, compact_detections
from head_detector_tpu_torch.ops.rotation import rotation_mats_to_rpy
from head_detector_tpu_torch.ops.sparse_towers import sparse_flame_rows
from head_detector_tpu_torch.weights import (
    count_leaves,
    flax_from_state_dict,
    load_variables,
    state_dict_from_flax,
    train_state_dict_from_flax,
)

# meta row: batch index, box (4), score, params (413), rpy (3), valid
_BOX = slice(1, 5)
_SCORE = 5
_PARAMS = slice(6, 6 + NUM_FLAME_PARAMS)
_RPY = slice(6 + NUM_FLAME_PARAMS, 9 + NUM_FLAME_PARAMS)
_WIRE_DTYPES = {"f32": torch.float32, "f16": torch.float16}


def is_deploy_layout(variables: dict) -> bool:
    """True when a flax tree holds fused (``rbr_reparam``) QARepVGG blocks."""
    def walk(tree) -> bool:
        return isinstance(tree, dict) and (
            "rbr_reparam" in tree or any(walk(v) for v in tree.values()))

    return walk(variables.get("params", {}))


def random_variables(arch, image_size: int, device) -> dict:
    """A randomly initialised training-layout model (``init_model``, seed 0,
    BatchNorm calibrated at ``image_size`` on ``device``) as a flax tree."""
    net = build_model(arch, deploy=False).to(device)
    init_model(net, torch.Generator().manual_seed(0), (image_size, image_size))
    return flax_from_state_dict(net.state_dict())


class HeadDetector:
    """Detect human heads + FLAME meshes in one forward pass.

    ``compact_wire=M``: ``__call__`` decodes and downloads only the top M
    slots (valid first, then score); an image with <= M detections gives the
    same result.  ``wire_verts_dtype="f16"`` casts the vertices to float16 on
    the device before the download (``predict_batch`` always, ``__call__``
    with a compact wire); below 1024 px that costs < 0.25 px.
    ``param_fusion=True`` replaces each kept head's FLAME params by the
    score-weighted mean over its top ``fusion_neighbors`` candidates of IoU
    >= ``fusion_iou`` (``ops/nms.py``); boxes, scores and the detection set
    do not change.  ``dtype`` is the model's compute dtype
    (``torch.float32`` or ``torch.bfloat16``); FLAME LBS stays float32."""

    def __init__(
        self,
        model: str = "vgg_heads_l",
        image_size: int = 640,
        checkpoint: Optional[str] = None,
        device="cuda",
        dtype: torch.dtype = torch.float32,
        pre_nms_max: int = 1000,
        post_nms_max: int = 100,
        iou_threshold: float = 0.5,
        compact_wire: Optional[int] = None,
        wire_verts_dtype: str = "f32",
        param_fusion: bool = False,
        fusion_neighbors: int = 4,
        fusion_iou: float = 0.7,
        deploy: bool = True,
    ):
        if wire_verts_dtype not in _WIRE_DTYPES:
            raise ValueError(f"wire_verts_dtype must be f32|f16, got {wire_verts_dtype!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.device = resolve_device(device)
        checkpoint = checkpoint or os.environ.get("HDT_CHECKPOINT")
        self._image_size = image_size
        self._pre_nms_max = pre_nms_max
        self._post_nms_max = post_nms_max
        self._iou_threshold = iou_threshold
        self._compact_wire = int(compact_wire) if compact_wire else 0
        self._wire_vdtype = _WIRE_DTYPES[wire_verts_dtype]
        self._fusion_neighbors = int(fusion_neighbors) if param_fusion else 0
        self._fusion_iou = float(fusion_iou)
        self._arch = get_arch(model)

        variables = (load_variables(checkpoint) if checkpoint
                     else random_variables(self._arch, image_size, self.device))
        self._sparse = deploy or is_deploy_layout(variables)
        convert = (lambda v: state_dict_from_flax(v, self._arch)) if self._sparse \
            else train_state_dict_from_flax
        state, used = convert(variables)
        total = count_leaves(variables)
        if used != total:
            raise ValueError(f"{checkpoint}: restored {used}/{total} leaves")
        self.restored_leaves = (used, total)
        net = build_model(self._arch, defer_globalization=True, skip_flame=self._sparse,
                          dtype=dtype, deploy=self._sparse)
        net.load_state_dict(state, strict=True)
        self._model = net.to(self.device).eval()
        self._flame = FlameModel.from_assets(device=self.device)

    # ------------------------------------------------------------------ #
    def _rows(self, feats, dense: torch.Tensor, anchor_idx: torch.Tensor,
              batch_idx: torch.Tensor) -> torch.Tensor:
        """Anchor-local FLAME rows [K, 413] (float32) at ``anchor_idx`` of
        images ``batch_idx``: the sparse towers (fused blocks), or a gather
        from the dense rows (training layout)."""
        if self._sparse:
            return sparse_flame_rows(self._model.heads, self._arch, feats,
                                     anchor_idx[None], batch_idx=batch_idx[None])[0]
        return dense[batch_idx.long(), anchor_idx.long()].float()

    def _fused_rows(self, feats, dense: torch.Tensor, raw: RawOutputs, nb_idx: torch.Tensor,
                    nb_w: torch.Tensor, batch_idx: torch.Tensor) -> torch.Tensor:
        """Globalised, score-weighted FLAME params [K, 413] over each slot's
        neighbours ``nb_idx`` [K, n] with weights ``nb_w`` [K, n].  Every
        neighbour row is globalised at its own anchor before the mean (the
        same as fusing globalised dense rows: globalisation is a per-anchor
        affine on the translation and scale slots)."""
        k, n = nb_idx.shape
        flat = nb_idx.reshape(k * n)
        rows = self._rows(feats, dense, flat, batch_idx.repeat_interleave(n))
        glob = globalize_flame(rows, flat, raw.anchor_points, raw.stride_tensor)
        wsum = torch.clamp(nb_w.sum(dim=1, keepdim=True), min=1e-12)
        return (nb_w[..., None] * glob.reshape(k, n, -1)).sum(dim=1) / wsum

    @torch.no_grad()
    def _detect(self, images, confidence_threshold, pads, scales, m, verts_dtype):
        """images [B, S, S, 3] float; pads [B, 2]; scales [B] -> (meta
        [n, 423] numpy, verts [n, V, 3] float32 numpy) for the n valid rows
        of the top ``m`` slots, the vertices rounded to ``verts_dtype`` on
        the device."""
        with exact_float32():
            decoded, raw, feats = self._model(
                images.permute(0, 3, 1, 2).contiguous(), return_feats=True
            )
            res = batched_nms(
                decoded.boxes_xyxy, decoded.scores, decoded.flame_params,
                confidence_threshold=confidence_threshold,
                iou_threshold=self._iou_threshold,
                pre_nms_max=self._pre_nms_max,
                post_nms_max=self._post_nms_max,
                fusion_iou=self._fusion_iou,
                return_neighbors=self._fusion_neighbors,
            )
            nb = None
            if self._fusion_neighbors:
                res, nb = res
            cres = compact_detections(res, m)
            if nb is not None:
                at = (cres.batch_idx, cres.slot_idx)
                params = self._fused_rows(feats, decoded.flame_params, raw, nb.anchor_idx[at],
                                          nb.weights[at], cres.batch_idx)
            else:
                rows = self._rows(feats, decoded.flame_params, cres.anchor_idx,
                                  cres.batch_idx)
                params = globalize_flame(
                    rows, cres.anchor_idx, raw.anchor_points, raw.stride_tensor
                )
            R, verts = fused_project_vertices(self._flame, params, to_2d=False)

            bi = cres.batch_idx
            pad = pads[bi]  # [m, 2]
            scale = scales[bi]  # [m]
            verts = verts.clone()
            verts[:, :, 0] -= pad[:, 0:1]
            verts[:, :, 1] -= pad[:, 1:2]
            verts = verts / scale[:, None, None]

            boxes = torch.clamp(cres.boxes, 0, self._image_size)
            boxes = boxes - pad.repeat(1, 2)
            boxes = boxes / scale[:, None]

            rpy = rotation_mats_to_rpy(R)
            meta = torch.cat(
                [bi.to(torch.float32)[:, None], boxes, cres.scores[:, None],
                 params, rpy, cres.valid.to(torch.float32)[:, None]], dim=1,
            )
            keep = cres.valid.nonzero()[:, 0]
            verts = verts[keep].to(verts_dtype).cpu().numpy().astype(np.float32)
            return meta[keep].cpu().numpy(), verts

    def predict_batch(
        self,
        images: List[Union[str, Image.Image, np.ndarray]],
        confidence_threshold: float = 0.5,
        max_detections: Optional[int] = None,
    ) -> List[PredictionResult]:
        """Detect heads in a list of images in one batched forward.

        ``max_detections`` bounds the decoded detections across the batch
        (default ``16 * len(images)``, capped at ``post_nms_max *
        len(images)``); the highest scores batch-wide win if it binds."""
        return self._predict(images, confidence_threshold,
                             min(max_detections or 16 * len(images),
                                 self._post_nms_max * len(images)),
                             self._wire_vdtype)

    def _predict(self, images, confidence_threshold: float, m: int,
                 verts_dtype: torch.dtype) -> List[PredictionResult]:
        originals = [self._convert_image(im) for im in images]
        b = len(originals)
        by_shape: Dict[tuple, List[int]] = {}
        for i, im in enumerate(originals):
            by_shape.setdefault(im.shape, []).append(i)
        order, chunks, pads, scales = [], [], [], []
        for shape, idxs in by_shape.items():
            stack = np.stack([np.ascontiguousarray(originals[i]) for i in idxs])
            upload = torch.from_numpy(stack).to(self.device)
            with exact_float32():
                chunks.append(letterbox_batch(upload, self._image_size))
            spec = letterbox_spec(shape[0], shape[1], self._image_size)
            for i in idxs:
                order.append(i)
                pads.append((float(spec.pad_left), float(spec.pad_top)))
                scales.append(float(spec.scale))
        imgs = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
        meta, verts = self._detect(
            imgs,
            float(confidence_threshold),
            torch.tensor(pads, dtype=torch.float32, device=self.device),
            torch.tensor(scales, dtype=torch.float32, device=self.device),
            m,
            verts_dtype,
        )
        results = [None] * b
        for j, i in enumerate(order):  # j = row fed to the model
            sel = meta[:, 0].astype(np.int32) == j
            results[i] = PredictionResult(
                original_image=originals[i],
                heads=self._build_heads(
                    meta[sel, _BOX], meta[sel, _SCORE], meta[sel, _PARAMS],
                    verts[sel], meta[sel, _RPY], scales[j],
                ),
                device=self.device,
            )
        return results

    def __call__(
        self,
        image: Union[str, Image.Image, np.ndarray],
        confidence_threshold: float = 0.5,
    ) -> PredictionResult:
        if self._compact_wire:
            return self._predict([image], confidence_threshold, self._compact_wire,
                                 self._wire_vdtype)[0]
        return self._predict([image], confidence_threshold, self._post_nms_max,
                             torch.float32)[0]

    # ------------------------------------------------------------------ #
    @staticmethod
    def _convert_image(image: Union[str, Image.Image, np.ndarray]) -> np.ndarray:
        if isinstance(image, str):
            image = cv2.imread(image)
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        elif isinstance(image, Image.Image):
            image = np.array(image)
        return image

    @staticmethod
    def _build_heads(boxes, scores, params, verts, rpy, scale) -> List[HeadMetadata]:
        heads: List[HeadMetadata] = []
        boxes = np.rint(boxes).astype(int)
        for i in range(len(scores)):
            p = FlameParams.from_3dmm(params[i : i + 1])
            # only `scale` is rescaled on the host; translation stays in
            # letterbox space, as in the reference
            p.scale = p.scale / scale
            box = boxes[i]
            heads.append(
                HeadMetadata(
                    bbox=Bbox(x=box[0], y=box[1], w=box[2] - box[0], h=box[3] - box[1]),
                    score=float(scores[i]),
                    flame_params=p,
                    vertices_3d=verts[i],
                    head_pose=RPY(roll=float(rpy[i, 0]), pitch=float(rpy[i, 1]),
                                  yaw=float(rpy[i, 2])),
                )
            )
        return heads
