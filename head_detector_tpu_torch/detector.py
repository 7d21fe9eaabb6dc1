"""HeadDetector: image(s) in, PredictionResult(s) out, on one torch device.

Counterpart of ``head_detector_tpu/detector.py`` with its default options
(deploy-fused weights, sparse FLAME towers, deferred globalisation).  Per
batch the path is:

1. one uint8 upload per input shape, lanczos4 letterbox on the device;
2. the deploy YoloHeads forward with the FLAME towers skipped;
3. DFL decode, fixed-size greedy NMS, compaction of the top-m detections;
4. the FLAME towers at the kept anchors only, globalisation, FLAME LBS with
   the 6DoF transform folded in (``fused_project_vertices``);
5. un-letterbox and roll/pitch/yaw, then one download of the valid rows.

``__call__`` is ``predict_batch`` on one image with a budget of
``post_nms_max`` detections, which keeps every NMS survivor.  Float32
throughout, TF32 off (see ``device.py``).  Weights load from a flax msgpack
checkpoint (``checkpoint=`` or ``HDT_CHECKPOINT``) in the training or the
deploy layout.  ``compact_wire``, ``param_fusion`` and random initialisation
are not ported yet.
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
from head_detector_tpu_torch.models import build_model, get_arch, globalize_flame
from head_detector_tpu_torch.ops.letterbox import letterbox_batch, letterbox_spec
from head_detector_tpu_torch.ops.nms import batched_nms, compact_detections
from head_detector_tpu_torch.ops.rotation import rotation_mats_to_rpy
from head_detector_tpu_torch.ops.sparse_towers import sparse_flame_rows
from head_detector_tpu_torch.weights import count_leaves, load_variables, state_dict_from_flax

# meta row: batch index, box (4), score, params (413), rpy (3), valid
_BOX = slice(1, 5)
_SCORE = 5
_PARAMS = slice(6, 6 + NUM_FLAME_PARAMS)
_RPY = slice(6 + NUM_FLAME_PARAMS, 9 + NUM_FLAME_PARAMS)


class HeadDetector:
    """Detect human heads + FLAME meshes in one forward pass."""

    def __init__(
        self,
        model: str = "vgg_heads_l",
        image_size: int = 640,
        checkpoint: Optional[str] = None,
        device="cuda",
        pre_nms_max: int = 1000,
        post_nms_max: int = 100,
        iou_threshold: float = 0.5,
    ):
        self.device = resolve_device(device)
        checkpoint = checkpoint or os.environ.get("HDT_CHECKPOINT")
        if not checkpoint:
            raise ValueError("HeadDetector needs a flax msgpack checkpoint "
                             "(checkpoint= or HDT_CHECKPOINT)")
        self._image_size = image_size
        self._pre_nms_max = pre_nms_max
        self._post_nms_max = post_nms_max
        self._iou_threshold = iou_threshold
        self._arch = get_arch(model)

        variables = load_variables(checkpoint)
        state, used = state_dict_from_flax(variables, self._arch)
        total = count_leaves(variables)
        if used != total:
            raise ValueError(f"{checkpoint}: restored {used}/{total} leaves")
        self.restored_leaves = (used, total)
        net = build_model(self._arch, defer_globalization=True, skip_flame=True)
        net.load_state_dict(state, strict=True)
        self._model = net.to(self.device).eval()
        self._flame = FlameModel.from_assets(device=self.device)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _detect(self, images, confidence_threshold, pads, scales, m):
        """images [B, S, S, 3] float; pads [B, 2]; scales [B] -> (meta
        [n, 423] numpy, verts [n, V, 3] numpy) for the n valid rows."""
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
            )
            cres = compact_detections(res, m)
            rows = sparse_flame_rows(
                self._model.heads, self._arch, feats,
                cres.anchor_idx[None], batch_idx=cres.batch_idx[None],
            )[0]
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
            return meta[keep].cpu().numpy(), verts[keep].cpu().numpy()

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
        m = min(max_detections or 16 * b, self._post_nms_max * b)
        meta, verts = self._detect(
            imgs,
            float(confidence_threshold),
            torch.tensor(pads, dtype=torch.float32, device=self.device),
            torch.tensor(scales, dtype=torch.float32, device=self.device),
            m,
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
        return self.predict_batch(
            [image], confidence_threshold, max_detections=self._post_nms_max
        )[0]

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
