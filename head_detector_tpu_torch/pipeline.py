"""StreamingDetector: batched inference over a stream of images on one card.

Counterpart of ``head_detector_tpu/pipeline.py`` on one device (the JAX
version's data-parallel ``mesh`` is not ported).  Per batch:

1. host: worker threads letterbox each image with cv2 INTER_LINEAR (sized
   ``int(side * scale + 0.5)``, centred, padded with 127) and a producer
   thread groups them into batches behind a bounded queue; a short last
   batch is padded with copies of its last image;
2. upload: the batch is copied into a pinned host buffer of a ring of
   ``pipeline_depth + 1`` and from there to the card on a copy stream; the
   compute stream waits on the copy's event.  The next batch is uploaded
   before this one's step is enqueued, so the copy overlaps the step;
3. step (compute stream): uint8 -> float32 / 255, the deploy forward in
   ``dtype``, fixed-size NMS, then the FLAME towers and the mesh decode (on
   the ``mesh_subset`` vertices, float32 LBS, output in ``verts_dtype``) for
   the top ``decode_budget`` detections of the batch;
4. emit: the small outputs come back into pinned buffers behind an event,
   read on the host after the event; ``pipeline_depth`` steps are in flight.

Each yielded dict holds ``boxes_xyxy`` [K, 4] (letterbox space), ``scores``
[K], ``valid`` [K] (numpy), ``vertices`` ``{nms_slot: [V_subset, 3] device
tensor}`` for the image's decoded detections, and ``scale``.  The NMS waits
on the device once per suppression sweep, so the host cannot run further
ahead than the step being enqueued.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import cv2
import numpy as np
import torch

from head_detector_tpu_torch.assets_io import get_indices
from head_detector_tpu_torch.detector import random_variables
from head_detector_tpu_torch.device import exact_float32, resolve_device
from head_detector_tpu_torch.flame import FlameModel, fused_project_vertices
from head_detector_tpu_torch.models import ArchCfg, build_model, get_arch, globalize_flame
from head_detector_tpu_torch.ops.nms import batched_nms, compact_detections
from head_detector_tpu_torch.ops.sparse_towers import sparse_flame_rows
from head_detector_tpu_torch.weights import count_leaves, load_variables, state_dict_from_flax


class _Slot:
    """One staging buffer: pinned host memory and its device twin (on the
    CPU the same tensor), with the events that guard their reuse."""

    def __init__(self, shape, device: torch.device):
        if device.type == "cuda":
            self.host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            self.dev = torch.empty(shape, dtype=torch.uint8, device=device)
            self.copied = torch.cuda.Event()  # the host -> device copy is done
            self.consumed = torch.cuda.Event()  # the step has read ``dev``
        else:
            self.host = self.dev = torch.empty(shape, dtype=torch.uint8)
            self.copied = self.consumed = None


class _Pending:
    """A step's outputs on their way to the host."""

    def __init__(self, outputs, metas, device: torch.device):
        boxes, scores, valid, mesh = outputs
        small = [boxes, scores, valid] + (list(mesh[:3]) if mesh is not None else [])
        self.verts = mesh[3] if mesh is not None else None
        self.metas = metas
        if device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in small]
            for h, t in zip(self.host, small):
                h.copy_(t, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = small, None

    def numpy(self) -> List[np.ndarray]:
        if self.done is not None:
            self.done.synchronize()
        return [t.numpy() for t in self.host]


class StreamingDetector:
    def __init__(
        self,
        model_name="yolo_heads_l",
        image_size: int = 1024,
        batch_size: int = 32,
        variables: Optional[dict] = None,
        checkpoint: Optional[str] = None,
        confidence_threshold: float = 0.5,
        iou_threshold: float = 0.5,
        post_nms_max: int = 100,
        decode_meshes: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        prefetch: int = 3,
        workers: int = 8,
        pipeline_depth: int = 2,
        decode_budget: int = 256,
        mesh_subset: Optional[str] = "head",
        verts_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
    ):
        """``variables`` is a flax ``{params, batch_stats}`` tree of numpy
        arrays (training or deploy layout); ``checkpoint`` a flax msgpack
        file; with neither, the training-layout model is initialised at
        random (seed 0, BatchNorm calibrated at ``image_size``) and fused."""
        if image_size % 32:
            raise ValueError("image_size must be a multiple of 32")
        self.device = resolve_device(device)
        self.image_size = image_size
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.workers = workers
        self.pipeline_depth = max(1, pipeline_depth)
        self.decode_meshes = decode_meshes
        self.decode_budget = decode_budget
        self.confidence_threshold = confidence_threshold
        self.iou_threshold = iou_threshold
        self.post_nms_max = post_nms_max
        self.verts_dtype = verts_dtype

        self.arch = model_name if isinstance(model_name, ArchCfg) else get_arch(model_name)
        if variables is None and checkpoint:
            variables = load_variables(checkpoint)
        if variables is None:
            variables = random_variables(self.arch, image_size, self.device)
        state, used = state_dict_from_flax(variables, self.arch)
        if used != count_leaves(variables):
            raise ValueError(f"restored {used}/{count_leaves(variables)} leaves")
        net = build_model(self.arch, defer_globalization=True, skip_flame=True, dtype=dtype)
        net.load_state_dict(state, strict=True)
        self.model = net.to(self.device).eval()
        self.flame = FlameModel.from_assets(device=self.device)
        self.decode_flame = (
            self.flame.subset(get_indices()[mesh_subset]) if mesh_subset else self.flame
        )

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _step(self, images_u8: torch.Tensor, slot: Optional[_Slot] = None):
        """[B, S, S, 3] uint8 on the device -> (boxes [B, K, 4], scores
        [B, K], valid [B, K], (batch_idx, slot_idx, valid, verts) of the
        ``decode_budget`` compacted rows, or None)."""
        images = images_u8.to(torch.float32) / 255.0
        if slot is not None and slot.consumed is not None:
            slot.consumed.record()  # ``slot.dev`` may be overwritten after this
        with exact_float32():
            decoded, raw, feats = self.model(
                images.permute(0, 3, 1, 2).contiguous(), return_feats=True
            )
            res = batched_nms(
                decoded.boxes_xyxy, decoded.scores, decoded.flame_params,
                confidence_threshold=self.confidence_threshold,
                iou_threshold=self.iou_threshold,
                pre_nms_max=1000,
                post_nms_max=self.post_nms_max,
            )
            if not self.decode_meshes:
                return res.boxes, res.scores, res.valid, None
            cres = compact_detections(res, self.decode_budget)
            rows = sparse_flame_rows(
                self.model.heads, self.arch, feats,
                cres.anchor_idx[None], batch_idx=cres.batch_idx[None],
            )[0]
            params = globalize_flame(rows, cres.anchor_idx, raw.anchor_points,
                                     raw.stride_tensor)
            _, verts = fused_project_vertices(self.decode_flame, params, to_2d=False)
            return (res.boxes, res.scores, res.valid,
                    (cres.batch_idx, cres.slot_idx, cres.valid, verts.to(self.verts_dtype)))

    def _letterbox_host(self, image: np.ndarray) -> Tuple[np.ndarray, float]:
        s = self.image_size
        h, w = image.shape[:2]
        scale = min(s / h, s / w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
        out = np.full((s, s, 3), 127, np.uint8)
        top, left = (s - nh) // 2, (s - nw) // 2
        out[top : top + nh, left : left + nw] = resized
        return out, scale

    def _upload(self, slot: _Slot, canvases: List[np.ndarray], copy_stream) -> None:
        """Fill ``slot`` with a batch (the tail padded with its last image)
        and enqueue its copy to the device."""
        if slot.copied is not None:
            slot.copied.synchronize()  # the pinned buffer's last copy has left
        host = slot.host.numpy()
        for i in range(self.batch_size):
            host[i] = canvases[min(i, len(canvases) - 1)]
        if copy_stream is not None:
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(slot.consumed)  # the last step has read it
                slot.dev.copy_(slot.host, non_blocking=True)
                slot.copied.record(copy_stream)

    def run(self, images: Iterable[np.ndarray]) -> Iterator[dict]:
        """Yield one dict per image (see the module docstring)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            pool = cf.ThreadPoolExecutor(self.workers)
            try:
                batch: List[np.ndarray] = []
                metas: List[float] = []
                for canvas, scale in pool.map(self._letterbox_host, images):
                    batch.append(canvas)
                    metas.append(scale)
                    if len(batch) == self.batch_size:
                        if not put((batch, metas)):
                            return
                        batch, metas = [], []
                if batch and not put((batch, metas)):
                    return
                put(None)
            except Exception as exc:  # handed to the consumer, which raises it
                put(exc)
            finally:
                pool.shutdown(cancel_futures=True)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        shape = (self.batch_size, self.image_size, self.image_size, 3)
        ring = [_Slot(shape, self.device) for _ in range(self.pipeline_depth + 1)]
        copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        pending: "collections.deque[_Pending]" = collections.deque()
        staged = None  # (slot, metas) uploaded, step not yet enqueued
        try:
            for t in itertools.count():
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                nxt = None
                if item is not None:
                    canvases, metas = item
                    slot = ring[t % len(ring)]
                    self._upload(slot, canvases, copy_stream)
                    nxt = (slot, metas)
                if staged is not None:
                    slot, metas = staged
                    if slot.copied is not None:
                        torch.cuda.current_stream(self.device).wait_event(slot.copied)
                    pending.append(_Pending(self._step(slot.dev, slot), metas, self.device))
                    if len(pending) >= self.pipeline_depth:
                        yield from self._emit(pending.popleft())
                staged = nxt
                if staged is None:
                    break
            while pending:
                yield from self._emit(pending.popleft())
        finally:
            stop.set()
            thread.join()

    def _emit(self, out: _Pending) -> Iterator[dict]:
        arrays = out.numpy()
        boxes, scores, valid = arrays[:3]
        for i, scale in enumerate(out.metas):
            vertices = None
            if out.verts is not None:
                batch_idx, slot_idx, mvalid = arrays[3:]
                rows = np.flatnonzero(mvalid & (batch_idx == i))
                vertices = {int(slot_idx[j]): out.verts[j] for j in rows}
            yield {
                "boxes_xyxy": boxes[i],
                "scores": scores[i],
                "valid": valid[i],
                "vertices": vertices,
                "scale": scale,
            }

    def throughput(
        self,
        num_images: int = 256,
        warmup_batches: int = 2,
        device_feed: bool = False,
    ) -> float:
        """Images per second on seeded random images of ``image_size``.

        ``device_feed=True`` times the step alone, back to back on one uint8
        batch already on the device (no letterbox, no upload)."""
        rng = np.random.RandomState(0)
        if device_feed:
            batch = torch.as_tensor(rng.randint(
                0, 255, (self.batch_size, self.image_size, self.image_size, 3), np.uint8,
            ), device=self.device)
            n_batches = max(1, num_images // self.batch_size)
            for _ in range(max(warmup_batches, 1)):
                self._step(batch)
            self._synchronize()
            t0 = time.perf_counter()
            for _ in range(n_batches):
                self._step(batch)
            self._synchronize()
            return n_batches * self.batch_size / (time.perf_counter() - t0)

        imgs = [
            rng.randint(0, 255, (self.image_size, self.image_size, 3), np.uint8)
            for _ in range(num_images)
        ]
        for _ in zip(range(warmup_batches * self.batch_size), self.run(imgs)):
            pass
        t0 = time.perf_counter()
        n = sum(1 for _ in self.run(imgs))
        return n / (time.perf_counter() - t0)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
