"""StreamingDetector: batched inference over a stream of images.

Counterpart of ``head_detector_tpu/pipeline.py``.  ``devices`` is the
counterpart of its data-parallel ``mesh``: a list of devices, which may name
one device twice, each entry a replica with its own weights, copy stream
and pinned ring; the JAX rule picks the replicas (the largest divisor of
``batch_size`` no more than the list's length), each batch is split by rows
over them, and the results are emitted in input order.  By default there is
one replica, on ``device``.  Per batch:

1. host: a producer thread takes a free slot set (one pinned slot a
   replica) of a ring of ``pipeline_depth + 1`` and hands the batch's
   images to worker threads, which letterbox each straight into its row of
   the pinned slot with cv2 INTER_LINEAR (sized ``int(side * scale +
   0.5)``, centred, the border strips padded with 127; the native host
   library's letterbox under ``HDT_LETTERBOX=native`` or without cv2); a
   short last batch is padded with copies of its last image's row.  The
   ring is the backpressure: the workers run at most the ring ahead of the
   card;
2. upload: once the rows are written the producer enqueues each slot's copy
   to its card on a copy stream, after the last step that read the slot's
   device buffer, and queues the batch; the consumer (the calling thread)
   steps it at once, its compute stream waiting on the copy's event, and
   returns the slot set to the ring once the step is enqueued (on the CPU,
   where the slot is the step's input, once the step has returned).  The
   producer waits for a slot's last copy before it writes the slot's rows
   again, so no pinned row is rewritten while a copy may still read it and
   no device buffer is overwritten before the step that reads it;
3. step (compute stream): uint8 -> float32 / 255, the deploy forward in
   ``dtype``, fixed-size NMS, then the FLAME towers and the mesh decode (on
   the ``mesh_subset`` vertices, float32 LBS, output in ``verts_dtype``) for
   the top ``decode_budget`` detections of the batch;
4. emit: the small outputs come back into pinned buffers behind an event,
   read on the host after the event; ``pipeline_depth`` steps are in flight.

Each yielded dict holds ``boxes_xyxy`` [K, 4] (letterbox space), ``scores``
[K], ``valid`` [K] (numpy), ``vertices`` ``{nms_slot: [V_subset, 3] device
tensor}`` for the image's decoded detections, and ``scale``.  With several
replicas each decodes up to ``decode_budget`` detections of its rows, and
the emitted meshes are those of the batch's top ``decode_budget``
detections, the batch-wide compaction of one device.  The NMS waits
on the device once per suppression sweep, so the host cannot run further
ahead than the step being enqueued.

Under a profiler session (``profiling.py``) ``run()`` records, on the
calling thread, the spans ``pipeline.start`` (once a call),
``pipeline.feed_wait``, ``pipeline.upload`` (taking a staged batch: its
counts and the wait on its copy's event), ``pipeline.step`` and
``pipeline.emit`` with its child ``pipeline.emit_wait`` (once a batch, keyed
by the batch's index; none is open across a ``yield``), and counts each
batch it takes in ``pipeline.letterbox_images`` and the workers' time of
its images, the write into the slot included, in ``pipeline.letterbox_ns``.
The producer counts the slot sets it takes in ``pipeline.ring_fills`` and
the time it waited for them in ``pipeline.ring_wait_ns``, for the waits
that began inside the session (one that spans the session's start would
count the time before it).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import os
import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

try:
    import cv2
except ImportError:  # the native letterbox takes its place
    cv2 = None

from head_detector_tpu_torch.assets_io import get_indices
from head_detector_tpu_torch.detector import random_variables
from head_detector_tpu_torch.device import exact_float32, resolve_device
from head_detector_tpu_torch.flame import FlameModel, fused_project_vertices
from head_detector_tpu_torch.models import ArchCfg, build_model, get_arch, globalize_flame
from head_detector_tpu_torch.ops.nms import batched_nms, compact_detections
from head_detector_tpu_torch.ops.sparse_towers import sparse_flame_rows
from head_detector_tpu_torch.profiling import count, recording, span
from head_detector_tpu_torch.weights import count_leaves, load_variables, state_dict_from_flax


def letterbox_into(image: np.ndarray, out: np.ndarray) -> float:
    """Letterbox an HWC uint8 ``image`` into ``out`` (a [S, S, 3] uint8 row,
    written in place) and return its scale: cv2 INTER_LINEAR resized to
    ``int(side * scale + 0.5)``, centred, only the border strips set to 127;
    the native host library's letterbox under ``HDT_LETTERBOX=native`` or
    without cv2."""
    s = out.shape[0]
    if cv2 is None or os.environ.get("HDT_LETTERBOX") == "native":
        from head_detector_tpu_torch.native import letterbox_native

        return letterbox_native(image, s, out=out)[1]
    h, w = image.shape[:2]
    scale = min(s / h, s / w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    top, left = (s - nh) // 2, (s - nw) // 2
    picture = out[top:top + nh, left:left + nw]
    resized = cv2.resize(image, (nw, nh), dst=picture, interpolation=cv2.INTER_LINEAR)
    if resized is not picture:  # cv2 made its own array (another dtype or shape)
        picture[...] = resized
    out[:top] = out[top + nh:] = 127
    out[top:top + nh, :left] = out[top:top + nh, left + nw:] = 127
    return scale


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
        self.rows = self.host.numpy()  # the letterbox workers write these in place


class _Pending:
    """A step's outputs on their way to the host, of batch ``batch``."""

    def __init__(self, outputs, device: torch.device, batch: int):
        self.batch = batch
        boxes, scores, valid, mesh = outputs
        small = [boxes, scores, valid] + (list(mesh[:3]) if mesh is not None else [])
        self.verts = mesh[3] if mesh is not None else None
        if device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in small]
            for h, t in zip(self.host, small):
                h.copy_(t, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(device))
        else:
            self.host, self.done = small, None

    def numpy(self) -> List[np.ndarray]:
        if self.done is not None:
            self.done.synchronize()
        return [t.numpy() for t in self.host]


class _Replica:
    """One device's copy of the deploy network and of the FLAME tables."""

    def __init__(self, device: torch.device, arch, state: dict, dtype: torch.dtype,
                 mesh_subset: Optional[str]):
        net = build_model(arch, defer_globalization=True, skip_flame=True, dtype=dtype)
        net.load_state_dict(state, strict=True)
        self.device = device
        self.model = net.to(device).eval()
        self.flame = FlameModel.from_assets(device=device)
        self.decode_flame = (
            self.flame.subset(get_indices()[mesh_subset]) if mesh_subset else self.flame
        )


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
        devices: Optional[Sequence] = None,
    ):
        """``variables`` is a flax ``{params, batch_stats}`` tree of numpy
        arrays (training or deploy layout); ``checkpoint`` a flax msgpack
        file; with neither, the training-layout model is initialised at
        random (seed 0, BatchNorm calibrated at ``image_size``) and fused.
        ``devices`` (replicas, see the module docstring) overrides
        ``device``."""
        if image_size % 32:
            raise ValueError("image_size must be a multiple of 32")
        devices = [resolve_device(d) for d in (devices if devices else [device])]
        usable = max(d for d in range(1, len(devices) + 1) if batch_size % d == 0)
        devices = devices[:usable]
        self.device = devices[0]
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
        self.replicas = [_Replica(d, self.arch, state, dtype, mesh_subset) for d in devices]
        self.rows = batch_size // len(self.replicas)  # of a batch, in each replica

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _step(self, images_u8: torch.Tensor, slot: Optional[_Slot] = None,
              replica: Optional[_Replica] = None):
        """[B, S, S, 3] uint8 on the replica's device (the first replica by
        default) -> (boxes [B, K, 4], scores [B, K], valid [B, K],
        (batch_idx, slot_idx, valid, verts) of the ``decode_budget``
        compacted rows, or None)."""
        rep = replica or self.replicas[0]
        images = images_u8.to(torch.float32) / 255.0
        if slot is not None and slot.consumed is not None:
            # ``slot.dev`` may be overwritten after this
            slot.consumed.record(torch.cuda.current_stream(rep.device))
        with exact_float32():
            decoded, raw, feats = rep.model(
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
                rep.model.heads, self.arch, feats,
                cres.anchor_idx[None], batch_idx=cres.batch_idx[None],
            )[0]
            params = globalize_flame(rows, cres.anchor_idx, raw.anchor_points,
                                     raw.stride_tensor)
            _, verts = fused_project_vertices(rep.decode_flame, params, to_2d=False)
            return (res.boxes, res.scores, res.valid,
                    (cres.batch_idx, cres.slot_idx, cres.valid, verts.to(self.verts_dtype)))

    def _letterbox_host(self, image: np.ndarray) -> Tuple[np.ndarray, float]:
        out = np.empty((self.image_size, self.image_size, 3), np.uint8)
        return out, letterbox_into(image, out)

    @staticmethod
    def _letterbox_timed(image: np.ndarray, out: np.ndarray) -> Tuple[float, int]:
        """(scale, ns the worker spent on it) of ``letterbox_into``."""
        t0 = time.perf_counter_ns()
        scale = letterbox_into(image, out)
        return scale, time.perf_counter_ns() - t0

    def _stage(self, pool: cf.Executor, images: List[np.ndarray], slots: List[_Slot],
               copy_streams: list) -> Tuple[List[float], int]:
        """Letterbox a batch's ``images`` on ``pool`` straight into the rows
        of ``slots`` (one a replica; a short batch padded with copies of its
        last row) and enqueue each slot's copy to its device: (the images'
        scales, the workers' ns)."""
        for slot in slots:
            if slot.copied is not None:
                slot.copied.synchronize()  # the pinned rows' last copy has left
        rows = [row for slot in slots for row in slot.rows]
        done = [job.result() for job in
                [pool.submit(self._letterbox_timed, im, row) for im, row in zip(images, rows)]]
        for row in rows[len(images):]:
            row[...] = rows[len(images) - 1]
        for slot, stream in zip(slots, copy_streams):
            self._upload(slot, stream)
        return [scale for scale, _ in done], sum(ns for _, ns in done)

    @staticmethod
    def _upload(slot: _Slot, copy_stream) -> None:
        """Enqueue the copy of ``slot``'s host rows to its device, after the
        last step that read the device rows (nothing on the CPU)."""
        if copy_stream is not None:
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(slot.consumed)  # the last step has read it
                slot.dev.copy_(slot.host, non_blocking=True)
                slot.copied.record(copy_stream)

    def run(self, images: Iterable[np.ndarray]) -> Iterator[dict]:
        """Yield one dict per image (see the module docstring)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        free: "queue.Queue[int]" = queue.Queue()  # the ring's free slot sets
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def take() -> Optional[int]:
            while not stop.is_set():
                try:
                    return free.get(timeout=0.1)
                except queue.Empty:
                    pass
            return None

        def producer():
            pool = cf.ThreadPoolExecutor(self.workers)
            try:
                it = iter(images)
                while batch := list(itertools.islice(it, self.batch_size)):
                    timed = recording()  # a wait begun before the session is not counted
                    t0 = time.perf_counter_ns()
                    k = take()
                    if k is None:
                        return
                    if timed:
                        count("pipeline.ring_wait_ns", time.perf_counter_ns() - t0)
                        count("pipeline.ring_fills")
                    metas, ns = self._stage(pool, batch, ring[k], copy_streams)
                    if not put((k, metas, ns)):
                        return
                put(None)
            except Exception as exc:  # handed to the consumer, which raises it
                put(exc)
            finally:
                pool.shutdown(cancel_futures=True)

        with span("pipeline.start"):
            shape = (self.rows, self.image_size, self.image_size, 3)
            ring = [[_Slot(shape, r.device) for r in self.replicas]
                    for _ in range(self.pipeline_depth + 1)]
            copy_streams = [torch.cuda.Stream(r.device) if r.device.type == "cuda" else None
                            for r in self.replicas]
            for k in range(len(ring)):
                free.put(k)
            thread = threading.Thread(target=producer, daemon=True)
            thread.start()
        pending: "collections.deque[tuple]" = collections.deque()
        try:
            for t in itertools.count():
                with span("pipeline.feed_wait", t):
                    item = q.get()
                if isinstance(item, Exception):
                    raise item
                if item is None:
                    break
                k, metas, letterbox_ns = item
                with span("pipeline.upload", t):
                    count("pipeline.letterbox_images", len(metas))
                    count("pipeline.letterbox_ns", letterbox_ns)
                    for rep, slot in zip(self.replicas, ring[k]):
                        if slot.copied is not None:
                            torch.cuda.current_stream(rep.device).wait_event(slot.copied)
                with span("pipeline.step", t):
                    outs = [_Pending(self._step(slot.dev, slot, rep), rep.device, t)
                            for rep, slot in zip(self.replicas, ring[k])]
                free.put(k)  # every step that reads the set is enqueued
                pending.append((outs, metas))
                if len(pending) >= self.pipeline_depth:
                    yield from self._emit(*pending.popleft())
            while pending:
                yield from self._emit(*pending.popleft())
        finally:
            stop.set()
            thread.join()
            for slots in ring:  # a copy no step waited for still writes its slot
                for rep, slot in zip(self.replicas, slots):
                    if slot.copied is not None:
                        torch.cuda.current_stream(rep.device).wait_event(slot.copied)

    def _emit(self, outs: List[_Pending], metas: List[float]) -> Iterator[dict]:
        """The dicts of a batch, all built before the first is yielded."""
        emitted = []
        b = outs[0].batch
        with span("pipeline.emit", b):
            with span("pipeline.emit_wait", b):
                arrays = [out.numpy() for out in outs]
            kept = self._decoded_rows(arrays) if outs[0].verts is not None else None
            for i, scale in enumerate(metas):
                k, local = divmod(i, self.rows)
                boxes, scores, valid = arrays[k][:3]
                vertices = None
                if kept is not None:
                    batch_idx, slot_idx = arrays[k][3:5]
                    rows = np.flatnonzero(kept[k] & (batch_idx == local))
                    vertices = {int(slot_idx[j]): outs[k].verts[j] for j in rows}
                emitted.append({
                    "boxes_xyxy": boxes[local],
                    "scores": scores[local],
                    "valid": valid[local],
                    "vertices": vertices,
                    "scale": scale,
                })
        yield from emitted

    def _decoded_rows(self, arrays: List[List[np.ndarray]]) -> List[np.ndarray]:
        """Which compacted rows of each replica to emit: its valid ones, and
        with several replicas only the batch's top ``decode_budget`` by
        score, ties to the lower (image, slot) (``compact_detections``'s
        order over the whole batch)."""
        kept = [a[5].copy() for a in arrays]
        if len(arrays) == 1:
            return kept
        cand = []
        for k, (_, scores, _, batch_idx, slot_idx, mvalid) in enumerate(arrays):
            k_slots = scores.shape[1]
            for j in np.flatnonzero(mvalid):
                image = k * self.rows + batch_idx[j]
                cand.append((-scores[batch_idx[j], slot_idx[j]],
                             image * k_slots + slot_idx[j], k, j))
        for *_, k, j in sorted(cand)[self.decode_budget:]:
            kept[k][j] = False
        return kept
