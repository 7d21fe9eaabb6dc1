"""Detection requests: ``HeadDetector.predict_batch`` on a batch of images,
then ``get_pncc()`` on every result, offered at a fixed rate by one client.

Set-up renders a pool of scenes from the seed, builds the detector from the
configuration's checkpoint and serves ``warm_requests`` requests.  In the
window, request ``k`` is due at ``k * period_ms`` after the window opens and
is sent when due, or as soon as the one before it is done if that is later;
its latency runs from when it was due to when its last PNCC map is on the
host.  Requests due before the window closes are served and counted; the
metric is the 95th percentile of all of them.  A reservoir drawn from the
seed keeps ``check_requests`` requests' results, which the reference
judges after the window.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import checks, work
from benchmark.harness.core import Check, Window, held
from benchmark.harness.scenes import Scenes
from benchmark.harness.weights import checkpoint_state
from benchmark.reference import precision
from benchmark.reference.flame import FlameModel
from benchmark.reference.letterbox import letterbox_batch, letterbox_spec
from benchmark.reference.pipeline import (
    PnccTables,
    arch_from_dict,
    build_model,
    detect,
    require_port_arch,
)

BOX_FAULT_PX = 4.0  # the planted box fault's shift (``control_outputs``)


class Cell:
    def __init__(self, ctx):
        from head_detector_tpu_torch.detector import HeadDetector
        from head_detector_tpu_torch.models import get_arch

        t = ctx.traffic
        self.ctx = ctx
        require_port_arch(ctx.config, get_arch(ctx.config["name"]))
        scenes = Scenes(ctx.seed, t["pool"], t["scene_size"], t["max_heads"], ctx.device)
        self.pool = list(scenes.host_images())
        del scenes
        self.detector = HeadDetector(model=ctx.config["name"], image_size=t["image_size"],
                                     checkpoint=ctx.path(ctx.config["weights"]["checkpoint"]),
                                     device=ctx.device)
        self.sent = 0
        self.sample = checks.Reservoir(t["check_requests"], ctx.seed)
        for _ in range(t["warm_requests"]):
            self._request()
        self.latencies: List[float] = []

    def _images(self, k: int) -> List[int]:
        b = self.ctx.traffic["batch"]
        return [(k * b + i) % len(self.pool) for i in range(b)]

    def _request(self):
        k = self.sent
        self.sent += 1
        idx = self._images(k)
        with torch.profiler.record_function("api.predict_batch"):
            results = self.detector.predict_batch([self.pool[i] for i in idx],
                                                  self.ctx.traffic["confidence_threshold"])
        with torch.profiler.record_function("api.get_pncc"):
            maps = [r.get_pncc() for r in results]
        return k, idx, results, maps

    def window(self, seconds: float) -> Window:
        period = self.ctx.traffic["period_ms"] / 1e3
        t0 = time.perf_counter()
        n = 0
        service = 0.0  # seconds from each request's send to its last map
        while n * period < seconds:
            due = t0 + n * period
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent = time.perf_counter()
            item = self._request()
            done = time.perf_counter()
            self.latencies.append(done - due)
            service += done - sent
            self.sample.offer(lambda: item)
            n += 1
        lat = np.asarray(self.latencies) * 1e3
        late = float(np.mean(lat > self.ctx.traffic["period_ms"]))
        return Window(metrics={"detect_p95_ms": float(np.percentile(lat, 95))},
                      attempted=n, failed=0,
                      facts={"latencies_ms": lat, "requests": n, "late_share": late,
                             "images": n * self.ctx.traffic["batch"],
                             "service_seconds": service,
                             "seconds": time.perf_counter() - t0})

    def burst(self) -> None:
        import head_detector_tpu_torch.ops.rasterize as raster

        before = raster.pncc_render_cuda.launches
        self.burst_heads = []
        for _ in range(self.ctx.traffic["burst_requests"]):
            _, _, results, _ = self._request()
            self.burst_heads += [len(r.heads) for r in results if r.heads]
        self.burst_launches = raster.pncc_render_cuda.launches - before

    def work(self) -> Dict[str, float]:
        arch = arch_from_dict(self.ctx.config["arch"])
        tables = PnccTables("cpu")
        s = self.ctx.traffic["scene_size"]
        pncc_bytes = sum(work.pncc_render_bytes(n, 5023, int(tables.triangles.shape[0]), s, s)
                         for n in getattr(self, "burst_heads", []))
        return {"flops_per_image": work.deploy_forward_flops(arch, self.ctx.traffic["image_size"]),
                "pncc_render_bytes": float(pncc_bytes)}

    def counters(self) -> Dict[str, float]:
        return {"pncc_render_launches": float(getattr(self, "burst_launches", 0))}

    def judge(self) -> List[Check]:
        del self.detector
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        got = [(idx, [(np.array([[h.bbox.x, h.bbox.y, h.bbox.x + h.bbox.w, h.bbox.y + h.bbox.h]
                                  for h in r.heads], np.float32).reshape(-1, 4),
                       np.array([h.score for h in r.heads], np.float32),
                       {i: h.vertices_3d for i, h in enumerate(r.heads)}, m)
                      for r, m in zip(results, maps)])
               for _, idx, results, maps in self.sample.items]
        gaps = judge_detect(self.ctx, self.pool, got)
        self.numbers = gaps.numbers()
        print(f"detect check: {gaps.images} images, {gaps.pairs} matched heads",
              file=sys.stderr)
        return held(self.numbers, self.ctx.limits)


def reference_requests(ctx, pool, requests: List[List[int]]):
    """Per request (pool indices), per image the reference's detections in
    image pixels: (boxes [n, 4] rounded as the API rounds them, scores [n],
    vertices [n, V, 3]), in the precision the caller set."""
    t = ctx.traffic
    arch = arch_from_dict(ctx.config["arch"])
    model = build_model(arch, checkpoint_state(ctx.path(ctx.config["weights"]["checkpoint"]),
                                               ctx.device), ctx.device)
    flame = FlameModel.from_assets(device=ctx.device)
    s = t["image_size"]
    for idx in requests:
        originals = [pool[i] for i in idx]
        h, w = originals[0].shape[:2]
        spec = letterbox_spec(h, w, s)
        x = letterbox_batch(torch.as_tensor(np.stack(originals), device=ctx.device), s)
        pad = np.array([spec.pad_left, spec.pad_top], np.float32)
        images = []
        for d in detect(model, flame, x, t["confidence_threshold"], t["iou_threshold"],
                        t["pre_nms_max"], t["post_nms_max"]):
            boxes = np.rint((np.clip(d.boxes, 0, s) - np.tile(pad, 2)) / spec.scale)
            verts = d.verts.copy()
            verts[:, :, :2] -= pad
            verts /= spec.scale
            images.append((boxes, d.scores, verts))
        yield images


def judge_detect(ctx, pool, got) -> checks.DetectionGaps:
    """The reference over each request's images (float32, TF32 off) against
    ``got``: per request (pool indices, per image (boxes [n, 4] xyxy, scores
    [n], {n-index: vertices [V, 3]}, PNCC map)) in image pixels."""
    precision.set_float32(False)
    tables = PnccTables(ctx.device)
    gaps = checks.DetectionGaps(ctx.traffic["confidence_threshold"])
    want = reference_requests(ctx, pool, [idx for idx, _ in got])
    for (idx, images), want_images in zip(got, want):
        h, w = pool[idx[0]].shape[:2]
        for (boxes, scores, verts, pncc_map), (wboxes, wscores, wverts) in zip(images,
                                                                                want_images):
            gaps.add(boxes, scores, wboxes, wscores, verts, wverts)
            gaps.add_pncc(pncc_map, tables.render(wverts, h, w))
    return gaps


def control_outputs(ctx, pool, requests: List[List[int]], fault: str = "") -> list:
    """The control in the program's place: the reference with TF32 (one
    step below the configuration's float32 with TF32 off: the operands of
    every convolution and matmul rounded to TF32), its PNCC maps
    drawn by the plain z-buffer, in the format ``judge_detect`` reads.

    With ``fault``, the reference in float32 in the program's place with a
    fault planted where its answers are produced: ``box``, every box moved
    by ``BOX_FAULT_PX`` pixels right and down; ``half``, the results of
    every second image of a request left empty."""
    tf32 = not fault
    precision.set_float32(tf32)
    tables = PnccTables(ctx.device)
    out = []
    with precision.tf32_products() if tf32 else contextlib.nullcontext():
        for idx, images in zip(requests, reference_requests(ctx, pool, requests)):
            h, w = pool[idx[0]].shape[:2]
            results = []
            for k, (b, s, v) in enumerate(images):
                if fault == "box":
                    b = b + BOX_FAULT_PX
                elif fault == "half" and k % 2:
                    b, s, v = b[:0], s[:0], v[:0]
                results.append((b, s, dict(enumerate(v)), tables.render(v, h, w)))
            out.append((idx, results))
    precision.set_float32(False)
    return out
