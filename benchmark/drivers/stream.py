"""Streamed inference: ``StreamingDetector.run`` over a closed loop of host
images.

Set-up renders a pool of scenes from the seed and builds the detector from
the configuration's checkpoint.  The traffic is shards of ``shard_images``
images (the pool cycled), one ``run()`` call a shard, back to back: ``run()``
letterboxes its whole input ahead of the model (``Executor.map``), so a
shard bounds the host memory as a user's shard of files does.  Set-up
consumes ``warm_batches`` batches, so every shape and kernel is warm and the
pipeline is full when the window opens.  The window counts
the images ``run()`` emits until ``seconds`` have passed: images/s over the
whole window.  A reservoir drawn from the seed keeps ``check_images`` of the
emitted results, which the reference judges after the window.
"""

from __future__ import annotations

import itertools
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
from benchmark.reference.pipeline import (
    arch_from_dict,
    build_model,
    detect,
    head_indices,
    letterbox_host,
    require_port_arch,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Cell:
    def __init__(self, ctx):
        from head_detector_tpu_torch.models import get_arch
        from head_detector_tpu_torch.pipeline import StreamingDetector

        t = ctx.traffic
        self.ctx = ctx
        require_port_arch(ctx.config, get_arch(ctx.config["name"]))
        self.pool = Scenes(ctx.seed, t["pool"], t["scene_size"], t["max_heads"],
                           ctx.device).host_images()
        self.detector = StreamingDetector(
            model_name=ctx.config["name"], image_size=t["image_size"], batch_size=t["batch"],
            checkpoint=ctx.path(ctx.config["weights"]["checkpoint"]),
            confidence_threshold=t["confidence_threshold"], dtype=DTYPES[t["dtype"]],
            verts_dtype=DTYPES[t["verts_dtype"]], mesh_subset=t["mesh_subset"],
            decode_budget=t["decode_budget"], device=ctx.device)
        self.stream = self._shards()
        self.emitted = 0
        self.sample = checks.Reservoir(t["check_images"], ctx.seed)
        for _ in range(t["warm_batches"] * t["batch"]):
            self._next()

    def _shards(self):
        """The outputs of shard after shard, in input order: output ``k``
        is of pool image ``k % len(pool)``."""
        size = self.ctx.traffic["shard_images"]
        for shard in itertools.count():
            images = [self.pool[(shard * size + i) % len(self.pool)] for i in range(size)]
            yield from self.detector.run(images)

    def _next(self) -> dict:
        with torch.profiler.record_function("stream.next_image"):
            out = next(self.stream)
        self.emitted += 1
        return out

    def _keep(self, k: int, out: dict):
        verts = {s: v.clone() for s, v in (out["vertices"] or {}).items()}
        return (k, out["boxes_xyxy"].copy(), out["scores"].copy(), out["valid"].copy(), verts)

    def window(self, seconds: float) -> Window:
        n = 0
        t0 = time.perf_counter()
        while True:
            out = self._next()
            n += 1
            k = self.emitted - 1
            self.sample.offer(lambda: self._keep(k, out))
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return Window(metrics={"stream_images_per_s": n / elapsed}, attempted=n, failed=0,
                      facts={"images": n, "seconds": elapsed})

    def burst(self) -> None:
        for _ in range(self.ctx.traffic["burst_batches"] * self.ctx.traffic["batch"]):
            self._next()

    def work(self) -> Dict[str, float]:
        arch = arch_from_dict(self.ctx.config["arch"])
        return {"flops_per_image": work.deploy_forward_flops(arch,
                                                              self.ctx.traffic["image_size"])}

    def counters(self) -> Dict[str, float]:
        return {}

    def close(self) -> None:
        """Stop the stream and free the program's state."""
        self.stream.close()
        del self.stream, self.detector
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def judge(self) -> List[Check]:
        self.close()
        items = sorted(self.sample.items, key=lambda it: it[0] % len(self.pool))
        got = [(b[v], s[v], {i: verts[slot].float().cpu().numpy()
                             for i, slot in enumerate(np.flatnonzero(v)) if slot in verts})
               for _, b, s, v, verts in items]
        indices = [k % len(self.pool) for k, *_ in items]
        gaps = judge_stream(self.ctx, self.pool, indices, got)
        self.numbers = gaps.numbers()
        print(f"stream check: {gaps.images} images, {gaps.pairs} matched heads",
              file=sys.stderr)
        return held(self.numbers, self.ctx.limits)


def judge_stream(ctx, pool: np.ndarray, indices: List[int],
                 got: List[tuple]) -> checks.DetectionGaps:
    """The reference over the pool images ``indices`` (float32, TF32 off)
    against ``got``: per image (boxes [n, 4], scores [n], {n-index: head
    vertices}) in letterbox pixels."""
    t = ctx.traffic
    precision.set_float32(False)
    arch = arch_from_dict(ctx.config["arch"])
    model = build_model(arch, checkpoint_state(ctx.path(ctx.config["weights"]["checkpoint"]),
                                               ctx.device), ctx.device)
    flame = FlameModel.from_assets(device=ctx.device)
    head = head_indices()
    gaps = checks.DetectionGaps(t["confidence_threshold"])
    block = t["reference_batch"]
    for start in range(0, len(indices), block):
        idx = indices[start:start + block]
        canvases = np.stack([letterbox_host(pool[i], t["image_size"])[0] for i in idx])
        x = torch.as_tensor(canvases, device=ctx.device).to(torch.float32) / 255.0
        want = detect(model, flame, x, t["confidence_threshold"], t["iou_threshold"],
                      t["pre_nms_max"], t["post_nms_max"])
        for (boxes, scores, verts), w in zip(got[start:start + block], want):
            gaps.add(boxes, scores, w.boxes, w.scores, verts, w.verts[:, head])
    return gaps


def control_outputs(ctx, pool: np.ndarray, indices: List[int]) -> List[tuple]:
    """The control in the program's place, in the format ``judge_stream``
    reads: the reference one step below each precision the configuration
    states.  The network computes in bfloat16 (autocast), its convolutions
    on e4m3-rounded inputs and weights, below the configuration's bfloat16;
    the FLAME decode in bfloat16 (autocast), below the program's float32;
    each image's vertices are emitted rounded to e4m3, below the
    configuration's bfloat16 ``verts_dtype``."""
    t = ctx.traffic
    precision.set_float32(False)
    arch = arch_from_dict(ctx.config["arch"])
    model = build_model(arch, checkpoint_state(ctx.path(ctx.config["weights"]["checkpoint"]),
                                               ctx.device), ctx.device)
    flame = FlameModel.from_assets(device=ctx.device)
    head = head_indices()
    out = []
    for start in range(0, len(indices), t["reference_batch"]):
        idx = indices[start:start + t["reference_batch"]]
        canvases = np.stack([letterbox_host(pool[i], t["image_size"])[0] for i in idx])
        x = torch.as_tensor(canvases, device=ctx.device).to(torch.float32) / 255.0
        with precision.fp8_convolutions(), torch.autocast(ctx.device.type, torch.bfloat16):
            dets = detect(model, flame, x, t["confidence_threshold"], t["iou_threshold"],
                          t["pre_nms_max"], t["post_nms_max"])
        for d in dets:
            verts = d.verts[:, head]
            if len(verts):
                verts = precision.round_e4m3(torch.as_tensor(verts)).numpy()
            out.append((d.boxes, d.scores, dict(enumerate(verts))))
    return out
