"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build the CUDA kernels from ``head_detector_tpu_torch/csrc`` with nvcc;
   print the build time and the card's name and power limit;
2. each kernel against its plain torch version on the card, at the shapes
   the main path gives it, with its time, the plain version's time and the
   least time the card could take (bound);
3. the main path: ``HeadDetector`` (yolo_heads_m, the shipped checkpoint,
   640 px) ``predict_batch`` on 8 rendered scenes, then ``get_pncc`` on every
   result, with every kernel's launch count zeroed just before and read
   just after;
4. the port on the card against the port on the CPU (plain kernels) for one
   scene: box IoU >= 0.99, posed-vertex relative L2 <= 1e-3, PNCC maps equal
   on >= 99.9% of pixels;
5. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, where torch.cuda.is_available() is
False or the port's package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "flagship_ema.msgpack")
MODEL = "yolo_heads_m"
IMAGE_SIZE = 640
BATCH = 8
SCENE_SEED = 11  # the rendered scenes of the repo's benchmark inputs
MAX_HEADS = 3

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float ops per candidate pixel in the rasterizer's pass 1 (10 for the weights,
# 5 for the depth, 3 compares, key build) plus the per-triangle setup amortised
RASTER_OPS_PER_CANDIDATE = 24

HIT_AGREEMENT = 0.999  # the Pallas kernel's bar, tests/test_rasterize_pallas.py
COLOR_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_raster(got, want):
    """(hit agreement, max |color| difference on common hits)."""
    (gc, gh), (wc, wh) = got, want
    agree = (gh == wh).float().mean().item()
    common = gh & wh
    err = (gc - wc).abs()[common].max().item() if common.any() else 0.0
    return agree, err


def raster_candidates(verts: torch.Tensor, tris: torch.Tensor, h: int, w: int) -> int:
    """(head, triangle, pixel) candidates pass 1 tests for this data: the
    clamped integer bbox areas of the triangles (degenerate ones included,
    which pass 1 skips, so this errs high)."""
    tv = verts[:, tris.long()]
    x0 = torch.ceil(tv[..., 0].amin(-1)).clamp(min=0)
    x1 = torch.floor(tv[..., 0].amax(-1)).clamp(max=w - 1)
    y0 = torch.ceil(tv[..., 1].amin(-1)).clamp(min=0)
    y1 = torch.floor(tv[..., 1].amax(-1)).clamp(max=h - 1)
    area = ((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0))
    return int(area.sum().item())


def pncc_heads(flame_model, n_heads: int, size: int):
    """[n, V, 3] camera-facing PNCC meshes of seeded FLAME heads."""
    from head_detector_tpu_torch.flame import reproject_spatial_vertices

    rng = np.random.RandomState(2024)
    params = rng.randn(n_heads, 413).astype(np.float32) * 0.1
    params[:, 409:411] = rng.uniform(0.2 * size, 0.8 * size, (n_heads, 2))
    params[:, 411] = 0.0
    params[:, 412] = rng.uniform(0.2 * size, 0.6 * size, n_heads)
    _, _, proj = reproject_spatial_vertices(
        flame_model, torch.as_tensor(params, device=flame_model.device), to_2d=False
    )
    proj = proj.contiguous()
    proj[:, :, 2] *= -1
    return proj


def phase_kernels(flame_model):
    """Rasterizer kernel vs its plain version on the card."""
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.pncc import PNCCProcessor

    dev = flame_model.device
    proc = PNCCProcessor(device=dev)
    tris, colors = proc._triangles, proc._colors
    verts = pncc_heads(flame_model, 4, IMAGE_SIZE)
    n, nv, _ = verts.shape
    nf = tris.shape[0]

    def kernel(reverse=False):
        return r.rasterize_zbuffer_cuda(verts, tris, colors, IMAGE_SIZE, IMAGE_SIZE, reverse)

    def plain(reverse=False):
        return r.rasterize_zbuffer_plain(verts, tris, colors, IMAGE_SIZE, IMAGE_SIZE, reverse)

    worst_err, checks = 0.0, {}
    for reverse in (False, True):
        got, want = kernel(reverse), plain(reverse)
        torch.cuda.synchronize()
        agree, err = compare_raster(got, want)
        worst_err = max(worst_err, err)
        checks[f"pncc_4heads_reverse={reverse}"] = (agree, err)
        if not want[1].any():
            raise AssertionError("plain rasterizer hit nothing at PNCC shapes")

    # empty mesh: launches, hits nothing
    empty = r.rasterize_zbuffer_cuda(verts, tris[:0].contiguous(), colors, 64, 64)
    torch.cuda.synchronize()
    checks["empty_mesh"] = (float(not empty[1].any().item()), 0.0)

    # depth tie (two identical triangles: the lower index wins) and a
    # degenerate pair (collinear, duplicated vertex: covers nothing)
    v = torch.tensor([[[2, 2, 0.5], [30, 2, 0.5], [2, 30, 0.5], [2, 2, 0.5], [30, 2, 0.5],
                       [2, 30, 0.5], [1, 1, 0.9], [20, 20, 0.9], [10, 10, 0.9]]],
                     dtype=torch.float32, device=dev)
    t = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8], [6, 8, 8]], dtype=torch.int32,
                     device=dev)
    c = torch.zeros((9, 3), dtype=torch.float32, device=dev)
    c[:3, 0] = 1.0
    c[3:6, 1] = 1.0
    c[6:, 2] = 1.0
    tie_k = r.rasterize_zbuffer_cuda(v, t, c, 32, 32)
    tie_p = r.rasterize_zbuffer_plain(v, t, c, 32, 32)
    torch.cuda.synchronize()
    col = tie_k[0][0, 10, 10].tolist()
    tie_ok = col == [1.0, 0.0, 0.0] and not bool((tie_k[0][0, ..., 2] > 0).any())
    checks["depth_tie_and_degenerate"] = (float(tie_ok), compare_raster(tie_k, tie_p)[1])

    for name, (agree, err) in checks.items():
        log(f"  kernel check {name}: hit agreement {agree:.6f}, max |dcolor| {err:.3g}")
        if agree < HIT_AGREEMENT or err >= COLOR_TOL:
            raise AssertionError(f"rasterize kernel disagrees with plain: {name}")

    ms = time_ms(kernel)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    candidates = raster_candidates(verts, tris, IMAGE_SIZE, IMAGE_SIZE)
    bytes_moved = (verts.numel() + colors.numel()) * 4 + tris.numel() * 4 \
        + n * IMAGE_SIZE * IMAGE_SIZE * (3 * 4 + 1)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = candidates * RASTER_OPS_PER_CANDIDATE / FP32_FLOP_PER_S * 1e3
    log(f"  rasterize_zbuffer at PNCC shapes (heads={n}, V={nv}, F={nf}, "
        f"{IMAGE_SIZE}x{IMAGE_SIZE}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{candidates} candidate pixels, {bytes_moved} bytes in+out")
    return {
        "name": "rasterize_zbuffer",
        "route": "cuda",
        "source": "head_detector_tpu_torch/csrc/rasterize.cu",
        "replaces": "head_detector_tpu/ops/rasterize_pallas.py:241",
        "launches": None,  # filled from the main path's run
        "max_abs_err": worst_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }


def iou_xywh(a, b) -> float:
    ax2, ay2, bx2, by2 = a.x + a.w, a.y + a.h, b.x + b.w, b.y + b.h
    iw = max(0, min(ax2, bx2) - max(a.x, b.x))
    ih = max(0, min(ay2, by2) - max(a.y, b.y))
    inter = iw * ih
    return inter / max(a.w * a.h + b.w * b.h - inter, 1e-12)


def phase_main_path(detector, scenes):
    """predict_batch + get_pncc with the launch counts zeroed around it."""
    from head_detector_tpu_torch.ops import rasterize as r

    r.rasterize_zbuffer_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = detector.predict_batch(scenes, confidence_threshold=0.5)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pnccs = [res.get_pncc() for res in results]
    t2 = time.perf_counter()
    launches = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches}

    dets = [len(res.heads) for res in results]
    log(f"  detections per image: {dets}")
    log(f"  first call: detect {(t1 - t0) * 1e3 / len(scenes):.3f} ms/img, "
        f"PNCC {(t2 - t1) * 1e3 / len(scenes):.3f} ms/img")
    log(f"  launches on the main path: {launches}")
    for res, pncc in zip(results, pnccs):
        if pncc.shape != res.original_image.shape or pncc.dtype != np.uint8:
            raise AssertionError(f"PNCC map {pncc.shape} {pncc.dtype} for an image "
                                 f"{res.original_image.shape}")
        for head in res.heads:
            if head.vertices_3d.shape != (5023, 3) or not (
                np.isfinite(head.vertices_3d).all() and 0.0 < head.score <= 1.0
            ):
                raise AssertionError("a head has a malformed mesh or score")
        if res.heads and not pncc.any():
            raise AssertionError("PNCC map is empty for an image with heads")
    if sum(dets) == 0:
        raise AssertionError("no heads detected in any rendered scene")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # steady state, host clock around synchronised work
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        detector.predict_batch(scenes, confidence_threshold=0.5)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        for res in results:
            res.get_pncc()
    t2 = time.perf_counter()
    # the PNCC split: render (upload, kernel, download) vs the host composite
    proc = results[0].pncc_processor
    for _ in range(reps):
        for res in results:
            if res.heads:
                proc.render(res.heads, *res.original_image.shape[:2])
    t3 = time.perf_counter()
    n = reps * len(scenes)
    log(f"  steady state (batch {len(scenes)}, {reps} reps): detect "
        f"{(t1 - t0) * 1e3 / n:.3f} ms/img, PNCC {(t2 - t1) * 1e3 / n:.3f} ms/img, "
        f"of which render {(t3 - t2) * 1e3 / n:.3f} ms/img and host composite "
        f"{((t2 - t1) - (t3 - t2)) * 1e3 / n:.3f} ms/img")
    return results, launches


def phase_profile(detector, scenes):
    """Device time by kernel over one batch + PNCC (torch.profiler), and the
    share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for res in detector.predict_batch(scenes, confidence_threshold=0.5):
            res.get_pncc()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side events only (kernels, memcpy, memset), so nothing counts twice
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    log(f"  profiler: window {wall_ms:.3f} ms (batch {len(scenes)}, detect + PNCC, "
        f"profiled), device busy {busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}%, "
        f"{len(kernels)} distinct device ops")
    for e in sorted(kernels, key=lambda e: -device_us(e))[:10]:
        log(f"    {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def phase_card_vs_cpu(detector_gpu, scene):
    """One scene through the port on the card and on the CPU."""
    from head_detector_tpu_torch.detector import HeadDetector

    cpu = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=CHECKPOINT,
                       device="cpu")
    got = detector_gpu.predict_batch([scene])[0]
    want = cpu.predict_batch([scene])[0]
    if len(got.heads) != len(want.heads) or not want.heads:
        raise AssertionError(f"card found {len(got.heads)} heads, CPU {len(want.heads)}")
    worst_iou, worst_rel = 1.0, 0.0
    for hg, hw in zip(got.heads, want.heads):
        worst_iou = min(worst_iou, iou_xywh(hg.bbox, hw.bbox))
        worst_rel = max(worst_rel, float(
            np.linalg.norm(hg.vertices_3d - hw.vertices_3d) / np.linalg.norm(hw.vertices_3d)
        ))
    diff = np.abs(got.get_pncc().astype(int) - want.get_pncc().astype(int)).max(-1)
    pncc_agree = float((diff == 0).mean())
    log(f"  heads {len(got.heads)}: min box IoU {worst_iou:.6f}, max vertex rel L2 "
        f"{worst_rel:.3e}, PNCC pixels equal: {pncc_agree:.6f} "
        f"(within 1: {float((diff <= 1).mean()):.6f})")
    if worst_iou < 0.99 or worst_rel > 1e-3 or pncc_agree < 0.999:
        raise AssertionError("card and CPU disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from head_detector_tpu_torch import cuda_build
    from head_detector_tpu_torch.detector import HeadDetector
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.train.dataset import render_scene

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    path = cuda_build.build("rasterize")
    log(f"  built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    log(f"  card: {smi}")

    log("phase 2: kernels vs plain on the card")
    flame_model = FlameModel.from_assets(device=dev)
    entry = phase_kernels(flame_model)

    log("phase 3: main path")
    t0 = time.perf_counter()
    detector = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=CHECKPOINT,
                            device=dev)
    log(f"  restored {detector.restored_leaves[0]}/{detector.restored_leaves[1]} leaves, "
        f"detector ready in {time.perf_counter() - t0:.2f} s")
    scenes = [render_scene(SCENE_SEED, i, IMAGE_SIZE, MAX_HEADS, device=dev,
                           flame_model=flame_model) for i in range(BATCH)]
    _, launches = phase_main_path(detector, scenes)
    entry["launches"] = launches["rasterize_zbuffer"]
    try:
        phase_profile(detector, scenes)
    except RuntimeError as exc:  # the profiler is a reading, not a check
        log(f"  profiler: not measured ({exc})")

    log("phase 4: card vs CPU")
    phase_card_vs_cpu(detector, scenes[0])

    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
