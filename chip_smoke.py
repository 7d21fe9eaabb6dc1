"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build the CUDA kernels from ``head_detector_tpu_torch/csrc`` with nvcc;
   print the build time and the card's name and power limit;
2. both entry points of the rasterizer kernel (``rasterize_zbuffer``,
   ``pncc_render``) against their plain torch versions on the card, at the
   shapes the main path gives them (the meshes of the 8 scenes: full-mesh
   triangles for ``render_scene``, head_w_ears triangles for ``get_pncc``),
   at four seeded heads and at the awkward ones (reverse, empty
   mesh, depth tie, degenerate triangles, overlapping heads, a color that
   casts to 0, a head larger than the canvas, a 130 x 100 canvas), with the
   wrapper's time, the launches' time alone, the plain version's time and
   the least time the card could take (bound), read on the scene with the
   most heads;
3. the main path: 8 scenes from ``render_scene``, ``HeadDetector``
   (yolo_heads_m, the shipped checkpoint, 640 px) ``predict_batch`` on them,
   then ``get_pncc`` on every result, with every kernel's launch count
   zeroed just before and read just after;
4. the port on the card against the port on the CPU (plain kernels) for one
   scene: box IoU >= 0.99, posed-vertex relative L2 <= 1e-3, PNCC maps equal
   on >= 99.9% of pixels;
5. the detector options and the result API on the 8 scenes (launch counts
   zeroed around them): ``HeadDetector(compact_wire=8,
   wire_verts_dtype="f16", param_fusion=True)`` keeps the default detector's
   boxes and scores, its compact ``__call__`` equals a fused detector without
   a compact wire on every scene (<= 8 heads), float16 vertices within
   0.25 px; ``get_pncc``, ``draw("full")``, ``get_aligned_heads()``,
   ``save_meshes`` and ``aligned_heads_batched`` on every result in host
   ms/img; ``aligned_heads_batched`` on the card against the CPU within 1e-3;
6. streaming: ``StreamingDetector`` (yolo_heads_m, 1024 px, batch 32,
   bfloat16, ``head`` vertices in bfloat16, decode budget 256) images/s of
   ``run()`` over 64 scenes rendered at 1024 px (counts zeroed before the
   rendering), of ``throughput(256)`` host-fed and device-fed, the device's
   busy share in a profiled ``run()``; card against CPU at float32 on a
   batch of 4 scenes (box IoU >= 0.99, vertex relative L2 <= 1e-3) and card
   bfloat16 against card float32 on it (box IoU >= 0.95, score |d| <= 2e-2);
7. training: ``python -m head_detector_tpu_torch.train``'s trainer
   (``build_trainer``: ``--config-name yolo_heads_m dataset_params.render=
   true pretrained_weights=checkpoints/flagship_ema.msgpack``) at 640 px,
   batch 8, bfloat16, on ``SyntheticHeadsDataset(render=True)`` (64
   training and 16 validation scenes): the key-matching restore, one epoch
   of 8 steps, validation and a checkpoint, then a second trainer resumed
   from that checkpoint (its step, EMA and Adam moments equal to the saved
   ones) for 8 more steps, with the rasterizer's launch count zeroed before
   and read after; ms per step, images/s fed by the loader (rendering in
   its threads) and device-fed, peak memory, every loss component at the
   first and last step, the validation metrics, the busy share of a
   profiled step; then one float32 step (TF32 off) of the M checkpoint at
   320 px, batch 2, on the card against the CPU: loss components to
   relative 1e-4, every parameter's gradient to relative L2 1e-3 (the
   biases that only shift a channel before a train-mode BatchNorm have an
   exact gradient of 0: both sides are held under 1e-5 of the largest
   gradient there);
8. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, where torch.cuda.is_available() is
False or the port's package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
# float ops per (triangle, pixel of its box) test: 10 for the weights, 5 for
# the depth, the compares, plus the per-triangle setup amortised
RASTER_OPS_PER_CANDIDATE = 24

TRAIN_SIZE = 640
TRAIN_BATCH = 8
TRAIN_LENGTH = 64
VAL_LENGTH = 16
TIMED_STEPS = 8
CHECK_SIZE = 320
CHECK_BATCH = 2
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-3
SHIFT_BEFORE_BN = ("branch_3x3_bn.bias", "branch_1x1.bias", "upsample.bias")

STREAM_SIZE = 1024
STREAM_BATCH = 32
STREAM_SCENES = 64

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


def time_ms(fn, launches: int = 100, readings: int = 5, warmup: int = 10):
    """(median, lowest, highest) device time of one call of ``fn`` in ms: each
    reading is ``launches`` calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(readings):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        got.append(start.elapsed_time(end) / launches)
    return float(np.median(got)), min(got), max(got)


def graph_ms(fn, launches: int = 20, replays: int = 10, readings: int = 5):
    """(median, lowest, highest) time of one call of ``fn`` on the device
    alone, in ms: a CUDA graph of ``launches`` calls, replayed ``replays``
    times between two events for each reading, so no reading waits for the
    host (``launches * replays`` calls a reading)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    got = []
    for _ in range(readings):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        got.append(start.elapsed_time(end) / (launches * replays))
    return float(np.median(got)), min(got), max(got)


def compare_raster(got, want):
    """(hit agreement, max |color| difference on common hits)."""
    (gc, gh), (wc, wh) = got, want
    agree = (gh == wh).float().mean().item()
    common = gh & wh
    err = (gc - wc).abs()[common].max().item() if common.any() else 0.0
    return agree, err


def raster_candidates(verts: torch.Tensor, tris: torch.Tensor, h: int, w: int) -> int:
    """(head, triangle, pixel) tests the function needs for this data: the
    clamped integer bbox areas of the triangles (degenerate ones included,
    which cover nothing, so this errs high)."""
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


def filling_head(verts: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[1, V, 3]: the first head scaled about its centre to twice the canvas."""
    xy = verts[0, :, :2]
    lo, hi = xy.amin(0), xy.amax(0)
    out = verts[:1].clone()
    out[0, :, :2] = (xy - (lo + hi) / 2) * (2.0 * max(height, width) / (hi - lo).min()) \
        + torch.tensor([width / 2, height / 2], device=verts.device)
    return out


def check_zbuffer(r, name, args, height, width, reverse=False):
    """Kernel vs plain for one input -> (kernel's, plain's, max |color| difference)."""
    got = r.rasterize_zbuffer_cuda(*args, height, width, reverse)
    want = r.rasterize_zbuffer_plain(*args, height, width, reverse)
    torch.cuda.synchronize()
    agree, err = compare_raster(got, want)
    log(f"  rasterize_zbuffer {name}: hit agreement {agree:.6f}, max |dcolor| {err:.3g}, "
        f"{int(want[1].sum())} pixels hit")
    if agree < HIT_AGREEMENT or err >= COLOR_TOL:
        raise AssertionError(f"rasterize_zbuffer kernel disagrees with plain: {name}")
    return got, want, err


def check_pncc(r, name, args, height, width, need_pixels=True) -> int:
    """Kernel vs plain for one input: every uint8 pixel must be equal.
    Returns the largest |difference| of a channel (0 when it passes)."""
    got = r.pncc_render_cuda(*args, height, width)
    want = r.pncc_render_plain(*args, height, width)
    torch.cuda.synchronize()
    delta = (got.to(torch.int32) - want.to(torch.int32)).abs()
    differ, worst = int(delta.any(-1).sum()), int(delta.max())
    log(f"  pncc_render {name}: {differ} of {height * width} pixels differ (max |d| {worst}), "
        f"{int(want.any(-1).sum())} pixels drawn")
    if differ or tuple(got.shape) != (height, width, 3) or got.dtype != torch.uint8:
        raise AssertionError(f"pncc_render kernel disagrees with plain: {name}")
    if need_pixels and not want.any():
        raise AssertionError(f"pncc_render drew nothing: {name}")
    return worst


def time_entry(r, name, where, verts, tris, colors, size):
    """Times of one entry point on one input: the wrapper call (allocations
    and checks inside), the launches alone on preallocated outputs and scratch
    (from Python in a loop, and replayed from a CUDA graph: the device alone),
    the plain version, and the least time the card could take for these inputs
    (bytes in + out once over the memory rate, or the candidate tests over
    the float32 rate)."""
    n, dev = verts.shape[0], verts.device
    scratch = r.alloc_scratch(verts, tris)
    if name == "rasterize_zbuffer":
        canvas = torch.empty((n, size, size, 3), dtype=torch.float32, device=dev)
        hit = torch.empty((n, size, size), dtype=torch.bool, device=dev)
        wrapper = lambda: r.rasterize_zbuffer_cuda(verts, tris, colors, size, size)
        launch = lambda: r.launch_rasterize_zbuffer(verts, tris, colors, scratch, canvas, hit)
        plain = lambda: r.rasterize_zbuffer_plain(verts, tris, colors, size, size)
        out_bytes = n * size * size * (3 * 4 + 1)
    else:
        rgb = torch.empty((size, size, 3), dtype=torch.uint8, device=dev)
        wrapper = lambda: r.pncc_render_cuda(verts, tris, colors, size, size)
        launch = lambda: r.launch_pncc_render(verts, tris, colors, scratch, rgb)
        plain = lambda: r.pncc_render_plain(verts, tris, colors, size, size)
        out_bytes = size * size * 3
    ms = time_ms(wrapper)
    loop_ms = time_ms(launch)
    device_ms = graph_ms(launch)
    ms_again = time_ms(wrapper)  # wrapper, launches, wrapper: the spread within a run
    plain_ms = time_ms(plain, launches=3, readings=3, warmup=1)
    candidates = raster_candidates(verts, tris, size, size)
    moved = (verts.numel() + colors.numel() + tris.numel()) * 4 + out_bytes
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = candidates * RASTER_OPS_PER_CANDIDATE / FP32_FLOP_PER_S * 1e3
    log(f"  {name} at {where} (heads={n}, F={tris.shape[0]}, {size}x{size}): wrapper "
        f"{ms[0]:.4f} ms (readings {ms[1]:.4f}-{ms[2]:.4f}; again {ms_again[0]:.4f}, "
        f"{ms_again[1]:.4f}-{ms_again[2]:.4f}), launches alone {loop_ms[0]:.4f} ms "
        f"({loop_ms[1]:.4f}-{loop_ms[2]:.4f}) in a loop, {device_ms[0]:.4f} ms "
        f"({device_ms[1]:.4f}-{device_ms[2]:.4f}) from a graph, plain {plain_ms[0]:.3f} ms; "
        f"{candidates} candidate pixels, {moved} bytes in+out, "
        f"bound {max(t_bytes, t_ops):.5f} ms")
    return {
        "name": name,
        "route": "cuda",
        "source": "head_detector_tpu_torch/csrc/rasterize.cu",
        "replaces": "head_detector_tpu/ops/rasterize_pallas.py:241",
        "launches": None,  # filled from the main path's run
        "max_abs_err": None,  # filled from the checks against plain
        "ms": ms[0],
        "ms_spread": [ms[1], ms[2]],
        "device_ms": device_ms[0],
        "device_ms_spread": [device_ms[1], device_ms[2]],
        "plain_ms": plain_ms[0],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
        "timed_at": f"{where}: heads={n}, V={verts.shape[1]}, F={tris.shape[0]}, {size}x{size}",
    }


def phase_kernels(flame_model):
    """Both entry points of the rasterizer kernel vs their plain versions."""
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.pncc import PNCCProcessor
    from head_detector_tpu_torch.train.dataset import scene_params, scene_tables, scene_vertices

    dev = flame_model.device
    size = IMAGE_SIZE
    proc = PNCCProcessor(device=dev)
    tris = torch.as_tensor(proc.triangles, device=dev)
    colors = torch.as_tensor(proc.colors, dtype=torch.float32, device=dev)
    verts = pncc_heads(flame_model, 4, size)
    nv = verts.shape[1]

    # what the main path gives the kernel: render_scene hands rasterize_zbuffer
    # the scene's 1..3 heads with the full mesh's triangles, get_pncc hands
    # pncc_render the detected heads (those of the scene) with the
    # head_w_ears triangles; both at 640 x 640
    scene_tris, scene_colors = scene_tables(dev)
    scenes = [scene_vertices(scene_params(SCENE_SEED, i, size, MAX_HEADS)[0], flame_model)
              for i in range(BATCH)]
    fullest = max(scenes, key=lambda v: v.shape[0])  # the first scene with the most heads
    log(f"  main-path shapes: heads per scene {[v.shape[0] for v in scenes]}, V={nv}, "
        f"render_scene F={scene_tris.shape[0]}, PNCC F={tris.shape[0]}, {size}x{size}")

    # two heads 6 px apart (they overlap), one head scaled about its centre
    # to twice the canvas (it fills the canvas; on 130 x 100 the tiles are
    # ragged), and colors of which most are black (hit pixels whose uint8
    # color is 0)
    overlapping = torch.cat([verts[:2], verts[:1] + torch.tensor([6.0, 3.0, 0.0], device=dev)])
    blackened = colors * (torch.rand((nv, 1), device=dev,
                                     generator=torch.Generator(dev).manual_seed(3)) > 0.6)

    zbuffer_err = 0.0
    for name, args, h, w, reverse, cover in [
        (f"scene {i}", (v, scene_tris, scene_colors), size, size, False, 0.0)
        for i, v in enumerate(scenes)
    ] + [
        ("fullest scene, reverse", (fullest, scene_tris, scene_colors), size, size, True, 0.0),
        ("PNCC shapes", (verts, tris, colors), size, size, False, 0.0),
        ("PNCC shapes, reverse", (verts, tris, colors), size, size, True, 0.0),
        ("head filling the canvas", (filling_head(verts, size, size), tris, colors), size, size,
         False, 0.5),
        ("130 x 100 canvas", (filling_head(verts, 100, 130), tris, colors), 100, 130, False, 0.5),
        ("130 x 100 canvas, reverse", (filling_head(verts, 100, 130), tris, colors), 100, 130,
         True, 0.5),
    ]:
        _, want, err = check_zbuffer(r, name, args, h, w, reverse)
        zbuffer_err = max(zbuffer_err, err)
        if not want[1].any() or float(want[1].float().mean()) < cover:
            raise AssertionError(f"plain rasterizer hit too little: {name}")

    empty, _, _ = check_zbuffer(r, "empty mesh", (verts, tris[:0].contiguous(), colors), 64, 64)
    if empty[1].any():
        raise AssertionError("an empty mesh hit a pixel")

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
    tie, _, err = check_zbuffer(r, "depth tie and degenerate", (v, t, c), 32, 32)
    zbuffer_err = max(zbuffer_err, err)
    if tie[0][0, 10, 10].tolist() != [1.0, 0.0, 0.0] or bool((tie[0][0, ..., 2] > 0).any()):
        raise AssertionError("depth tie or degenerate triangle drawn wrongly")

    canvas, hit = r.rasterize_zbuffer_plain(overlapping, tris, blackened, size, size)
    if not bool((hit.sum(0) >= 2).any()):
        raise AssertionError("the overlapping heads do not overlap")
    if not bool((hit & ((255.0 * canvas).to(torch.uint8).sum(-1, dtype=torch.int32) == 0)).any()):
        raise AssertionError("no hit pixel has a uint8 color of 0")
    pncc_err = 0
    for name, args, h, w in [
        (f"scene {i}", (v, tris, colors), size, size) for i, v in enumerate(scenes)
    ] + [
        ("PNCC shapes", (verts, tris, colors), size, size),
        ("overlapping heads", (overlapping, tris, colors), size, size),
        ("colors that cast to 0", (overlapping, tris, blackened), size, size),
        ("head filling the canvas", (filling_head(verts, size, size), tris, colors), size, size),
        ("130 x 100 canvas", (filling_head(verts, 100, 130), tris, colors), 100, 130),
    ]:
        pncc_err = max(pncc_err, check_pncc(r, name, args, h, w))
    pncc_err = max(pncc_err, check_pncc(r, "empty mesh", (verts, tris[:0].contiguous(), colors),
                                        64, 64, need_pixels=False))

    # the rows of the kernels line are timed at the main path's shapes; the
    # four seeded heads give readings that compare with earlier ones
    entries = [
        time_entry(r, "rasterize_zbuffer", "the fullest scene of render_scene", fullest,
                   scene_tris, scene_colors, size),
        time_entry(r, "pncc_render", "the fullest scene's heads", fullest, tris, colors, size),
    ]
    entries[0]["max_abs_err"] = zbuffer_err
    entries[1]["max_abs_err"] = float(pncc_err)
    for name in ("rasterize_zbuffer", "pncc_render"):
        time_entry(r, name, "four seeded heads, PNCC triangles", verts, tris, colors, size)
    return entries


def iou_xywh(a, b) -> float:
    ax2, ay2, bx2, by2 = a.x + a.w, a.y + a.h, b.x + b.w, b.y + b.h
    iw = max(0, min(ax2, bx2) - max(a.x, b.x))
    ih = max(0, min(ay2, by2) - max(a.y, b.y))
    inter = iw * ih
    return inter / max(a.w * a.h + b.w * b.h - inter, 1e-12)


def phase_main_path(detector, flame_model):
    """render_scene + predict_batch + get_pncc with the launch counts zeroed
    around them."""
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.train.dataset import render_scene

    dev = detector.device
    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    torch.cuda.synchronize()
    scenes = [render_scene(SCENE_SEED, i, IMAGE_SIZE, MAX_HEADS, device=dev,
                           flame_model=flame_model) for i in range(BATCH)]
    t0 = time.perf_counter()
    results = detector.predict_batch(scenes, confidence_threshold=0.5)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pnccs = [res.get_pncc() for res in results]
    t2 = time.perf_counter()
    launches = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                "pncc_render": r.pncc_render_cuda.launches}

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
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        detector.predict_batch(scenes, confidence_threshold=0.5)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        for res in results:
            res.get_pncc()
    t2 = time.perf_counter()
    # the PNCC split: the card's leg (vertex upload, kernel, canvas download)
    # against the rest on the host (stacking the meshes, the output image)
    proc = results[0].pncc_processor
    tris = torch.as_tensor(proc.triangles, device=dev)
    colors = torch.as_tensor(proc.colors, dtype=torch.float32, device=dev)
    meshes = [(np.stack([h.vertices_3d for h in res.heads]).astype(np.float32)
               * np.float32([1, 1, -1]), res.original_image.shape[:2])
              for res in results if res.heads]
    r.pncc_render(torch.as_tensor(meshes[0][0], device=dev), tris, colors, *meshes[0][1])
    t3 = time.perf_counter()
    for _ in range(reps):
        for mesh, (height, width) in meshes:
            r.pncc_render(torch.as_tensor(mesh, device=dev), tris, colors, height, width).cpu()
    t4 = time.perf_counter()
    n = reps * len(scenes)
    log(f"  steady state (batch {len(scenes)}, {reps} reps): detect "
        f"{(t1 - t0) * 1e3 / n:.3f} ms/img, PNCC {(t2 - t1) * 1e3 / n:.3f} ms/img, "
        f"of which upload + kernel + download {(t4 - t3) * 1e3 / n:.3f} ms/img and the "
        f"host remainder {((t2 - t1) - (t4 - t3)) * 1e3 / n:.3f} ms/img")
    return scenes, launches


def profile_window(label, fn):
    """Device time by kernel over ``fn()`` (torch.profiler) and the share of
    the window the device was busy; returns that share (None where the
    profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side events only (kernels, memcpy, memset), so nothing counts twice
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    log(f"  profiler: window {wall_ms:.3f} ms ({label}, profiled), device busy "
        f"{busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}%, {len(kernels)} distinct device ops")
    for e in sorted(kernels, key=lambda e: -device_us(e))[:10]:
        log(f"    {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    for e in kernels:  # the port's own kernels, wherever they rank
        if any(k in e.key for k in ("setup_kernel", "raster_zbuffer", "pncc_render")):
            log(f"    own kernel: {device_us(e) / e.count:9.3f} us each x{e.count:<4d} "
                f"{e.key[:70]}")
    return busy_ms / wall_ms if kernels else None


def phase_profile(detector, scenes):
    """One batch + PNCC under the profiler."""
    def batch_and_pncc():
        for res in detector.predict_batch(scenes, confidence_threshold=0.5):
            res.get_pncc()

    profile_window(f"batch {len(scenes)}, detect + PNCC", batch_and_pncc)


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


def same_detections(got, want, name):
    """Equal boxes and scores, head by head, on every image."""
    for i, (g, w) in enumerate(zip(got, want)):
        if [tuple(h.bbox) for h in g.heads] != [tuple(h.bbox) for h in w.heads] or \
                [h.score for h in g.heads] != [h.score for h in w.heads]:
            raise AssertionError(f"{name}: detections differ on image {i}")


def max_vertex_px(got, want) -> float:
    return max((float(np.abs(hg.vertices_3d - hw.vertices_3d).max())
                for g, w in zip(got, want) for hg, hw in zip(g.heads, w.heads)), default=0.0)


def phase_options_and_results(detector, scenes):
    """The detector options and the result API at full width."""
    from head_detector_tpu_torch.detection_result import PredictionResult
    from head_detector_tpu_torch.detector import HeadDetector
    from head_detector_tpu_torch.evaluation.head_alignment import aligned_heads_batched
    from head_detector_tpu_torch.ops import rasterize as r

    dev = detector.device
    kw = dict(model=MODEL, image_size=IMAGE_SIZE, checkpoint=CHECKPOINT, device=dev)
    opt = HeadDetector(compact_wire=8, wire_verts_dtype="f16", param_fusion=True, **kw)
    fused = HeadDetector(param_fusion=True, **kw)
    plain = detector.predict_batch(scenes, confidence_threshold=0.5)

    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = opt.predict_batch(scenes, confidence_threshold=0.5)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    single = [opt(scene, confidence_threshold=0.5) for scene in scenes]
    t2 = time.perf_counter()
    pnccs = [res.get_pncc() for res in batch]
    launches = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                "pncc_render": r.pncc_render_cuda.launches}
    t3 = time.perf_counter()
    opt.predict_batch(scenes, confidence_threshold=0.5)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    for scene in scenes:
        opt(scene, confidence_threshold=0.5)
    t5 = time.perf_counter()
    n = len(scenes)
    log(f"  options detector: predict_batch {(t1 - t0) * 1e3 / n:.3f} ms/img, __call__ "
        f"{(t2 - t1) * 1e3 / n:.3f} ms/img (first calls); again {(t4 - t3) * 1e3 / n:.3f} and "
        f"{(t5 - t4) * 1e3 / n:.3f} ms/img; launches on this path: {launches}")
    if launches["pncc_render"] <= 0 or not any(p.any() for p in pnccs):
        raise AssertionError("get_pncc on the options detector's results launched nothing")

    same_detections(batch, plain, "param fusion against the default detector")
    heads = [len(res.heads) for res in single]
    if max(heads) > 8:
        raise AssertionError(f"a scene has more than 8 heads: {heads}")
    want_single = [fused(scene, confidence_threshold=0.5) for scene in scenes]
    same_detections(single, want_single, "compact wire against no compact wire")
    # the same rows in both (budget 16 an image): the difference is the cast
    want_batch = fused.predict_batch(scenes, confidence_threshold=0.5)
    f16_px = max_vertex_px(batch, want_batch)
    # 8 rows against 100: the towers' convolutions see another batch size
    call_px = max_vertex_px(single, want_single)
    moved = max_vertex_px(want_batch, plain)
    log(f"  param fusion keeps {sum(len(b.heads) for b in batch)} detections (boxes and scores "
        f"equal), moves vertices by up to {moved:.3f} px; compact wire (8) equal on scenes with "
        f"{heads} heads (vertices within {call_px:.5f} px, float16 included); float16 vertices "
        f"within {f16_px:.5f} px of the same float32 rows")
    if f16_px > 0.25 or call_px > 0.26:
        raise AssertionError(f"float16 vertices off by {f16_px} px ({call_px} px in __call__)")

    n = len(batch)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in [
            ("draw(full)", lambda res, i: res.draw("full")),
            ("get_aligned_heads", lambda res, i: res.get_aligned_heads()),
            ("save_meshes", lambda res, i: res.save_meshes(os.path.join(tmp, str(i)))),
            ("aligned_heads_batched", lambda res, i: aligned_heads_batched(res)),
        ]:
            outs = [fn(res, i) for i, res in enumerate(batch)]  # first calls
            t0 = time.perf_counter()
            outs = [fn(res, i) for i, res in enumerate(batch)]
            times[name] = (time.perf_counter() - t0) * 1e3 / n
            if name == "aligned_heads_batched":
                crops = outs
        objs = sum(len(files) for _, _, files in os.walk(tmp))
    log("  host ms/img over the 8 results: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f" ({sum(len(b.heads) for b in batch)} heads, {objs} OBJ files)")
    worst = 0.0
    for res, got in zip(batch, crops):
        cpu = PredictionResult(res.original_image, res.heads, device="cpu")
        want = aligned_heads_batched(cpu)
        if got.shape != want.shape:
            raise AssertionError(f"aligned crops {got.shape} on the card, {want.shape} on the CPU")
        if got.size:
            worst = max(worst, float(np.abs(got - want).max()))
    log(f"  aligned_heads_batched card vs CPU: max |d| {worst:.3g} (0-255 scale)")
    if worst > 1e-3:
        raise AssertionError("aligned_heads_batched differs between the card and the CPU")
    return launches, times


def match_streams(got, want):
    """(worst box IoU, worst score |d|, matched) of ``want``'s valid
    detections against ``got``'s, matched by IoU, image by image."""
    worst_iou, worst_score, matched = 1.0, 0.0, 0
    for g, w in zip(got, want):
        gb, gs = g["boxes_xyxy"][g["valid"]], g["scores"][g["valid"]]
        for box, score in zip(w["boxes_xyxy"][w["valid"]], w["scores"][w["valid"]]):
            if not len(gb):
                return 0.0, 1.0, matched
            lt = np.maximum(box[:2], gb[:, :2])
            rb = np.minimum(box[2:], gb[:, 2:])
            inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
            area = np.prod(box[2:] - box[:2]) + np.prod(gb[:, 2:] - gb[:, :2], axis=1) - inter
            ious = inter / np.maximum(area, 1e-12)
            k = int(np.argmax(ious))
            worst_iou = min(worst_iou, float(ious[k]))
            worst_score = max(worst_score, abs(float(gs[k] - score)))
            matched += 1
    return worst_iou, worst_score, matched


def stream_layers(stream, scenes):
    """The streaming layers one at a time on one batch: host letterbox (one
    thread), the copy into a pinned buffer and on to the card, the step
    (forward, NMS, mesh decode), the download and emission."""
    from head_detector_tpu_torch.pipeline import _Pending, _Slot

    dev = stream.device
    canvases = [stream._letterbox_host(im)[0] for im in scenes]
    t0 = time.perf_counter()
    canvases = [stream._letterbox_host(im)[0] for im in scenes]
    t1 = time.perf_counter()
    slot = _Slot((len(scenes),) + canvases[0].shape, dev)
    copy_stream = torch.cuda.Stream(dev)
    stream._upload(slot, canvases, copy_stream)
    slot.copied.synchronize()
    t2 = time.perf_counter()
    stream._upload(slot, canvases, copy_stream)
    t3 = time.perf_counter()
    slot.copied.synchronize()
    t4 = time.perf_counter()
    torch.cuda.current_stream(dev).wait_event(slot.copied)
    stream._step(slot.dev, slot)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    out = stream._step(slot.dev, slot)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    emitted = list(stream._emit(_Pending(out, [1.0] * len(scenes), dev)))
    t7 = time.perf_counter()
    n = len(emitted)
    log(f"  layers on one batch of {n}: letterbox {(t1 - t0) * 1e3 / n:.3f} ms/img on one "
        f"thread, pinned copy {(t3 - t2) * 1e3:.3f} ms + to the card {(t4 - t3) * 1e3:.3f} ms, "
        f"step {(t6 - t5) * 1e3:.3f} ms, download + emit {(t7 - t6) * 1e3:.3f} ms a batch")


def phase_streaming(flame_model):
    """StreamingDetector at full width: images/s, busy share, card vs CPU."""
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.pipeline import StreamingDetector
    from head_detector_tpu_torch.train.dataset import render_scene

    dev = flame_model.device
    kw = dict(model_name=MODEL, checkpoint=CHECKPOINT, image_size=STREAM_SIZE,
              mesh_subset="head", decode_budget=256)
    t0 = time.perf_counter()
    stream = StreamingDetector(batch_size=STREAM_BATCH, dtype=torch.bfloat16,
                               verts_dtype=torch.bfloat16, device=dev, **kw)
    log(f"  StreamingDetector ready in {time.perf_counter() - t0:.2f} s")

    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    torch.cuda.synchronize()
    scenes = [render_scene(SCENE_SEED, i, STREAM_SIZE, MAX_HEADS, device=dev,
                           flame_model=flame_model) for i in range(STREAM_SCENES)]
    out = list(stream.run(scenes))  # first run: cuDNN picks its algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(stream.run(scenes))
    torch.cuda.synchronize()
    run_ips = len(scenes) / (time.perf_counter() - t0)
    launches = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                "pncc_render": r.pncc_render_cuda.launches}
    dets = [int(o["valid"].sum()) for o in out]
    meshes = sum(len(o["vertices"]) for o in out)
    log(f"  run() over {len(scenes)} scenes at {STREAM_SIZE} px: {run_ips:.1f} images/s "
        f"(second run), {sum(dets)} detections, {meshes} meshes decoded; launches "
        f"(rendering the scenes included): {launches}")
    if len(out) != len(scenes) or sum(dets) == 0 or launches["rasterize_zbuffer"] <= 0:
        raise AssertionError("streaming run emitted too little")
    for o in out:
        for slot, v in o["vertices"].items():
            if not (o["valid"][slot] and v.shape == (2470, 3) and v.device.type == dev.type
                    and v.dtype == torch.bfloat16):
                raise AssertionError(f"malformed streamed mesh {tuple(v.shape)} {v.dtype}")
        if not np.isfinite(o["boxes_xyxy"]).all():
            raise AssertionError("non-finite streamed boxes")

    stream_layers(stream, scenes[:STREAM_BATCH])
    host_ips = stream.throughput(256)
    device_ips = stream.throughput(256, device_feed=True)
    log(f"  throughput(256): host-fed {host_ips:.1f} images/s, device-fed {device_ips:.1f} "
        f"images/s")
    try:
        busy = profile_window(f"run() over {len(scenes)} scenes, batch {STREAM_BATCH}",
                              lambda: list(stream.run(scenes)))
        log(f"  streaming device busy share: "
            f"{'not measured' if busy is None else f'{100 * busy:.1f}%'}")
    except RuntimeError as exc:  # the profiler is a reading, not a check
        busy = None
        log(f"  streaming profiler: not measured ({exc})")

    # card vs CPU at float32, and card bfloat16 vs card float32, on 4 scenes
    four = scenes[:4]
    f32 = dict(batch_size=4, dtype=torch.float32, verts_dtype=torch.float32, **kw)
    card = list(StreamingDetector(device=dev, **f32).run(four))
    cpu = list(StreamingDetector(device="cpu", **f32).run(four))
    iou, score, matched = match_streams(card, cpu)
    rel = 0.0
    for c, h in zip(card, cpu):
        if sorted(c["vertices"]) != sorted(h["vertices"]):
            raise AssertionError("card and CPU decoded different slots")
        for slot, v in c["vertices"].items():
            ref = h["vertices"][slot]
            rel = max(rel, float(torch.linalg.norm(v.cpu() - ref) / torch.linalg.norm(ref)))
    log(f"  float32, card vs CPU on 4 scenes: {matched} detections, min box IoU {iou:.6f}, "
        f"max score |d| {score:.3g}, max vertex rel L2 {rel:.3e}")
    if matched == 0 or iou < 0.99 or rel > 1e-3 or \
            [int(o["valid"].sum()) for o in card] != [int(o["valid"].sum()) for o in cpu]:
        raise AssertionError("streaming: card and CPU disagree at float32")
    bf16 = list(stream.run(four))
    iou16, score16, matched16 = match_streams(bf16, card)
    log(f"  bfloat16 vs float32 on the card, 4 scenes: {matched16} detections, min box IoU "
        f"{iou16:.6f}, max score |d| {score16:.3g}")
    if matched16 == 0 or iou16 < 0.95 or score16 > 2e-2:
        raise AssertionError("streaming: bfloat16 strays from float32")
    return {"run_images_per_s": run_ips, "host_fed_images_per_s": host_ips,
            "device_fed_images_per_s": device_ips, "device_busy_share": busy}


def train_argv(ckpt_root: str, device, resume: bool = False) -> list:
    """The entry point's flags for the smoke run: yolo_heads_m with
    rendered synthetic scenes, warm-started from the shipped checkpoint,
    two epochs of which one a process, checkpoints under ``ckpt_root``."""
    return ["--config-name", MODEL, "--device", str(device),
            "dataset_params.render=true", f"pretrained_weights={CHECKPOINT}",
            f"dataset_params.image_size={TRAIN_SIZE}", f"dataset_params.batch_size={TRAIN_BATCH}",
            f"dataset_params.train_length={TRAIN_LENGTH}",
            f"dataset_params.val_length={VAL_LENGTH}",
            "training_hyperparams.max_epochs=2", "training_hyperparams.epochs_per_run=1",
            f"training_hyperparams.resume={'true' if resume else 'false'}",
            f"ckpt_root_dir={ckpt_root}", "experiment_name=smoke", "log_every=4"]


def _components(comps) -> dict:
    return {k: float(v.detach()) for k, v in comps.items()}


def _synchronize(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def check_resumed(trainer, saved) -> None:
    """The resumed state equals the checkpoint it was read from, exactly."""
    state = trainer.state
    if state.step != saved["step"]:
        raise AssertionError(f"resumed at step {state.step}, saved {saved['step']}")
    for k, v in saved["ema_params"].items():
        if not torch.equal(state.ema[k].cpu(), v):
            raise AssertionError(f"resumed EMA differs at {k}")
    current = trainer.model.state_dict()
    for k, v in {**saved["params"], **saved["batch_stats"]}.items():
        if not torch.equal(current[k].cpu(), v):
            raise AssertionError(f"resumed weights differ at {k}")
    opt = state.optimizer.state_dict()["state"]
    for i, moments in saved["opt_state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(opt[i][k].cpu(), moments[k]):
                raise AssertionError(f"resumed Adam {k} differs for parameter {i}")


def phase_training(dev) -> dict:
    """The training path: two chunks of the entry point's trainer with a
    resume between them, then the step alone on pre-collated batches."""
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.train.__main__ import build_trainer
    from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset, collate_samples
    from head_detector_tpu_torch.train.loss import Targets

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        trainer = build_trainer(train_argv(root, dev))
        matched, total = trainer.restored_leaves
        log(f"  train-layout {MODEL} ({sum(p.numel() for p in trainer.model.parameters())} "
            f"parameters, bfloat16 compute): key_matching restore {matched}/{total} leaves, "
            f"trainer ready in {time.perf_counter() - t0:.2f} s")
        if matched != total:
            raise AssertionError("the shipped checkpoint did not restore every leaf")

        r.rasterize_zbuffer_cuda.launches = 0
        r.pncc_render_cuda.launches = 0
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _synchronize(dev)
        t0 = time.perf_counter()
        metrics_first = trainer.train()
        t1 = time.perf_counter()
        resumed = build_trainer(train_argv(root, dev, resume=True))
        check_resumed(resumed, resumed.ckpt.restore(resumed.ckpt.latest_step()))
        log(f"  resumed at step {resumed.state.step}: step, weights, EMA and Adam moments "
            f"equal the checkpoint's")
        t2 = time.perf_counter()
        metrics_second = resumed.train()
        _synchronize(dev)
        t3 = time.perf_counter()
        launches = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                    "pncc_render": r.pncc_render_cuda.launches}
        peak = (torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda"
                else 0)

        if resumed.state.step != 2 * trainer.steps_per_epoch:
            raise AssertionError(f"training ended at step {resumed.state.step}")
        first = _components(trainer.step_components[0])
        last = _components(resumed.step_components[-1])
        for name, comps in (("first", first), ("last", last)):
            if not all(np.isfinite(v) for v in comps.values()):
                raise AssertionError(f"non-finite loss at the {name} step: {comps}")
        for name, m in (("first", metrics_first), ("second", metrics_second)):
            if not {"KeypointsNME", "KeypointsFailureRate", "RPYError"} <= set(m) or \
                    not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"validation metrics of the {name} chunk: {m}")
        if launches["rasterize_zbuffer"] <= 0:
            raise AssertionError("the training path launched no rasterizer kernel")
        chunks = [t.timings[-1] for t in (trainer, resumed)]
        loader_ips = [c["images"] / c["train_s"] for c in chunks]
        log(f"  chunk 1: {(t1 - t0):.2f} s (train {chunks[0]['train_s']:.2f}, validate "
            f"{chunks[0]['validate_s']:.2f}, save {chunks[0]['save_s']:.2f}); chunk 2 "
            f"(resumed): {(t3 - t2):.2f} s (train {chunks[1]['train_s']:.2f}, validate "
            f"{chunks[1]['validate_s']:.2f}, save {chunks[1]['save_s']:.2f})")
        log(f"  loader-fed (rendering in its threads, first step of a chunk included): "
            f"{loader_ips[0]:.2f} images/s in chunk 1, {loader_ips[1]:.2f} in chunk 2")
        log(f"  loss at the first step: {first}")
        log(f"  loss at the last step:  {last}")
        log(f"  validation, chunk 1: {metrics_first}")
        log(f"  validation, chunk 2: {metrics_second}")
        log(f"  launches on the training path: {launches}; peak memory "
            f"{peak / 2**30:.3f} GiB")

        # the step alone: batches collated once (the scenes are cached) and
        # uploaded before the clock starts
        ds = resumed.train_dataset
        batches = []
        for b in range(TIMED_STEPS):
            images, targets = collate_samples(
                [ds[i] for i in range(b * TRAIN_BATCH, (b + 1) * TRAIN_BATCH)],
                resumed.cfg.max_gt_boxes)
            batches.append((torch.as_tensor(images).to(dev), Targets(*targets).to(dev)))
        step_ms = []
        for images, targets in batches:
            _synchronize(dev)
            s0 = time.perf_counter()
            resumed.step_fn(resumed.state, images, targets)
            _synchronize(dev)
            step_ms.append((time.perf_counter() - s0) * 1e3)
        steady = step_ms[1:]
        _synchronize(dev)
        s0 = time.perf_counter()
        for images, targets in batches:
            resumed.step_fn(resumed.state, images, targets)
        _synchronize(dev)
        device_ips = len(batches) * TRAIN_BATCH / (time.perf_counter() - s0)
        log(f"  step alone (device-resident batches, synchronised): first {step_ms[0]:.2f} ms, "
            f"then median {float(np.median(steady)):.2f} ms ({min(steady):.2f}-"
            f"{max(steady):.2f}) over {len(steady)}; device-fed {device_ips:.2f} images/s "
            f"({len(batches)} steps back to back)")
        # one scene's sample alone (FLAME decode, one launch, the download),
        # with no step in flight, against what the loader threads got
        fresh = SyntheticHeadsDataset(flame_model=resumed.flame, image_size=TRAIN_SIZE,
                                      length=TRAIN_BATCH, seed=7, render=True, device=dev)
        fresh[0]
        _synchronize(dev)
        s0 = time.perf_counter()
        for i in range(1, TRAIN_BATCH):
            fresh[i]
        render_ms = (time.perf_counter() - s0) * 1e3 / (TRAIN_BATCH - 1)
        log(f"  one rendered sample alone, one thread, no step in flight: {render_ms:.2f} ms")
        busy = None
        if torch.device(dev).type == "cuda":
            try:
                images, targets = batches[0]
                busy = profile_window(f"one train step, batch {TRAIN_BATCH} at {TRAIN_SIZE} px",
                                      lambda: resumed.step_fn(resumed.state, images, targets))
            except RuntimeError as exc:  # the profiler is a reading, not a check
                log(f"  training profiler: not measured ({exc})")
        log(f"  training device busy share: "
            f"{'not measured' if busy is None else f'{100 * busy:.1f}%'}")
        return {"launches": launches, "restored": [matched, total],
                "step_ms_first": step_ms[0], "step_ms_median": float(np.median(steady)),
                "step_ms_spread": [min(steady), max(steady)],
                "loader_images_per_s": loader_ips, "device_fed_images_per_s": device_ips,
                "render_ms_alone": render_ms,
                "peak_memory_bytes": peak, "device_busy_share": busy,
                "loss_first": first, "loss_last": last,
                "validation": [metrics_first, metrics_second]}


def phase_train_card_vs_cpu(dev) -> None:
    """One float32 train-mode forward + loss + backward of the M checkpoint
    at CHECK_SIZE px, batch CHECK_BATCH, on the card and on the CPU (TF32
    off): loss components to relative LOSS_RTOL, every parameter's gradient
    to relative L2 GRAD_REL_L2."""
    from head_detector_tpu_torch.config import CONFIG_DIR, load_config, run_config_from_dict
    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.models import build_model
    from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset, collate_samples
    from head_detector_tpu_torch.train.loss import Targets
    from head_detector_tpu_torch.train.trainer import images_to_device, make_loss_fn
    from head_detector_tpu_torch.weights import load_variables, train_state_dict_from_flax

    loss_cfg = run_config_from_dict(
        load_config(os.path.join(CONFIG_DIR, f"{MODEL}.yaml"))).loss
    ds = SyntheticHeadsDataset(image_size=CHECK_SIZE, length=CHECK_BATCH, seed=3, render=True,
                               device=dev)
    images, targets = collate_samples([ds[i] for i in range(CHECK_BATCH)], 30)
    state, _ = train_state_dict_from_flax(load_variables(CHECKPOINT))
    got = {}
    for where in (torch.device(dev), torch.device("cpu")):
        t0 = time.perf_counter()
        net = build_model(MODEL, deploy=False).to(where)
        net.load_state_dict(state, strict=True)
        loss_fn = make_loss_fn(net, FlameModel.from_assets(device=where), loss_cfg)
        with exact_float32():
            total, comps = loss_fn(images_to_device(images, where), Targets(*targets).to(where))
            total.backward()
        got[where.type] = (_components(comps),
                           {n: p.grad.detach().cpu() for n, p in net.named_parameters()})
        log(f"  float32 step on {where.type}: {(time.perf_counter() - t0):.2f} s")
    (card, card_grads), (cpu, cpu_grads) = got[torch.device(dev).type], got["cpu"]
    worst_loss = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu
                     if k.startswith("loss"))
    # a bias that only shifts a channel before a train-mode BatchNorm (the
    # QARepVGG branches' before post_bn, the upsample's before a 1x1 conv and
    # its BatchNorm) has an exact gradient of 0: both devices compute
    # rounding there, held to 1e-5 of the largest gradient instead
    flat = lambda n: n.endswith(SHIFT_BEFORE_BN)  # noqa: E731
    largest = max(float(g.abs().max()) for g in cpu_grads.values())
    shift = max(max(float(card_grads[n].abs().max()), float(g.abs().max()))
                for n, g in cpu_grads.items() if flat(n))
    rel = {n: float(torch.linalg.norm(card_grads[n] - g) / torch.linalg.norm(g))
           for n, g in cpu_grads.items() if not flat(n)}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"  card vs CPU, float32, {CHECK_SIZE} px, batch {CHECK_BATCH}: loss {cpu['loss']:.6f}, "
        f"num_pos {cpu['num_pos']:.0f}; max loss-component relative difference "
        f"{worst_loss:.3e}; gradient relative L2, worst of {len(rel)} parameters: {worst}; "
        f"the {len(cpu_grads) - len(rel)} channel-shift biases (exact gradient 0): largest "
        f"|g| {shift:.3e} against {largest:.3e} anywhere")
    if card["num_pos"] != cpu["num_pos"] or worst_loss > LOSS_RTOL or \
            worst[0][1] > GRAD_REL_L2 or shift > 1e-5 * largest:
        raise AssertionError("training: card and CPU disagree at float32")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from head_detector_tpu_torch import cuda_build
    from head_detector_tpu_torch.detector import HeadDetector
    from head_detector_tpu_torch.flame import FlameModel

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
    entries = phase_kernels(flame_model)

    log("phase 3: main path")
    t0 = time.perf_counter()
    detector = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=CHECKPOINT,
                            device=dev)
    log(f"  restored {detector.restored_leaves[0]}/{detector.restored_leaves[1]} leaves, "
        f"detector ready in {time.perf_counter() - t0:.2f} s")
    scenes, launches = phase_main_path(detector, flame_model)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    try:
        phase_profile(detector, scenes)
    except RuntimeError as exc:  # the profiler is a reading, not a check
        log(f"  profiler: not measured ({exc})")

    log("phase 4: card vs CPU")
    phase_card_vs_cpu(detector, scenes[0])

    log("phase 5: detector options and the result API")
    phase_options_and_results(detector, scenes)

    log("phase 6: streaming")
    streaming = phase_streaming(flame_model)
    log("  " + json.dumps({"streaming": streaming}))

    log("phase 7: training")
    training = phase_training(dev)
    phase_train_card_vs_cpu(dev)
    log("  " + json.dumps({"training": training}))
    for entry in entries:
        serving = entry["launches"]
        entry["launches_by_path"] = {"serving": serving,
                                     "training": training["launches"].get(entry["name"], 0)}
        entry["launches"] = sum(entry["launches_by_path"].values())

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
