"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp-switches   # phase 16 (b) alone, each switch apart

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
   most heads; and at the DAD stand-in renderer's input (a sample of three
   heads at 512 px as one mesh), bit-equal, with its times;
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
   rendering), the device's busy share in a profiled ``run()``; card
   against CPU at float32 on a batch of 4 scenes (box IoU >= 0.99, vertex
   relative L2 <= 1e-3) and card bfloat16 against card float32 on it (box
   IoU >= 0.95, score |d| <= 2e-2);
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
8. the flagship training configuration (``flagship_campaign``: yolo_heads_m,
   512 px, batch 16, 4 GT boxes, params wire, bfloat16 compute): the kernel
   against its plain version at the renderer's inputs (a scene of three
   heads at 512 px: the scene pass, the id-color pass, the solo pass) and
   its times there, the renderer on the card against the CPU on that scene;
   then, with the launch counts zeroed, 128 training and 16 validation
   scenes rendered by ``head_detector_tpu_torch.tools.
   render_synthetic_dataset`` (scenes/s, launches equal to one a pass),
   ``check_dataset`` over both readers, ``build_trainer`` on the rendered
   directory with the shipped checkpoint for one epoch of 8 steps,
   validation and a checkpoint (finite losses at every step, the host lock
   released, loader-fed images/s, peak memory), ``set_epoch`` changing the
   augmentation stream, the step alone on device-resident batches (ms,
   device-fed images/s, the share of ``decode_param_targets``, the busy
   share of a profiled step), ``decode_param_targets`` on the card against
   the CPU for one collated batch (1e-5 of each field's largest magnitude),
   the extreme-batch panel without TensorBoard, one float32 step (TF32 off)
   on one sample through each wire (every loss component within 1e-5
   relative, num_pos equal), and a short epoch of the
   dense wire through the entry point;
9. export and evaluation (yolo_heads_m, the shipped checkpoint, 512 px, its
   own size): the shipped checkpoint through ``load_variables``,
   ``train_state_dict_from_flax``, ``flax_from_state_dict`` and
   ``save_variables`` in float16 gives back the file byte for byte, and a
   ``HeadDetector`` on it gives phase 3's boxes and scores bit for bit;
   ``tools/eval_checkpoint`` scores phase 8's flagship step (raw and EMA, on
   its rendered validation split) and exports it in float32 and float16,
   each export served by ``HeadDetector`` with every leaf restored; with the
   launch counts zeroed, 64 DAD stand-in samples rendered on the card
   (``tools/render_dad_testset``, up to 3 heads, seed 99; samples/s, one
   launch a sample) and an FDDB stand-in made from phase 8's validation
   split; ``tools/run_protocols`` (DAD, then FDDB) on the card with host ms
   per sample; the card against the CPU on the first 4 DAD samples and 4
   FDDB images (the same heads selected; ``nme_2d`` and chamfer within 1e-3
   relative, ``rot_error`` 1e-4, angle 1e-2 degrees, ``z_n`` 1e-2, FDDB AP
   1e-3; float32 with TF32 off);
10. the data factory and the last tools (in phase 8's temporary
   directory): 16 pose canvases at 1024 px (``PoseConditioningProcessor``
   with a seeded keypoint model, ``draw_bodypose``) and their captions;
   with the launch counts zeroed, ``DataGenerator`` with
   ``FlameRenderBackend(1024)`` on the card (one launch an image, images/s,
   an image's time split between the host draws, the card and the rest);
   the kernel against plain, bit for bit, at the image with the most heads,
   with its times, and the backend on the card against the CPU there
   (pixels equal on >= 99.9%); ``filter_data`` over the generated split
   (``HeadBoxDetector``: yolo_heads_m, the shipped checkpoint, 512 px, conf
   0.5); the teacher loop's ``prepare`` (phase 8's 128 training scenes,
   ``val`` linked to its real GT) and ``annotate`` (teacher at 256
   px), every pseudo-annotation decoded by ``decode_dad_annotation`` within
   1e-3 px + 1e-5 relative of the teacher's projected vertices;
   ``teacher_student`` (yolo_heads_n, 320 px, batch 16, params wire, mixed
   precision) through the trainer's entry point for one epoch of 4 steps
   (finite losses, a checkpoint), its step alone on a device-resident
   batch, then ``report``; ``score_final`` on phase
   8's step directory, each arm's KeypointsNME equal to
   ``tools/eval_checkpoint``'s to 1e-6 relative, both exports in the
   temporary directory; ``diagnose_recall`` on the card against the CPU
   (the same tp/fp/fn at every threshold, the same assigner histogram);
   ``test_folder`` and ``head_alignment`` over phase 3's scenes as JPEG (an
   overlay an image, a crop a head);
11. export and quantization (yolo_heads_m, the shipped checkpoint, 640 px,
   batch 8, phase 3's scenes): ``export.build_deploy`` on the card (its
   weights equal to ``HeadDetector``'s; ``param_count`` before and after
   fusion); the ``.trcd`` of ``torch_mirror.export_torchscript`` (traced on
   the CPU, loaded on the card) and ``export_serialized`` /
   ``load_serialized`` against the eager deploy model on the batch (scores
   1e-4, boxes 2e-3 + 1e-4 relative, flame 2e-3 + 1e-3 relative) with ms a
   batch of each beside eager (CUDA events, float32, TF32 off);
   ``export_onnx`` plain, ``int8``, ``fp16`` and ``pre_nms_top_k=1000``
   (bytes, nodes), ``run_onnx`` on the card at batch 1 against the eager
   model (2e-4 of each output's scale); ``ptq`` over 16 batches of 8
   rendered scenes at percentile 99.99 (seconds), W8, W8A8 and FP16 against
   float32 at the bars of ``tests/test_quantization.py``, the
   ``save_quantized`` bytes under 0.45 of float32 and its round trip exact;
   with the launch counts zeroed, the W8 tree as a msgpack served by
   ``HeadDetector``, ``predict_batch`` and ``get_pncc`` on the 8 scenes,
   the card against the CPU at phase 4's bar and the agreement with the
   float32 detector as a reading; ``analytic_flops``, ``time_fn`` and
   ``mfu`` of the deploy forward;
12. the SegFormer configuration (``segformer``: MiT-B5 with the L heads,
   640 px, batch 8, bfloat16, the dense wire with 30 GT boxes; in phase 8's
   temporary directory), with the launch counts zeroed: 64 training and 16
   validation scenes rendered at 640 px by ``tools/render_synthetic_dataset``
   (scenes/s, launches equal to one a pass); ``--config-name segformer``
   through ``build_trainer`` on that directory from random init for one
   epoch of 8 steps with validation and a checkpoint (finite losses at every
   step, loader-fed images/s, peak memory); the step alone on 4
   device-resident batches (ms, device-fed images/s, the busy share of a
   profiled step, the FLOPs of ``profiling.analytic_flops`` and MFU against
   the bfloat16 peak); one float32 step (TF32 off) of MiT-B5 at 320 px,
   batch 2, on the card and on the CPU at the configuration's starting
   point (and in float64 on the CPU there) and at the trained weights: loss
   components card vs CPU within 1e-4 relative, the exact-zero gradients
   (phase 7's channel-shift biases, the last stage's LayerNorm bias, the
   attention's key bias) under 1e-5 of the largest, and at the starting
   point the card's gradient over the model within 1e-3 relative L2 of
   float64 or no farther than the CPU's float32 (float32 misses phase 7's
   per-parameter bar on this network on either device; the trained point's
   card-vs-CPU distance is a reading); ``tools/eval_checkpoint
   --arch segformer`` (raw and EMA) and a float32 EMA export, served by
   ``load_variables`` and ``EvalPredictor("segformer")`` bit-equal to the
   trainer's EMA weights on a validation batch; ``tools/run_protocols --arch
   segformer --image-size 640`` on phase 9's DAD and FDDB stand-ins (host ms
   a sample), then the card against the CPU on 2 DAD samples and 2 FDDB
   images at phase 9's bars, and the predictor's float32 outputs on one
   sample within 1e-4 of each output's scale;
13. one ``{"kernels": [...]}`` line (``launches_by_path`` by serving,
   training, flagship, evaluation, factory, export, segformer,
   data_parallel and campaign), the card's name and power limit, then the
   last line ``{"ok": true, "device": {...}}``; printed after phase 14;
14. data parallel (one process a rank, ``distributed.spawn``), with the
   launch counts zeroed: (a) ``multichip.dryrun_multichip(2,
   backend="gloo")`` with both ranks on the card (yolo_heads_n at 64 px, the
   JAX dry run's weights and inputs: the two-rank loss within 1e-4 of the
   one-rank loss, every parameter and EMA tensor bit-identical); (b) the
   slice's path at full width: ``train.__main__.run_data_parallel`` on
   ``--config-name yolo_heads_m dataset_params.render=true`` with the
   shipped checkpoint at 640 px, global batch 8, as two gloo ranks sharing
   the card (4 rows a rank, each rendering its own rows), as one NCCL rank
   through the same code, and as today's trainer, from the same weights on
   the same batches: two float32 steps (TF32 off; the first step's loss
   components within 1e-4 relative, the second step's model gradient within
   1e-3 relative L2 and the BatchNorm statistics after it within 1e-4 of
   each tensor's largest), then a bfloat16 step and the step alone timed 4
   times in each; the ranks' parameters, EMA and statistics bit-identical
   after every run (sha256); two NCCL ranks on two
   cards where the machine has them (skipped, and said so, on one card);
   (c) a run cut after one epoch and resumed under two ranks against the
   uninterrupted run (one checkpoint writer: one history line an epoch; the
   same step, parameters within 1e-5 relative L2), and ``validate()`` under
   two ranks against today's trainer at the same weights (1e-5 relative);
   (d) ``StreamingDetector(devices=[cuda:0, cuda:0])`` against one replica
   at phase 6's configuration on 32 of its scenes (``valid`` equal, scores
   within 1e-5, boxes within 1e-3 px, the same meshes within 0.05 + 1e-2
   relative);
15. the last modules (in phase 8's temporary directory, after phase 12):
   (a) the native host library (``head_detector_tpu_torch.native``, built
   with g++ for this host) must build; ``MeshSaver`` takes its writer, whose
   files of phase 3's heads are byte-equal to the Python writer's (ms/img
   of each); ``StreamingDetector``'s host letterbox through it
   (``HDT_LETTERBOX=native``) equals cv2 on 8 of phase 6's 1024 px scenes
   at 1024 px and is within 2 counts at 640 px; ``rasterize_zbuffer_native``
   against the CUDA kernel on the main path's fullest scene at the kernel's
   bar (hit agreement >= 0.999, |color| < 1e-4 off sliver triangles), its
   host ms beside the kernel's ``device_ms``; (b) the competitor protocol
   (``evaluate_external_detector``) on phase 9's FDDB stand-in: a perfect
   mock scores AP 1.0, and ``HeadDetector`` as a ``detector(image) ->
   (boxes, scores)`` prints its AP; (c) ``tools/verify_reference_parity
   --self-test`` at yolo_heads_m, 640 px (its ``.trcd`` run on the card)
   passes, with its stage diffs, minimum IoU and largest vertex L2; (d)
   with the launch counts zeroed, ``tools/run_campaign`` renders its own
   set (64 + 16 scenes at 512 px: the ``campaign`` path's launches) and
   trains ``flagship_campaign`` from the shipped checkpoint as two
   one-epoch chunks, the second a resume; ``tools/finish_campaign`` scores
   the best step and the average of the best 2 and exports them;
   ``tools/archive_campaign`` archives into the temporary directory and
   ``tools/campaign_report.py`` parses the archive;
16. the port's faults (``tools/card_probes.py``, after phase 15): (a)
   ``validation`` on phase 8's flagship state: the EMA with the live
   BatchNorm statistics, the live parameters, the EMA with recalibrated
   statistics, and the first on the CPU (card vs CPU scores within 0.05 in
   bfloat16), each's accuracy, TP/FP/FN, raw and folded NME, and the EMA's
   distance from the live weights; (b) phase 14 (c)'s cut and resumed
   two-rank run under ``use_deterministic_algorithms``, ``CUBLAS_WORKSPACE_
   CONFIG=:4096:8``, ``cudnn.deterministic`` and no benchmark: the digests
   (bit-equal), the parameters' distance (phase 14's bar), the ops that warn
   and the convolution kernels of each run and rank (``--dp-switches`` runs
   this alone under the other settings of ``card_probes.SWITCHES``: none
   and each switch by itself; it prints their readings and no result
   line); (c) the jaw tower of
   ``heads.head1`` (MiT-B5 at 160 px after ``tools/grad_precision``'s 8
   steps): each BatchNorm's least train-mode variance against its ``eps``
   on the card, the CPU and in float64; (d) ``card_probes``'s flagship
   steps (``flagship_r4`` on JAX's 5-epoch schedule, yolo_heads_m, batch
   16, cut to 128 px and one bfloat16 and one float32 step) on the card,
   on the CPU, on the card from a start one float32 step away, and in
   float64: every loss component of the float32 step on the card no farther
   from float64 than 3x the CPU's (plus 2e-6 of it), finite everywhere;
   (e) ``card_probes bn-precision``: the model gradient of one float32
   train-mode step of the shipped yolo_heads_m checkpoint at 128 px, batch
   4, against the port's float64 on the CPU, on the CPU, on the card and on
   the card with cuDNN disabled, over the whole model and over the leaves
   whose exact gradient is not 0 (the exactly-zero ones apart), then the
   BatchNorm carrying most of the card's error alone (card with cuDNN and
   without, CPU, float64, the profiler's kernel names): the card's error on
   the non-zero leaves at most 3x JAX's own float32 error at that state
   (``card_probes.JAX_F32_ERROR``).  (e) replaced (d)'s ``card_probes
   layers`` at 128 px, which read the model gradient at a seeded state
   without a JAX yardstick (``card_probes layers`` still runs it).

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

FLAGSHIP = "flagship_campaign"  # yolo_heads_m, 512 px, batch 16, params wire, 4 GT boxes
FLAGSHIP_SIZE = 512
FLAGSHIP_BATCH = 16
FLAGSHIP_TRAIN = 128
FLAGSHIP_VAL = 16
DENSE_STEPS = 2
DECODE_RTOL = 1e-5
WIRE_RTOL = 1e-5  # per loss component, float32 with TF32 off

STREAM_SIZE = 1024
STREAM_BATCH = 32
STREAM_SCENES = 64

EVAL_SIZE = 512  # the shipped checkpoint's own size (checkpoints/flagship_ema.msgpack.json)
DAD_SAMPLES = 64
DAD_SEED = 99
DAD_MAX_HEADS = 3
CHECK_SAMPLES = 4  # DAD samples and FDDB images of the card-against-CPU check

FACTORY_SIZE = 1024  # FlameRenderBackend's default image size
FACTORY_IMAGES = 16
FACTORY_MAX_PEOPLE = 4  # the backend's max_heads
FACTORY_SEED = 7
FACTORY_PIXELS = 0.999  # card against CPU: uint8 pixels equal
TEACHER_IMAGES = FLAGSHIP_TRAIN  # phase 8's train split, all of it (the loop's --limit)
STUDENT_TIMED = 6  # steps timed alone on a device-resident batch
FILTER_SIZE = 512  # the teacher loop's detector size (its --image-size default)
STUDENT = "teacher_student"  # yolo_heads_n, 320 px, batch 16, params wire, 4 GT boxes
STUDENT_STEPS = 4
DIAGNOSE_BATCHES = 2  # assigner batches of diagnose_recall, on the card and the CPU
CALIB_BATCHES = 16  # PTQ calibration batches of BATCH scenes (exportable_mesh_model.py:144-146)
ROUND_TRIP_PX, ROUND_TRIP_RTOL = 1e-3, 1e-5

SEGFORMER = "segformer"  # MiT-B5 + L heads, 640 px, batch 8, dense wire, 30 GT boxes, bfloat16
SEG_SIZE = 640
SEG_BATCH = 8
SEG_TRAIN = 64  # cut from the config's dataset; one epoch of 8 steps
SEG_VAL = 16
SEG_TIMED = 4  # steps timed alone on device-resident batches
SEG_CHECK_SIZE = 320  # the float32 card-vs-CPU step, batch CHECK_BATCH
SEG_CHECK_SAMPLES = 2  # DAD samples and FDDB images of the protocols' card-vs-CPU check
SEG_RAW_FRAC = 1e-4  # the predictor's float32 outputs, card vs CPU, of each output's scale
DP_SIZE = 640  # phase 14: yolo_heads_m, rendered scenes, phase 7's size and global batch
DP_BATCH = 8
DP_VAL = 8  # one validation batch
DP_TIMED = 4  # bfloat16 steps timed alone
DP_TIMEOUT = 120.0  # seconds a collective of the ranks may wait
DP_STATS_RTOL = 1e-4  # BatchNorm statistics, data parallel vs one card
DP_RESUME_REL = 1e-5  # resumed vs uninterrupted parameters, relative L2
DP_VAL_RTOL = 1e-5  # validate() under two ranks vs one
FAULTS_CPU_IMAGES = 8  # phase 16 (a): val images scored on the CPU too
FAULTS_SCORE_GAP = 0.05  # phase 16 (a): card vs CPU scores, bfloat16 (rounding of two devices)
FAULTS_JAW_SIZE = 160  # phase 16 (c): tools/grad_precision's state (MiT-B5, 8 steps), cut
# from its 320 px to keep the run inside the limit
FAULTS_STEPS_SIZE = 128  # phase 16 (d): the flagship's steps, cut from 512 px
FAULTS_BF16_STEPS, FAULTS_F32_STEPS = 1, 1
# phase 16 (d): of each loss component, float32, card vs float64 (the card read
# 8.1e-7 of loss_3d_rotation where the CPU read 6.2e-8, flagship steps at 128 px)
FAULTS_STEP_FLOOR = 2e-6
HIT_AGREEMENT = 0.999  # the Pallas kernel's bar, tests/test_rasterize_pallas.py
COLOR_TOL = 1e-4
CAMPAIGN_TRAIN = 64  # phase 15's campaign set at 512 px, cut from 16,384
CAMPAIGN_VAL = 16
CAMPAIGN_AVERAGE = 2
PARITY_IMAGES = 4
LETTERBOX_SCENES = 8  # phase 6's first scenes at 1024 px
LETTERBOX_COUNTS = 2  # native bilinear against cv2's fixed-point weights (tests/test_native.py)


_START = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase's header carries the seconds since the start
    (the driver's limit is 1,200 s)."""
    if msg.startswith("phase "):
        msg = f"{msg} (at {time.perf_counter() - _START:.1f} s)"
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
    return scenes, launches, results


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


def card_vs_cpu(got_results, want_results, label: str) -> dict:
    """The port on the card against the port on the CPU, result by result:
    box IoU >= 0.99, posed-vertex relative L2 <= 1e-3, PNCC pixels equal on
    >= 99.9% (phase 4's bar)."""
    worst_iou, worst_rel, heads, equal, pixels = 1.0, 0.0, 0, 0, 0
    for got, want in zip(got_results, want_results):
        if len(got.heads) != len(want.heads):
            raise AssertionError(f"{label}: card found {len(got.heads)} heads, "
                                 f"CPU {len(want.heads)}")
        heads += len(want.heads)
        for hg, hw in zip(got.heads, want.heads):
            worst_iou = min(worst_iou, iou_xywh(hg.bbox, hw.bbox))
            worst_rel = max(worst_rel, float(
                np.linalg.norm(hg.vertices_3d - hw.vertices_3d) / np.linalg.norm(hw.vertices_3d)
            ))
        diff = np.abs(got.get_pncc().astype(int) - want.get_pncc().astype(int)).max(-1)
        equal += int((diff == 0).sum())
        pixels += diff.size
    pncc_agree = equal / pixels
    log(f"  {label}: heads {heads}: min box IoU {worst_iou:.6f}, max vertex rel L2 "
        f"{worst_rel:.3e}, PNCC pixels equal: {pncc_agree:.6f}")
    if not heads:
        raise AssertionError(f"{label}: no heads to compare")
    if worst_iou < 0.99 or worst_rel > 1e-3 or pncc_agree < 0.999:
        raise AssertionError(f"{label}: card and CPU disagree")
    return {"heads": heads, "min_iou": worst_iou, "max_vertex_rel": worst_rel,
            "pncc_equal": pncc_agree}


def phase_card_vs_cpu(detector_gpu, scene):
    """One scene through the port on the card and on the CPU."""
    from head_detector_tpu_torch.detector import HeadDetector

    cpu = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=CHECKPOINT,
                       device="cpu")
    card_vs_cpu(detector_gpu.predict_batch([scene]), cpu.predict_batch([scene]),
                "the shipped checkpoint")


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
    """The streaming layers one at a time on one batch: the host letterbox
    straight into a pinned slot's rows (one thread), the slot's copy to the
    card, the step (forward, NMS, mesh decode), the download and emission."""
    from head_detector_tpu_torch.pipeline import _Pending, _Slot, letterbox_into

    dev = stream.device
    slot = _Slot((len(scenes), stream.image_size, stream.image_size, 3), dev)
    scales = [letterbox_into(im, row) for im, row in zip(scenes, slot.rows)]
    t0 = time.perf_counter()
    scales = [letterbox_into(im, row) for im, row in zip(scenes, slot.rows)]
    t1 = time.perf_counter()
    copy_stream = torch.cuda.Stream(dev)
    stream._upload(slot, copy_stream)
    slot.copied.synchronize()
    t2 = time.perf_counter()
    stream._upload(slot, copy_stream)
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
    emitted = list(stream._emit([_Pending(out, dev, 0)], scales))
    t7 = time.perf_counter()
    n = len(emitted)
    log(f"  layers on one batch of {n}: letterbox into the pinned slot "
        f"{(t1 - t0) * 1e3 / n:.3f} ms/img on one thread, copy enqueued in "
        f"{(t3 - t2) * 1e3:.3f} ms + to the card {(t4 - t3) * 1e3:.3f} ms, "
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
    return {"run_images_per_s": run_ips, "device_busy_share": busy}


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


def first_scene_with(split: str, heads: int, seed: int = 0) -> int:
    """Index of the first scene of ``split`` the renderer draws with ``heads`` heads."""
    from head_detector_tpu_torch.tools.render_synthetic_dataset import scene_seed

    return next(i for i in range(10000) if int(np.random.RandomState(
        scene_seed(seed, split, i)).choice(np.arange(1, MAX_HEADS + 1))) == heads)


def renderer_launches(split: str, count: int, seed: int = 0) -> int:
    """Launches the renderer makes for scenes 0..count-1: the scene pass, and
    for more than one head the id-color pass and one solo pass of all heads."""
    from head_detector_tpu_torch.tools.render_synthetic_dataset import scene_seed

    n = [int(np.random.RandomState(scene_seed(seed, split, i)).choice(
        np.arange(1, MAX_HEADS + 1))) for i in range(count)]
    return sum(1 + 2 * (k > 1) for k in n)


def phase_renderer_kernel(flame_model):
    """The kernel against its plain version at the renderer's inputs (a scene
    of three heads at FLAGSHIP_SIZE: the scene pass, the id-color pass, the
    solo pass), its times there, and the renderer on the card against the
    renderer on the CPU for that scene."""
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.tools.render_synthetic_dataset import (
        SceneRenderer,
        scene_seed,
    )

    s = FLAGSHIP_SIZE
    renderer = SceneRenderer(s, device=flame_model.device, flame_model=flame_model)
    index = first_scene_with("train", 3)
    scene = renderer.place(np.random.RandomState(scene_seed(0, "train", index)))
    faces, colors, ids = renderer.scene_tables(3)
    scene_v = scene.heads.reshape(1, -1, 3)
    err = 0.0
    for name, args in (("renderer: scene of 3 heads", (scene_v, faces, colors)),
                       ("renderer: id-color pass", (scene_v, faces, ids)),
                       ("renderer: solo pass", (scene.heads, renderer.faces, renderer.colors))):
        _, want, e = check_zbuffer(r, name, args, s, s)
        err = max(err, e)
        if not want[1].any():
            raise AssertionError(f"the plain rasterizer hit nothing: {name}")
    timed = [time_entry(r, "rasterize_zbuffer", where, *args, s) for where, args in (
        ("the renderer's scene pass (3 heads as one mesh)", (scene_v, faces, colors)),
        ("the renderer's solo pass (3 heads, a z-buffer each)",
         (scene.heads, renderer.faces, renderer.colors)))]

    got = renderer.draw(np.random.RandomState(scene_seed(0, "train", index)))
    t0 = time.perf_counter()
    want = SceneRenderer(s, device="cpu").draw(
        np.random.RandomState(scene_seed(0, "train", index)))
    cpu_s = time.perf_counter() - t0
    near = float((np.abs(got[0].astype(int) - want[0].astype(int)).max(-1) <= 2).mean())
    log(f"  renderer scene {index} on the card against the CPU ({cpu_s:.2f} s there): "
        f"{len(got[1])} and {len(want[1])} heads kept, params max |d| "
        f"{float(np.abs(got[1] - want[1]).max()) if got[1].shape == want[1].shape else 'n/a'}, "
        f"pixels within 2 levels {near:.6f}")
    if got[1].shape != want[1].shape or np.abs(got[1] - want[1]).max() > 1e-5 or \
            np.abs(got[2] - want[2]).max() > 1e-3 or near < 0.995:
        raise AssertionError("the renderer on the card disagrees with the renderer on the CPU")
    return err, [{k: t[k] for k in ("timed_at", "ms", "device_ms", "plain_ms", "bound_ms",
                                     "bound_by")} for t in timed]


def flagship_argv(data: str, ckpt_root: str, dev, params_wire: bool = True) -> list:
    """The entry point's flags for the flagship configuration on the rendered
    dataset: one epoch a process (the config's 12-epoch schedule kept),
    warm-started from the shipped checkpoint, checkpoints under ``ckpt_root``."""
    return ["--config-name", FLAGSHIP, "--device", str(dev), f"dataset_params.data_dir={data}",
            f"dataset_params.params_wire={'true' if params_wire else 'false'}",
            f"pretrained_weights={CHECKPOINT}", f"dataset_params.image_size={FLAGSHIP_SIZE}",
            f"dataset_params.batch_size={FLAGSHIP_BATCH}", "training_hyperparams.epochs_per_run=1",
            f"ckpt_root_dir={ckpt_root}", f"experiment_name={'params' if params_wire else 'dense'}",
            "log_every=4"]


def _close_fields(got, want) -> float:
    """Largest |got - want| over the fields of two target tuples, relative
    to each field's largest magnitude."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g).cpu().double(), torch.as_tensor(w).cpu().double()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"malformed decoded targets {tuple(g.shape)}")
        worst = max(worst, float((g - w).abs().max() / max(float(w.abs().max()), 1e-30)))
    return worst


def wire_steps(dev, data: str, loss_cfg) -> dict:
    """One float32 step (TF32 off) of the M checkpoint on one rendered sample
    through each wire, from the same weights: the components of each."""
    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.models import build_model
    from head_detector_tpu_torch.train.dataset import DAD3DHeadsDataset, collate_samples
    from head_detector_tpu_torch.train.param_wire import RenderedHeadsDataset, collate_param_samples
    from head_detector_tpu_torch.train.trainer import TrainConfig, TrainState, make_train_step
    from head_detector_tpu_torch.weights import load_variables, train_state_dict_from_flax

    index = first_scene_with("train", 2)
    dense = DAD3DHeadsDataset(data, splits=["train"])[index]
    params = RenderedHeadsDataset(data, splits=["train"])[index]
    images_d, targets_d = collate_samples([dense], 4)
    images_p, targets_p = collate_param_samples([params], 4)
    if not np.array_equal(images_d, images_p):
        raise AssertionError("the two readers gave different images")
    state, _ = train_state_dict_from_flax(load_variables(CHECKPOINT))
    flame = FlameModel.from_assets(device=dev)
    out = {}
    for name, images, targets in (("dense", images_d, targets_d),
                                  ("params", images_p, targets_p)):
        net = build_model(MODEL, deploy=False).to(dev)
        net.load_state_dict(state, strict=True)
        cfg = TrainConfig(max_steps=10, ema=False)
        with exact_float32():
            _, comps = make_train_step(net, flame, loss_cfg, cfg)(TrainState(net, cfg), images,
                                                                   targets)
        out[name] = _components(comps)
        del net
    return out


def phase_flagship(dev, flame_model, root: str) -> dict:
    """The flagship configuration: render its dataset with the port's tool
    under ``root``, sweep it, train on it through the entry point (params
    wire, then a short run of the dense wire), and read the step's layers.
    The dataset and the step directories stay under ``root`` for phase 9."""
    from head_detector_tpu_torch import hostlock
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.tools.render_synthetic_dataset import render_split
    from head_detector_tpu_torch.train.__main__ import build_trainer
    from head_detector_tpu_torch.train.check_dataset import check_dataset
    from head_detector_tpu_torch.train.dataset import DAD3DHeadsDataset
    from head_detector_tpu_torch.train.param_wire import (
        RenderedHeadsDataset,
        collate_param_samples,
        decode_param_targets,
    )
    from head_detector_tpu_torch.train.transforms import default_val_transforms
    from head_detector_tpu_torch.train.visualization import ExtremeBatchVisualizationCallback

    import cv2

    is_cuda = torch.device(dev).type == "cuda"
    data = os.path.join(root, "data")
    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    _synchronize(dev)
    t0 = time.perf_counter()
    rendered = [render_split(data, "train", FLAGSHIP_TRAIN, FLAGSHIP_SIZE, device=dev,
                             flame_model=flame_model, log_every=0),
                render_split(data, "val", FLAGSHIP_VAL, FLAGSHIP_SIZE, seed=1, device=dev,
                             flame_model=flame_model, log_every=0)]
    _synchronize(dev)
    render_s = time.perf_counter() - t0
    render_launches = r.rasterize_zbuffer_cuda.launches
    want_launches = renderer_launches("train", FLAGSHIP_TRAIN) + renderer_launches(
        "val", FLAGSHIP_VAL, seed=1)
    scenes = FLAGSHIP_TRAIN + FLAGSHIP_VAL
    kept = sum(x["heads"] for x in rendered)
    log(f"  rendered {scenes} scenes at {FLAGSHIP_SIZE} px in {render_s:.2f} s: "
        f"{scenes / render_s:.2f} scenes/s, {kept} heads kept; rasterize_zbuffer launches "
        f"{render_launches} (expected {want_launches})")
    if render_launches != want_launches:
        raise AssertionError("the renderer did not launch the kernel once a pass")

    t0 = time.perf_counter()
    splits = ["train", "val"]
    dense_report = check_dataset(DAD3DHeadsDataset(
        data, splits=splits, transforms=default_val_transforms(FLAGSHIP_SIZE)), 4)
    param_report = check_dataset(RenderedHeadsDataset(data, splits=splits), 4)
    log(f"  check_dataset, dense and params readers: {dense_report['checked']} and "
        f"{param_report['checked']} samples, {dense_report['heads']} heads, problems "
        f"{dense_report['problems'] + param_report['problems']} "
        f"({time.perf_counter() - t0:.2f} s)")
    if dense_report["problems"] or param_report["problems"] or \
            dense_report["checked"] != scenes or param_report["heads"] != kept or \
            dense_report["heads"] != kept:
        raise AssertionError("the rendered dataset fails its sweep")

    ckpt_root = os.path.join(root, "runs")
    t0 = time.perf_counter()
    trainer = build_trainer(flagship_argv(data, ckpt_root, dev))
    matched, total = trainer.restored_leaves
    log(f"  {FLAGSHIP}: {trainer.arch.name} at {trainer.cfg.image_size} px, batch "
        f"{trainer.cfg.batch_size}, {trainer.cfg.max_gt_boxes} GT boxes, "
        f"{type(trainer.train_dataset).__name__}, restore {matched}/{total} leaves, "
        f"ready in {time.perf_counter() - t0:.2f} s")
    if matched != total or not isinstance(trainer.train_dataset, RenderedHeadsDataset):
        raise AssertionError("the flagship trainer is not the params-wire trainer")
    ckpt_dir = trainer.cfg.ckpt_dir
    r.rasterize_zbuffer_cuda.launches = 0
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _synchronize(dev)
    t0 = time.perf_counter()
    metrics = trainer.train()
    _synchronize(dev)
    train_s = time.perf_counter() - t0
    train_launches = r.rasterize_zbuffer_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev) if is_cuda else 0
    steps = trainer.state.step
    losses = [_components(c) for c in trainer.step_components]
    if steps != trainer.steps_per_epoch or trainer.ckpt.latest_step() != steps or \
            not all(np.isfinite(v) for c in losses for v in c.values()):
        raise AssertionError(f"flagship training: step {steps}, losses {losses}")
    if not {"KeypointsNME", "KeypointsFailureRate", "RPYError"} <= set(metrics) or \
            not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"flagship validation metrics: {metrics}")
    if hostlock.campaign_active():
        raise AssertionError("the trainer left its host lock behind")
    timing = trainer.timings[-1]
    loader_ips = timing["images"] / timing["train_s"]
    log(f"  one epoch of {steps} steps in {train_s:.2f} s (train {timing['train_s']:.2f}, "
        f"validate {timing['validate_s']:.2f}, save {timing['save_s']:.2f}); loader-fed "
        f"{loader_ips:.2f} images/s; checkpoint at step {trainer.ckpt.latest_step()}")
    log(f"  loss at each step: {[round(c['loss'], 4) for c in losses]}")
    log(f"  loss at the first step: {losses[0]}")
    log(f"  validation: {metrics}")
    log(f"  launches while training: rasterize_zbuffer {train_launches}; peak memory "
        f"{peak / 2**30:.3f} GiB")

    ds = trainer.train_dataset

    def geometry(epoch):
        ds.set_epoch(epoch)
        return [ds[i].params for i in range(4)]

    first, again, second = geometry(0), geometry(0), geometry(1)
    same = all(np.array_equal(a, b) for a, b in zip(first, again))
    moved = any(a.shape != b.shape or not np.array_equal(a, b)
                for a, b in zip(first, second))
    log(f"  set_epoch: epoch 0 twice gives the same augmented parameters: {same}; "
        f"epoch 1 gives others: {moved}")
    if not (same and moved):
        raise AssertionError("set_epoch does not set the augmentation stream")

    # the step alone on device-resident batches, collated once
    ds.set_epoch(1)
    host, batches = [], []
    for b in range(TIMED_STEPS):
        images, pt = collate_param_samples(
            [ds[i] for i in range(b * FLAGSHIP_BATCH, (b + 1) * FLAGSHIP_BATCH)],
            trainer.cfg.max_gt_boxes)
        host.append((images, pt))
        batches.append((torch.as_tensor(images).to(dev), pt.to(dev)))
    step_ms = []
    for images, pt in batches:
        _synchronize(dev)
        s0 = time.perf_counter()
        _, comps = trainer.step_fn(trainer.state, images, pt)
        _synchronize(dev)
        step_ms.append((time.perf_counter() - s0) * 1e3)
    steady = step_ms[1:]
    _synchronize(dev)
    s0 = time.perf_counter()
    for images, pt in batches:
        trainer.step_fn(trainer.state, images, pt)
    _synchronize(dev)
    device_ips = len(batches) * FLAGSHIP_BATCH / (time.perf_counter() - s0)
    # the GT decode alone, as the step runs it (float32, TF32 off)
    pt = batches[0][1]
    decode_param_targets(trainer.flame, pt)
    reps = 10
    _synchronize(dev)
    s0 = time.perf_counter()
    for _ in range(reps):
        decode_param_targets(trainer.flame, pt)
    _synchronize(dev)
    decode_ms = (time.perf_counter() - s0) * 1e3 / reps
    median = float(np.median(steady))
    log(f"  step alone (device-resident batches of {FLAGSHIP_BATCH}): first "
        f"{step_ms[0]:.2f} ms, then median {median:.2f} ms ({min(steady):.2f}-"
        f"{max(steady):.2f}) over {len(steady)}; device-fed {device_ips:.2f} images/s; "
        f"decode_param_targets of {FLAGSHIP_BATCH} x {trainer.cfg.max_gt_boxes} rows "
        f"{decode_ms:.3f} ms = {100 * decode_ms / median:.1f}% of a step")
    busy = None
    if is_cuda:
        try:
            images, pt = batches[0]
            busy = profile_window(
                f"one flagship step, batch {FLAGSHIP_BATCH} at {FLAGSHIP_SIZE} px",
                lambda: trainer.step_fn(trainer.state, images, pt))
        except RuntimeError as exc:  # the profiler is a reading, not a check
            log(f"  flagship profiler: not measured ({exc})")
    log(f"  flagship device busy share: "
        f"{'not measured' if busy is None else f'{100 * busy:.1f}%'}")

    # decode_param_targets on the card against the CPU, one collated batch
    cpu_flame = FlameModel.from_assets(device="cpu")
    decode_err = _close_fields(decode_param_targets(trainer.flame, host[0][1]),
                               decode_param_targets(cpu_flame, host[0][1]))
    log(f"  decode_param_targets, card against CPU on one batch: max difference "
        f"{decode_err:.3e} of each field's largest magnitude")
    if decode_err > DECODE_RTOL:
        raise AssertionError("decode_param_targets: card and CPU disagree")

    # the extreme-batch panel with no TensorBoard logger (JPEG on disk)
    viz_dir = os.path.join(root, "viz")
    viz = ExtremeBatchVisualizationCallback(viz_dir, freq=1, logger=None)
    for (images, pt), c in zip(host, losses):
        viz.update(c["loss"], images, pt.gt_bboxes, pt.pad_gt_mask[..., 0])
    viz.on_epoch_end(0, predict_fn=trainer._predict_for_viz)
    panel = cv2.imread(os.path.join(viz_dir, "extreme_batch_epoch0.jpg"))
    shape = None if panel is None else panel.shape
    log(f"  extreme-batch panel: {shape}")
    if shape != (FLAGSHIP_BATCH * FLAGSHIP_SIZE, 2 * FLAGSHIP_SIZE, 3):
        raise AssertionError(f"extreme-batch panel of shape {shape}")
    loss_cfg = trainer.cfg.loss
    del trainer, batches

    # one sample through both wires from the same weights, float32
    wires = wire_steps(dev, data, loss_cfg)
    worst = max(abs(wires["params"][k] - wires["dense"][k])
                / max(abs(wires["dense"][k]), 1e-12) for k in wires["dense"]
                if k.startswith("loss"))
    log(f"  one sample, float32: dense wire {wires['dense']}")
    log(f"  one sample, float32: params wire {wires['params']}")
    log(f"  params wire against dense wire: max loss-component relative difference "
        f"{worst:.3e} (bar {WIRE_RTOL:g})")
    if wires["params"]["num_pos"] != wires["dense"]["num_pos"] or worst > WIRE_RTOL:
        raise AssertionError("the params-wire step disagrees with the dense-wire step")

    # the dense wire through the entry point: a short epoch on the card
    dense = build_trainer(flagship_argv(data, ckpt_root, dev, params_wire=False) + [
        f"steps_per_epoch={DENSE_STEPS}"])
    t0 = time.perf_counter()
    dense_metrics = dense.train()
    dense_losses = [_components(c)["loss"] for c in dense.step_components]
    log(f"  dense wire ({type(dense.train_dataset).__name__}): {dense.state.step} steps, "
        f"losses {[round(v, 4) for v in dense_losses]}, validation KeypointsNME "
        f"{dense_metrics.get('KeypointsNME')}, {time.perf_counter() - t0:.2f} s")
    if dense.state.step != DENSE_STEPS or dense.ckpt.latest_step() != DENSE_STEPS or \
            not all(np.isfinite(dense_losses)) or \
            not isinstance(dense.train_dataset, DAD3DHeadsDataset):
        raise AssertionError("the dense-wire trainer did not train")

    return {"launches": {"rasterize_zbuffer": render_launches + train_launches,
                         "pncc_render": r.pncc_render_cuda.launches},
            "launches_rendering": render_launches, "launches_training": train_launches,
            "scenes_per_s": scenes / render_s, "heads_kept": kept,
            "step_ms_first": step_ms[0], "step_ms_median": median,
            "step_ms_spread": [min(steady), max(steady)],
            "device_fed_images_per_s": device_ips, "loader_images_per_s": loader_ips,
            "decode_param_targets_ms": decode_ms, "decode_share": decode_ms / median,
            "peak_memory_bytes": peak, "device_busy_share": busy,
            "loss_first": losses[0], "loss_last": losses[-1], "validation": metrics,
            "decode_card_vs_cpu": decode_err, "wires": wires,
            "data_dir": data, "ckpt_dir": ckpt_dir}


def phase_standin_kernel(flame_model):
    """The kernel against its plain version at the DAD stand-in renderer's
    input (a sample of three heads at EVAL_SIZE, drawn as one mesh), bit for
    bit, and its times there."""
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.tools.render_dad_testset import DadRenderer, sample_seed

    s = EVAL_SIZE
    renderer = DadRenderer(s, DAD_MAX_HEADS, device=flame_model.device, flame_model=flame_model)
    index = next(i for i in range(10000) if int(np.random.RandomState(
        sample_seed(DAD_SEED, i)).choice(np.arange(1, DAD_MAX_HEADS + 1))) == 3)
    args = renderer.scene_mesh(renderer.place(np.random.RandomState(sample_seed(DAD_SEED, index))))
    got, want, err = check_zbuffer(r, f"DAD stand-in sample {index} (3 heads as one mesh)",
                                   args, s, s)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])) or not want[1].any():
        raise AssertionError("the kernel is not bit-equal to plain at the stand-in's input")
    timed = time_entry(r, "rasterize_zbuffer", "the DAD stand-in's pass (3 heads as one mesh)",
                       *args, s)
    return err, {k: timed[k] for k in ("timed_at", "ms", "device_ms", "plain_ms", "bound_ms",
                                       "bound_by")}


def _per_sample(evaluator) -> list:
    return [{k: rec[k] for k in ("index", "nme_2d", "z_n", "rot_error", "angle_error",
                                 "chamfer")} for rec in evaluator.selected]


def phase_evaluation(dev, detector, scenes, root: str, data: str, ckpt_dir: str) -> dict:
    """Weights in and out and the evaluation protocols at EVAL_SIZE: the
    shipped checkpoint's round trip, the export of phase 8's flagship step,
    the DAD and FDDB stand-ins, the protocols on the card, and the card
    against the CPU on the first samples."""
    from head_detector_tpu_torch.detector import HeadDetector
    from head_detector_tpu_torch.evaluation.evaluate_dad import DadEvaluator, DadSample
    from head_detector_tpu_torch.evaluation.evaluate_fddb import evaluate_fddb
    from head_detector_tpu_torch.evaluation.predictor import EvalPredictor
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.tools import eval_checkpoint, run_protocols
    from head_detector_tpu_torch.tools.make_fddb_standin import make_fddb_standin
    from head_detector_tpu_torch.tools.render_dad_testset import render_testset, sample_seed
    from head_detector_tpu_torch.weights import (
        flax_from_state_dict,
        load_variables,
        save_variables,
        train_state_dict_from_flax,
    )

    # 1. the shipped checkpoint through the port's training layout and back
    t0 = time.perf_counter()
    shipped = load_variables(CHECKPOINT)
    state, used = train_state_dict_from_flax(shipped)
    back = eval_checkpoint.cast_float32_leaves(flax_from_state_dict(state), np.float16)
    reexport = os.path.join(root, "reexport.msgpack")
    save_variables(back, reexport)
    with open(reexport, "rb") as f, open(CHECKPOINT, "rb") as g:
        same_bytes = f.read() == g.read()
    again = load_variables(reexport)
    leaves = flatten_tree(shipped)
    unequal = [k for k, v in flatten_tree(again).items()
               if v.dtype != leaves[k].dtype or v.tobytes() != leaves[k].tobytes()]
    log(f"  round trip of the shipped checkpoint ({used} leaves, "
        f"{time.perf_counter() - t0:.2f} s): bytes equal {same_bytes}, leaves not bit-equal "
        f"{len(unequal)} of {len(leaves)}")
    if not same_bytes or unequal or len(flatten_tree(again)) != len(leaves):
        raise AssertionError("the shipped checkpoint does not survive the round trip")
    redet = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=reexport, device=dev)
    same_detections(redet.predict_batch(scenes, confidence_threshold=0.5),
                    detector.predict_batch(scenes, confidence_threshold=0.5),
                    "the re-exported checkpoint")
    log(f"  HeadDetector on the re-export: boxes and scores bit-equal to phase 3's detector on "
        f"{len(scenes)} scenes")
    del redet

    # 2. phase 8's flagship step: score both parameter sets, export f32 and f16
    exports = {}
    t0 = time.perf_counter()
    scored = eval_checkpoint.main([
        "--ckpt-dir", ckpt_dir, "--arch", MODEL, "--image-size", str(FLAGSHIP_SIZE),
        "--which", "both", "--data-dir", data, "--batch-size", str(FLAGSHIP_BATCH),
        "--export-msgpack", os.path.join(root, "step_raw_f32.msgpack"), "--device", str(dev)])
    eval_s = time.perf_counter() - t0
    log(f"  eval_checkpoint --which both on the flagship step ({eval_s:.2f} s): "
        f"raw {scored['raw']}; EMA {scored['ema']}")
    if set(scored) != {"raw", "ema"} or not all(
            np.isfinite(v) for m in scored.values() for v in m.values()):
        raise AssertionError(f"eval_checkpoint metrics: {scored}")
    eval_checkpoint.main(["--ckpt-dir", ckpt_dir, "--arch", MODEL, "--image-size",
                          str(FLAGSHIP_SIZE), "--which", "ema", "--no-eval", "--export-msgpack",
                          os.path.join(root, "step_ema_f16.msgpack"), "--export-dtype", "f16",
                          "--device", str(dev)])
    for name in ("step_raw_f32", "step_ema_f16"):
        path = os.path.join(root, name + ".msgpack")
        det = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=path, device=dev)
        results = det.predict_batch(scenes, confidence_threshold=0.5)
        heads = [len(res.heads) for res in results]
        exports[name] = {"leaves": list(det.restored_leaves), "bytes": os.path.getsize(path),
                         "heads": heads}
        log(f"  HeadDetector on {name}: restored {det.restored_leaves[0]}/"
            f"{det.restored_leaves[1]} leaves, {os.path.getsize(path)} bytes, heads per scene "
            f"{heads}")
        if det.restored_leaves[0] != det.restored_leaves[1] or not all(
                np.isfinite(h.vertices_3d).all() for res in results for h in res.heads):
            raise AssertionError(f"the exported {name} does not serve")
        del det

    # 3. the stand-in sets, launch counts zeroed first
    dad_dir, fddb_dir = os.path.join(root, "dad_standin"), os.path.join(root, "fddb_standin")
    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    _synchronize(dev)
    t0 = time.perf_counter()
    done = render_testset(dad_dir, DAD_SAMPLES, EVAL_SIZE, DAD_SEED, DAD_MAX_HEADS, device=dev,
                          log_every=0)
    _synchronize(dev)
    render_s = time.perf_counter() - t0
    launches = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                "pncc_render": r.pncc_render_cuda.launches}
    heads = [int(np.random.RandomState(sample_seed(DAD_SEED, i)).choice(
        np.arange(1, DAD_MAX_HEADS + 1))) for i in range(DAD_SAMPLES)]
    log(f"  rendered {done['samples']} DAD stand-in samples at {EVAL_SIZE} px ({sum(heads)} "
        f"heads) in {render_s:.2f} s: {DAD_SAMPLES / render_s:.2f} samples/s; launches "
        f"{launches} (one a sample expected)")
    if launches["rasterize_zbuffer"] != DAD_SAMPLES:
        raise AssertionError("the DAD stand-in renderer did not launch the kernel once a sample")
    n_fddb = make_fddb_standin(data, fddb_dir, "val")
    log(f"  FDDB stand-in: {n_fddb} images of phase 8's validation split")

    # 4. the protocols on the card
    out = os.path.join(root, "protocols.json")
    protocols = run_protocols.main([
        "--checkpoint", CHECKPOINT, "--arch", MODEL, "--image-size", str(EVAL_SIZE),
        "--dad-json", os.path.join(dad_dir, "dataset.json"), "--dad-base", dad_dir,
        "--fddb-dir", fddb_dir, "--out", out, "--device", str(dev)])
    dad_ms = protocols["seconds"]["dad"] * 1e3 / DAD_SAMPLES
    fddb_ms = protocols["seconds"]["fddb"] * 1e3 / n_fddb
    log(f"  DAD on the card ({DAD_SAMPLES} samples): {protocols['dad']}; host "
        f"{dad_ms:.2f} ms/sample")
    log(f"  FDDB on the card ({n_fddb} images): {protocols['fddb']}; host "
        f"{fddb_ms:.2f} ms/image")
    if not all(np.isfinite(v) for v in protocols["dad"].values()) or \
            not 0.0 < protocols["fddb"]["AP"] <= 1.0:
        raise AssertionError(f"protocol results: {protocols}")

    # 5. the card against the CPU on the first samples, float32 with TF32 off
    with open(os.path.join(dad_dir, "dataset.json")) as f:
        samples = [DadSample.from_config(c, dad_dir) for c in json.load(f)["standin"]]
    fddb_check = os.path.join(root, "fddb_check")
    make_fddb_standin(data, fddb_check, "val", limit=CHECK_SAMPLES)
    kw = dict(model_name=MODEL, checkpoint=CHECKPOINT, image_size=EVAL_SIZE,
              confidence_threshold=0.2, nms_iou_threshold=0.5, post_nms_max_predictions=30)
    sides = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        predictor = EvalPredictor(device=where, **kw)
        evaluator = DadEvaluator(samples[:CHECK_SAMPLES], predictor)
        dad_result = evaluator()
        predictor.callback = fddb_callback(predictor)
        sides[str(where)] = {"dad": dad_result, "per_sample": _per_sample(evaluator),
                             "fddb": evaluate_fddb(fddb_check, predictor),
                             "seconds": time.perf_counter() - t0}
    card, cpu = sides[str(dev)], sides["cpu"]
    worst = {"nme_2d": 0.0, "chamfer": 0.0, "rot_error": 0.0, "angle_error": 0.0, "z_n": 0.0}
    for g, w in zip(card["per_sample"], cpu["per_sample"]):
        if g["index"] != w["index"]:
            raise AssertionError(f"card and CPU select different heads: {g} {w}")
        for k in ("nme_2d", "chamfer"):
            worst[k] = max(worst[k], abs(g[k] - w[k]) / abs(w[k]))
        for k in ("rot_error", "angle_error", "z_n"):
            worst[k] = max(worst[k], abs(g[k] - w[k]))
    ap_diff = abs(card["fddb"]["AP"] - cpu["fddb"]["AP"])
    bars = {"nme_2d": 1e-3, "chamfer": 1e-3, "rot_error": 1e-4, "angle_error": 1e-2, "z_n": 1e-2}
    log(f"  card against CPU on {CHECK_SAMPLES} DAD samples (CPU {cpu['seconds']:.2f} s, card "
        f"{card['seconds']:.2f} s): same heads selected "
        f"{[g['index'] for g in card['per_sample']]}; largest differences "
        + ", ".join(f"{k} {v:.3e} (bar {bars[k]:g})" for k, v in worst.items())
        + f"; FDDB AP of {CHECK_SAMPLES} images {card['fddb']['AP']:.6f} against "
        f"{cpu['fddb']['AP']:.6f}, |d| {ap_diff:.3e} (bar 1e-3)")
    if len(card["per_sample"]) != CHECK_SAMPLES or any(worst[k] > bars[k] for k in bars) or \
            ap_diff > 1e-3:
        raise AssertionError("the protocols on the card disagree with the CPU")

    return {"launches": launches, "dad_dir": dad_dir, "fddb_dir": fddb_dir,
            "fddb_images": n_fddb, "dad_samples_per_s": DAD_SAMPLES / render_s,
            "dad": protocols["dad"], "fddb": protocols["fddb"], "dad_host_ms": dad_ms,
            "fddb_host_ms": fddb_ms, "eval_checkpoint": scored, "exports": exports,
            "card_vs_cpu": worst, "fddb_ap_card_vs_cpu": ap_diff}


# ------------------------------------------------------------ phase 10
COCO_POSE = np.array([  # a standing person's COCO-17 joints, in head units from the nose
    (0.0, 0.0), (0.15, -0.12), (-0.15, -0.12), (0.3, -0.05), (-0.3, -0.05),
    (0.8, 1.1), (-0.8, 1.1), (1.0, 2.2), (-1.0, 2.2), (1.1, 3.2), (-1.1, 3.2),
    (0.5, 3.3), (-0.5, 3.3), (0.55, 4.8), (-0.55, 4.8), (0.6, 6.3), (-0.6, 6.3)])
CAPTIONS = ("a photo of a {} in a park", "a {} and a {} at the beach", "portrait of a {}",
            "{} at a street market", "a {} talking to a {}")
CAPTION_WORDS = ("man", "woman", "person", "male", "female", "people")


def seeded_pose_model(seed: int):
    """A stand-in pose model: image -> [N, 17, 3] COCO-17 keypoints of 1 to
    FACTORY_MAX_PEOPLE standing people, side by side, drawn from ``seed``."""
    def model(image):
        rng = np.random.RandomState(seed)
        h, w = image.shape[:2]
        n = int(rng.randint(1, FACTORY_MAX_PEOPLE + 1))
        people = []
        for i in range(n):
            unit = rng.uniform(0.045, 0.11) * min(h, w) / np.sqrt(n)
            nose = np.array([(i + rng.uniform(0.35, 0.65)) / n * w, rng.uniform(0.12, 0.45) * h])
            xy = nose + COCO_POSE * unit + rng.normal(0, 0.04 * unit, COCO_POSE.shape)
            people.append(np.concatenate([xy, np.full((17, 1), 0.9)], 1))
        return np.stack(people)
    return model


def write_pose_canvases(out: str) -> dict:
    """FACTORY_IMAGES pose canvases (``PoseConditioningProcessor`` with a seeded
    keypoint model, then ``draw_bodypose``) as JPEG under ``out/images``,
    and ``out/annotations.json`` of captions made of ETHNIC_LABELS words."""
    import cv2

    from head_detector_tpu_torch.data_factory.generation import (
        ETHNIC_LABELS,
        PoseConditioningProcessor,
    )

    os.makedirs(os.path.join(out, "images"))
    rng = np.random.RandomState(FACTORY_SEED)
    blank = np.zeros((FACTORY_SIZE, FACTORY_SIZE, 3), np.uint8)
    captions = {}
    for i in range(FACTORY_IMAGES):
        canvas = PoseConditioningProcessor(seeded_pose_model(FACTORY_SEED * 1000 + i),
                                           img_size=FACTORY_SIZE)(blank)
        name = f"pose_{i:04d}"
        cv2.imwrite(os.path.join(out, "images", name + ".jpg"),
                    cv2.cvtColor(canvas, cv2.COLOR_RGB2BGR))
        template = CAPTIONS[rng.randint(len(CAPTIONS))]
        words = rng.choice(CAPTION_WORDS, template.count("{}"))
        captions[name] = {"caption": template.format(*words)}
    if not all(w in ETHNIC_LABELS for w in CAPTION_WORDS):
        raise AssertionError("a caption word is not a key of ETHNIC_LABELS")
    with open(os.path.join(out, "annotations.json"), "w") as f:
        json.dump(captions, f)
    return captions


def phase_factory_generation(dev, flame_model, root: str) -> dict:
    """Pose canvases, then ``DataGenerator`` with ``FlameRenderBackend`` at
    FACTORY_SIZE on ``dev``, the launch counts zeroed just before and read
    just after: one launch an image, and the split of an image's time."""
    import random

    import cv2

    from head_detector_tpu_torch.data_factory import generation
    from head_detector_tpu_torch.data_factory.generation import (
        CaptionProcessor,
        DataGenerator,
        FlameRenderBackend,
    )
    from head_detector_tpu_torch.ops import rasterize as r

    poses, out = os.path.join(root, "poses"), os.path.join(root, "generated")
    t0 = time.perf_counter()
    write_pose_canvases(poses)
    log(f"  {FACTORY_IMAGES} pose canvases at {FACTORY_SIZE} px in "
        f"{time.perf_counter() - t0:.2f} s")

    backend = FlameRenderBackend(FACTORY_SIZE, device=dev, flame_model=flame_model)
    clock = {"draws": 0.0, "render": 0.0, "parse": 0.0, "background": 0.0}
    drawn = {}

    def timed(name, fn):
        def call(*args):
            t = time.perf_counter()
            got = fn(*args)
            clock[name] += time.perf_counter() - t  # render ends with the download
            if name == "draws":
                drawn[args[0]] = (args[1], len(got[0]))
            return got
        return call

    backend.draws = timed("draws", backend.draws)
    backend.render = timed("render", backend.render)
    generator = DataGenerator(pipeline=backend,
                              caption_processor=CaptionProcessor(use_ner=False,
                                                                 rng=random.Random(0)),
                              rng=random.Random(0))
    # the draws' two large parts, timed where the backend looks them up
    parse, background = generation.parse_pose_heads, generation.make_background
    generation.parse_pose_heads = timed("parse", parse)
    generation.make_background = timed("background", background)
    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    _synchronize(dev)
    t0 = time.perf_counter()
    try:
        written = generator.generate(poses, out)
        _synchronize(dev)
    finally:
        generation.parse_pose_heads, generation.make_background = parse, background
    gen_s = time.perf_counter() - t0
    launches = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                "pncc_render": r.pncc_render_cuda.launches}
    heads = [n for _, n in drawn.values()]
    images = [cv2.imread(p) for p in written]
    t0 = time.perf_counter()
    for image in images:
        cv2.imencode(".jpg", image, [cv2.IMWRITE_JPEG_QUALITY, 95])
    jpeg_ms = (time.perf_counter() - t0) * 1e3 / len(images)
    n = len(written)
    per = {k: v * 1e3 / max(n, 1) for k, v in clock.items()}
    rest = gen_s * 1e3 / max(n, 1) - per["draws"] - per["render"]
    log(f"  DataGenerator + FlameRenderBackend: {n} images at {FACTORY_SIZE} px in "
        f"{gen_s:.2f} s, {n / gen_s:.2f} images/s, heads per image {heads}; launches "
        f"{launches} (one an image expected)")
    log(f"  an image: host draws {per['draws']:.2f} ms (the pose canvas's parse "
        f"{per['parse']:.2f}, the background with its {FACTORY_SIZE}^2 noise "
        f"{per['background']:.2f}), card (decode, float64 placement, launch, composite, "
        f"download) {per['render']:.2f} ms, the rest (pose read, captions, JPEG write) "
        f"{rest:.2f} ms; a JPEG encode alone {jpeg_ms:.2f} ms")
    if n != FACTORY_IMAGES or len(drawn) != n or launches["rasterize_zbuffer"] != n:
        raise AssertionError("the data generator did not write one image a canvas, "
                             "each with one launch")
    if any(im is None or im.shape != (FACTORY_SIZE, FACTORY_SIZE, 3) for im in images):
        raise AssertionError("a generated image is unreadable or malformed")
    caption = max(drawn, key=lambda c: drawn[c][1])
    return {"launches": launches, "images": n, "images_per_s": n / gen_s,
            "heads": heads, "draws_ms": per["draws"], "parse_ms": per["parse"],
            "background_ms": per["background"], "card_ms": per["render"],
            "rest_ms": rest, "jpeg_ms": jpeg_ms,
            "split_dir": os.path.dirname(os.path.dirname(written[0])),
            "largest": (caption, drawn[caption][0])}


def phase_factory_kernel(flame_model, caption: str, pose: np.ndarray):
    """The kernel against its plain version at the factory's input with the
    most heads (one launch of every head, a z-buffer each, at FACTORY_SIZE),
    bit for bit, its times there, and the backend on the card against the
    backend on the CPU for that caption and canvas."""
    from head_detector_tpu_torch.data_factory.generation import FlameRenderBackend
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.train.dataset import scene_tables

    s, dev = FACTORY_SIZE, flame_model.device
    backend = FlameRenderBackend(s, device=dev, flame_model=flame_model)
    heads, params, rots, _ = backend.draws(caption, pose)
    faces, colors = scene_tables(dev)
    args = (backend.place(heads, params, rots), faces, colors)
    got, want, err = check_zbuffer(r, f"factory image of {len(heads)} heads", args, s, s)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])) or \
            not want[1].any(-1).any(-1).all():
        raise AssertionError("the kernel is not bit-equal to plain at the factory's input")
    timed = time_entry(r, "rasterize_zbuffer",
                       f"the factory's image ({len(heads)} heads, a z-buffer each)", *args, s)

    card = backend(caption, pose)
    t0 = time.perf_counter()
    cpu = FlameRenderBackend(s, device="cpu")(caption, pose)
    cpu_s = time.perf_counter() - t0
    equal = int((card == cpu).all(-1).sum())
    log(f"  FlameRenderBackend on the card against the CPU ({cpu_s:.2f} s there), caption "
        f"{caption!r}: {equal} of {s * s} pixels equal ({equal / (s * s):.6f}, bar "
        f"{FACTORY_PIXELS})")
    if card.shape != cpu.shape or equal < FACTORY_PIXELS * s * s:
        raise AssertionError("FlameRenderBackend on the card disagrees with the CPU")
    return err, {**{k: timed[k] for k in ("timed_at", "ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by")},
                 "pixels_equal_card_vs_cpu": equal}


def best_ious(gt_xywh: np.ndarray, boxes_xywh: np.ndarray) -> np.ndarray:
    """For each GT box, the best IoU with any of ``boxes_xywh``."""
    from head_detector_tpu_torch.metrics import box_iou_np, xywh_to_xyxy_np

    if not len(boxes_xywh):
        return np.zeros(len(gt_xywh))
    return box_iou_np(xywh_to_xyxy_np(np.asarray(gt_xywh, np.float64)),
                      xywh_to_xyxy_np(np.asarray(boxes_xywh, np.float64))).max(1)


def check_round_trip(loop: str, data: str, dev) -> dict:
    """Every pseudo-annotation decoded by ``decode_dad_annotation`` and offset
    by its crop's origin against the teacher's projected vertices of that
    crop, and the pseudo boxes against the rendered GT."""
    import cv2

    from head_detector_tpu_torch.dad_teacher import FaceMeshPredictor
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.train.dataset import decode_dad_annotation

    teacher = FaceMeshPredictor(model_name=MODEL, checkpoint=CHECKPOINT, device=dev)
    flame = FlameModel.from_assets(device=dev)
    worst, heads, ious = 0.0, 0, []
    files = sorted(os.listdir(os.path.join(loop, "train", "annotations")))
    for name in files:
        ann = np.load(os.path.join(loop, "train", "annotations", name))
        stem = name[:-len(".npz")]
        image = cv2.cvtColor(cv2.imread(os.path.join(loop, "train", "images", stem + ".jpg")),
                             cv2.COLOR_BGR2RGB)
        _, projected, _ = decode_dad_annotation(flame, ann["3dmm_params"].reshape(-1, 413))
        projected = projected.cpu().numpy().astype(np.float64)
        for h, (x, y, w, hh) in enumerate(ann["extended_bbox"]):
            want = teacher(image[y:y + hh, x:x + w])["projected_vertices"] + (x, y)
            got = projected[h] + (x, y)
            excess = np.abs(got - want) - (ROUND_TRIP_PX + ROUND_TRIP_RTOL * np.abs(want))
            worst = max(worst, float(excess.max()))
            heads += 1
        gt = np.load(os.path.join(data, "train", "annotations", name))["bbox"]
        ious.extend(best_ious(gt, ann["bbox"]))
    ious = np.asarray(ious)
    return {"files": len(files), "heads": heads, "worst_excess_px": worst,
            "gt_matched_share": float((ious >= 0.5).mean()), "gt_mean_iou": float(ious.mean())}


def phase_factory_tools(dev, scenes, root: str, data: str, ckpt_dir: str, split_dir: str) -> dict:
    """Cleaning, the teacher loop (prepare, annotate, the student, report),
    ``score_final``, ``diagnose_recall`` on the card against the CPU, and the
    ``test_folder`` and ``head_alignment`` command lines."""
    import cv2

    from head_detector_tpu_torch.data_factory import HeadBoxDetector, filter_data
    from head_detector_tpu_torch.detector import HeadDetector
    from head_detector_tpu_torch.evaluation import head_alignment, test_folder
    from head_detector_tpu_torch.tools import diagnose_recall, eval_checkpoint, run_teacher_loop
    from head_detector_tpu_torch.tools import score_final
    from head_detector_tpu_torch.train.__main__ import build_trainer
    from head_detector_tpu_torch.train.checkpoint import CheckpointManager
    from head_detector_tpu_torch.train.param_wire import RenderedHeadsDataset, collate_param_samples

    out = {}
    # 5. cleaning: up to seven detector calls an image
    detector = HeadBoxDetector(model=MODEL, checkpoint=CHECKPOINT, image_size=FILTER_SIZE,
                               confidence_threshold=0.5, device=dev)
    t0 = time.perf_counter()
    cleaned = filter_data(split_dir, split_dir, detector)
    filter_ms = (time.perf_counter() - t0) * 1e3 / FACTORY_IMAGES
    with open(os.path.join(split_dir, "metrics.json")) as f:
        kept = json.load(f)
    log(f"  filter_data over the generated split: {cleaned}, {filter_ms:.2f} ms an image; "
        f"flip IoU of the kept {[round(v['flip_iou'], 3) for v in kept.values()]}")
    if cleaned["kept"] + cleaned["excluded"] != FACTORY_IMAGES or len(kept) != cleaned["kept"] \
            or not os.path.isfile(os.path.join(split_dir, "files.txt")):
        raise AssertionError("filter_data did not account for every image")
    out["filter"] = {**cleaned, "ms_per_image": filter_ms}

    # 6-7. the teacher loop on phase 8's rendered train split, val linked to its real GT
    loop = os.path.join(root, "teacher_loop")
    run_teacher_loop.main(["prepare", "--src", os.path.join(data, "train"), "--val-src",
                           os.path.join(data, "val"), "--out", loop, "--limit",
                           str(TEACHER_IMAGES)])
    _synchronize(dev)
    t0 = time.perf_counter()
    run_teacher_loop.main(["annotate", "--out", loop, "--checkpoint", CHECKPOINT, "--arch",
                           MODEL, "--image-size", str(FILTER_SIZE), "--device", str(dev)])
    _synchronize(dev)
    annotate_ms = (time.perf_counter() - t0) * 1e3 / TEACHER_IMAGES
    summary = run_teacher_loop.report(loop)
    trip = check_round_trip(loop, data, dev)
    log(f"  annotate: {annotate_ms:.2f} ms an image (teacher at 256 px, detector at "
        f"{FILTER_SIZE} px), {summary}")
    log(f"  round trip over {trip['heads']} heads of {trip['files']} files: worst excess over "
        f"{ROUND_TRIP_PX} px + {ROUND_TRIP_RTOL} relative {trip['worst_excess_px']:.3e} px; "
        f"rendered GT heads matched at IoU >= 0.5: {trip['gt_matched_share']:.4f}, mean IoU "
        f"{trip['gt_mean_iou']:.4f}")
    if summary["annotated_images"] < TEACHER_IMAGES // 2 or trip["heads"] == 0 or \
            trip["worst_excess_px"] > 0 or summary["total_pseudo_heads"] != trip["heads"]:
        raise AssertionError("the pseudo-annotations do not round-trip to the teacher")
    out["annotate"] = {"ms_per_image": annotate_ms, **summary, **trip}

    # 8. the student on the pseudo-labels, validated on the real GT
    trainer = build_trainer(["--config-name", STUDENT, "--device", str(dev),
                             f"dataset_params.data_dir={loop}",
                             f"steps_per_epoch={STUDENT_STEPS}",
                             "training_hyperparams.epochs_per_run=1",
                             f"ckpt_root_dir={os.path.join(root, 'student')}"])
    cfg = trainer.cfg
    log(f"  {STUDENT}: {trainer.arch.name} at {cfg.image_size} px, batch {cfg.batch_size}, "
        f"{cfg.max_gt_boxes} GT boxes, {type(trainer.train_dataset).__name__} of "
        f"{len(trainer.train_dataset)} images, mixed precision {cfg.mixed_precision}")
    if (trainer.arch.name, cfg.image_size, cfg.batch_size, cfg.max_gt_boxes) != \
            ("yolo_heads_n", 320, 16, 4) or not cfg.mixed_precision or \
            not isinstance(trainer.train_dataset, RenderedHeadsDataset):
        raise AssertionError("the student is not the teacher_student configuration")
    metrics = trainer.train()
    losses = [_components(c) for c in trainer.step_components]
    timing = trainer.timings[-1]
    step_ms = timing["train_s"] * 1e3 / trainer.state.step
    log(f"  student: {trainer.state.step} steps, loss at each step "
        f"{[round(c['loss'], 4) for c in losses]}, {step_ms:.2f} ms a step over the epoch "
        f"(the first step's set-up included), loader-fed "
        f"{timing['images'] / timing['train_s']:.2f} images/s; validation on the real GT "
        f"{metrics}; checkpoint at step {trainer.ckpt.latest_step()}")
    # an image without a detection has no pseudo-annotation: the epoch is
    # cut to the batches there are
    steps = min(STUDENT_STEPS, len(trainer.train_dataset) // cfg.batch_size)
    if not 0 < trainer.state.step == steps or trainer.ckpt.latest_step() != steps or \
            not all(np.isfinite(v) for c in losses for v in c.values()):
        raise AssertionError("the student did not train")
    # the step alone on one device-resident batch
    images, pt = collate_param_samples([trainer.train_dataset[i] for i in range(cfg.batch_size)],
                                       cfg.max_gt_boxes)
    images, pt = torch.as_tensor(images).to(dev), pt.to(dev)
    alone = []
    for _ in range(STUDENT_TIMED):
        _synchronize(dev)
        s0 = time.perf_counter()
        trainer.step_fn(trainer.state, images, pt)
        _synchronize(dev)
        alone.append((time.perf_counter() - s0) * 1e3)
    log(f"  student step alone (a device-resident batch of {cfg.batch_size}): median "
        f"{np.median(alone):.2f} ms ({min(alone):.2f}-{max(alone):.2f}) over {len(alone)}, "
        f"{cfg.batch_size * 1e3 / np.median(alone):.2f} images/s device-fed")
    run_teacher_loop.main(["report", "--out", loop])
    out["student"] = {"steps": steps, "epoch_ms_per_step": step_ms,
                      "step_ms_alone": float(np.median(alone)),
                      "loader_images_per_s": timing["images"] / timing["train_s"],
                      "loss_first": losses[0], "loss_last": losses[-1], "validation": metrics}
    del trainer

    # 9. score_final on phase 8's flagship step directory against eval_checkpoint
    steps = CheckpointManager(ckpt_dir).all_steps()
    scored = score_final.main([
        "--ckpt-dir", ckpt_dir, "--arch", MODEL, "--image-size", str(FLAGSHIP_SIZE),
        "--data-dir", data, "--split", "val", "--average-best", str(len(steps)),
        "--export-f32", os.path.join(root, "final_f32.msgpack"),
        "--export-f16", os.path.join(root, "final_f16.msgpack"), "--device", str(dev)])
    common = ["--ckpt-dir", ckpt_dir, "--arch", MODEL, "--image-size", str(FLAGSHIP_SIZE),
              "--data-dir", data, "--max-boxes", "4", "--device", str(dev)]
    best = scored["best_step"]
    reading = eval_checkpoint.main(common + ["--step", str(best), "--which", "both"])
    reading["avg"] = eval_checkpoint.main(common + ["--which", "ema", "--average-best",
                                                    str(len(steps))])["ema"]
    worst = 0.0
    for name, result in scored["results"].items():
        want = reading["raw" if name.startswith("raw@") else
                       "ema" if name.startswith("ema@") else "avg"]["KeypointsNME"]
        worst = max(worst, abs(result["KeypointsNME"] - want) / abs(want))
    sizes = {p: os.path.getsize(os.path.join(root, p + ".msgpack"))
             for p in ("final_f32", "final_f16")}
    log(f"  score_final: winner {scored['winner']}, KeypointsNME "
        f"{ {k: v['KeypointsNME'] for k, v in scored['results'].items()} }, against "
        f"eval_checkpoint worst relative difference {worst:.3e} (bar 1e-6); exports {sizes}")
    if worst > 1e-6 or not all(r["images"] for r in scored["results"].values()) or \
            not all(os.path.isfile(os.path.join(root, p + ".msgpack.json")) for p in sizes):
        raise AssertionError("score_final disagrees with eval_checkpoint")
    out["score_final"] = {"winner": scored["winner"], "results": scored["results"],
                          "vs_eval_checkpoint": worst, "export_bytes": sizes}

    # 10. diagnose_recall on the card against the CPU
    reports = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        reports[str(where)] = diagnose_recall.main([
            "--ckpt-dir", ckpt_dir, "--arch", MODEL, "--image-size", str(FLAGSHIP_SIZE),
            "--data-dir", data, "--assigner-batches", str(DIAGNOSE_BATCHES),
            "--device", str(where)])
        reports[str(where)]["seconds"] = time.perf_counter() - t0
    card, cpu = reports[str(dev)], reports["cpu"]
    counts = lambda rep: [(row["tp"], row["fp"], row["fn"]) for row in rep["sweep"]]  # noqa: E731
    log(f"  diagnose_recall: tp/fp/fn by threshold {counts(card)} on the card "
        f"({card['seconds']:.2f} s), the same on the CPU: {counts(card) == counts(cpu)} "
        f"({cpu['seconds']:.2f} s); assigner histogram {card['assigner']['anchors_per_gt_hist']}"
        f", the same on the CPU: {card['assigner'] == cpu['assigner']}")
    if counts(card) != counts(cpu) or card["assigner"] != cpu["assigner"] or \
            not card["n_images"] or not card["assigner"]["anchors_per_gt_hist"]:
        raise AssertionError("diagnose_recall differs between the card and the CPU")
    out["diagnose_recall"] = {"sweep": card["sweep"], "assigner": card["assigner"]}

    # 11. the folder tools over phase 3's scenes written as JPEG
    folder = os.path.join(root, "scenes")
    os.makedirs(folder)
    for i, scene in enumerate(scenes):
        cv2.imwrite(os.path.join(folder, f"scene_{i}.jpg"), cv2.cvtColor(scene, cv2.COLOR_RGB2BGR))
    common = ["--input-dir", folder, "--model", MODEL, "--checkpoint", CHECKPOINT,
              "--device", str(dev)]
    overlays = os.path.join(root, "overlays")
    total = test_folder.main(common + ["--output-dir", overlays])
    crops = {}
    for batched in (False, True):
        where = os.path.join(root, f"crops_{'batched' if batched else 'host'}")
        crops[batched] = head_alignment.main(
            common + ["--output-dir", where] + (["--device-batched"] if batched else []))
        if len(os.listdir(where)) != crops[batched]:
            raise AssertionError("head_alignment wrote another count of crops than it says")
    # the heads whose host crop is not empty (a head at the border may have none)
    det = HeadDetector(model=MODEL, checkpoint=CHECKPOINT, device=dev)
    nonempty = sum(crop.size > 0 for name in sorted(os.listdir(folder))
                   for crop in det(os.path.join(folder, name)).get_aligned_heads())
    del det
    log(f"  test_folder: {len(os.listdir(overlays))} overlays for {len(scenes)} scenes, "
        f"{total} heads; head_alignment: {crops[False]} crops ({nonempty} heads with a "
        f"non-empty crop), {crops[True]} with the batched warp")
    if sorted(os.listdir(overlays)) != sorted(os.listdir(folder)) or total == 0 or \
            crops[False] != nonempty or crops[True] != total:
        raise AssertionError("the folder tools did not write an overlay an image and a crop a head")
    out["folder_tools"] = {"overlays": len(os.listdir(overlays)), "heads": total,
                           "crops": crops[False], "crops_batched": crops[True]}
    return out


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(np.corrcoef(a.detach().double().cpu().numpy().ravel(),
                             b.detach().double().cpu().numpy().ravel())[0, 1])


def _close(label: str, got, want, atol: float, rtol: float) -> float:
    """Largest |got - want| over (atol + rtol * |want|); fails above 1."""
    ratio = float(((got - want).abs() / (atol + rtol * want.abs())).max())
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: {ratio:.3f} of the bar")
    return float((got - want).abs().max())


def match_heads(got, want):
    """(heads of ``want`` matched by a head of ``got`` at IoU >= 0.5, their
    number, the worst IoU among the matches), over results image by image."""
    matched, total, worst = 0, 0, 1.0
    for g, w in zip(got, want):
        total += len(w.heads)
        for hw in w.heads:
            best = max((iou_xywh(hg.bbox, hw.bbox) for hg in g.heads), default=0.0)
            if best >= 0.5:
                matched += 1
                worst = min(worst, best)
    return matched, total, worst


def phase_export(dev, detector, scenes, root: str) -> dict:
    """Export and quantization at full width (yolo_heads_m, the shipped
    checkpoint, 640 px, batch 8, phase 3's scenes): fusion, the .trcd and
    the serialized program against the eager model, the ONNX legs through
    ``run_onnx`` on the card, PTQ over the reference's calibration (W8, W8A8
    and FP16 against float32, the int8 artifact), the W8 checkpoint served
    through ``HeadDetector`` and ``get_pncc`` with the launch counts zeroed
    (card against CPU), and the FLOPs and MFU of the deploy forward."""
    from head_detector_tpu_torch import export, onnx_export, profiling, quantization, torch_mirror
    from head_detector_tpu_torch.detector import HeadDetector
    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.models import param_count
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.train.dataset import render_scene
    from head_detector_tpu_torch.weights import load_variables, save_variables

    out: dict = {}
    variables = load_variables(CHECKPOINT)
    x = torch.from_numpy(np.stack(scenes)).to(dev).permute(0, 3, 1, 2).float() / 255.0

    # 1. fusion: the tree HeadDetector loads, and param_count before and after
    t0 = time.perf_counter()
    model, fused = export.build_deploy(MODEL, variables, device=dev)
    out["build_deploy_s"] = time.perf_counter() - t0
    served = detector._model.state_dict()
    mine = model.state_dict()
    if served.keys() != mine.keys() or any(not torch.equal(mine[k], served[k]) for k in served):
        raise AssertionError("build_deploy's weights differ from HeadDetector's")
    counts = {}
    for name, tree in (("training", variables), ("fused", fused)):
        t0 = time.perf_counter()
        counts[name] = param_count(tree)
        counts[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    out["param_count"] = counts
    log(f"  fusion: {len(served)} tensors equal to HeadDetector's; params "
        f"{counts['training']} -> {counts['fused']} ({counts['training_ms']:.3f} and "
        f"{counts['fused_ms']:.3f} ms to count)")

    eager = torch_mirror.DecodedOutputs(model).eval()
    bars = ((2e-3, 1e-4), (1e-4, 0.0), (2e-3, 1e-3))  # boxes, scores, flame

    def forward_ms(fn, arg):
        with torch.no_grad(), exact_float32():
            return time_ms(lambda: fn(arg), launches=5, readings=3, warmup=2)[0]

    with torch.no_grad(), exact_float32():
        want = eager(x)

    # 2. the .trcd (traced on the CPU, loaded on the card) and the serialized program
    for label in ("trcd", "serialized"):
        t0 = time.perf_counter()
        if label == "trcd":
            loaded = torch_mirror.export_torchscript(
                MODEL, variables, os.path.join(root, "m.trcd"),
                image_size=(IMAGE_SIZE, IMAGE_SIZE), device=dev)
        else:
            path = os.path.join(root, "m.pt2")
            export.export_serialized(eager, (x,), path)
            loaded = export.load_serialized(path)
        made_s = time.perf_counter() - t0
        with torch.no_grad(), exact_float32():
            got = loaded(x)
        errs = [_close(f"{label} {name}", g, w, *bar)
                for name, g, w, bar in zip(("boxes", "scores", "flame"), got, want, bars)]
        out[label] = {"export_s": made_s, "max_abs_err": errs,
                      "ms": forward_ms(loaded, x), "eager_ms": forward_ms(eager, x)}
        log(f"  {label}: made in {made_s:.2f} s; against the eager model (boxes, scores, "
            f"flame) max |d| {errs}; batch {BATCH}: {out[label]['ms']:.3f} ms against eager "
            f"{out[label]['eager_ms']:.3f} ms")

    # 3. ONNX: the four legs, run_onnx on the card at batch 1
    out["onnx"] = {}
    with torch.no_grad(), exact_float32():
        want1 = eager(x[:1])
    for leg, kw in (("plain", {}), ("int8", {"quantize": "int8"}), ("fp16", {"quantize": "fp16"}),
                    ("top1000", {"pre_nms_top_k": 1000})):
        t0 = time.perf_counter()
        graph = onnx_export.export_onnx(MODEL, image_size=(IMAGE_SIZE, IMAGE_SIZE),
                                        model=torch_mirror.decoded_outputs(MODEL, variables), **kw)
        made_s = time.perf_counter() - t0
        entry = {"bytes": len(graph.serialize()), "nodes": len(graph.nodes), "export_s": made_s}
        with torch.no_grad(), exact_float32():
            got = onnx_export.run_onnx(graph, {"image": x[:1]}, device=dev)
        if leg == "plain":
            entry["max_abs_err"] = [
                _close(f"onnx {name}", g, w, 2e-4 * max(1.0, float(w.abs().max())), 0.0)
                for name, g, w in zip(("boxes", "scores", "flame"), got, want1)]
        elif leg == "top1000":
            scores = want1[1].reshape(-1)
            top = torch.topk(scores, 1000).values
            entry["max_abs_err"] = float((got[1].reshape(-1) - top).abs().max())
            if entry["max_abs_err"] > 2e-4 or tuple(got[0].shape) != (1, 1000, 4):
                raise AssertionError(f"onnx top-1000: {entry}")
        else:
            entry["score_max_abs_diff"] = float((got[1] - want1[1]).abs().max())
        out["onnx"][leg] = entry
        log(f"  onnx {leg}: {entry}")

    # 4. PTQ over the reference's calibration: 16 batches of 8 rendered scenes
    t0 = time.perf_counter()
    calib = [torch.from_numpy(np.stack([
        render_scene(SCENE_SEED, BATCH * (b + 1) + i, IMAGE_SIZE, MAX_HEADS, device=dev)
        for i in range(BATCH)])).to(dev).permute(0, 3, 1, 2).float() / 255.0
        for b in range(CALIB_BATCHES)]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with exact_float32():
        result = quantization.ptq(model, fused, calib, percentile=99.99,
                                  max_batches=CALIB_BATCHES)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    del calib
    legs = {
        "w8": (quantization.quantized_apply(model, result.variables), (0.98, 0.99, 1e-2)),
        "w8a8": (quantization.quantized_apply(model, result.variables, result.act_scales),
                 (0.95, 0.97, 2e-2)),
    }
    with torch.no_grad(), exact_float32():
        ref, raw_ref = model(x)
    quant = {"calibration_s": calib_s, "render_s": render_s, "report": result.report}
    for name, (fn, (c_cls, c_reg, med)) in legs.items():
        with exact_float32():
            dec, raw = fn(x)
        reading = {"corr_cls": _corr(raw.cls_score_list, raw_ref.cls_score_list),
                   "corr_dfl": _corr(raw.reg_distri_list, raw_ref.reg_distri_list),
                   "median_score_d": float((dec.scores - ref.scores).abs().median())}
        quant[name] = reading
        log(f"  {name}: {reading}")
        if not (reading["corr_cls"] > c_cls and reading["corr_dfl"] > c_reg
                and reading["median_score_d"] < med):
            raise AssertionError(f"{name} is not close enough to float32: {reading}")
    with exact_float32():
        dec, _ = quantization.quantized_apply(model, quantization.fp16_variables(fused))(x)
    d = (dec.scores - ref.scores).abs().reshape(-1)
    quant["fp16"] = {"p99_score_d": float(torch.quantile(d, 0.99)),
                     "median_score_d": float(d.median())}
    log(f"  fp16: {quant['fp16']}")
    if not (quant["fp16"]["p99_score_d"] < 5e-2 and quant["fp16"]["median_score_d"] < 1e-3):
        raise AssertionError(f"fp16 is not close enough to float32: {quant['fp16']}")
    artifact = os.path.join(root, "m_int8.npz")
    quant["artifact"] = quantization.save_quantized(artifact, fused)
    ratio = quant["artifact"]["quantized_bytes"] / quant["artifact"]["f32_bytes"]
    restored = flatten_tree(quantization.load_quantized(artifact))
    want_tree = flatten_tree(result.variables)
    if restored.keys() != want_tree.keys() or any(
            restored[k].tobytes() != want_tree[k].tobytes() for k in want_tree):
        raise AssertionError("load_quantized does not give back the W8 tree")
    log(f"  PTQ: {len(result.act_scales)} activation scales in {calib_s:.2f} s "
        f"({CALIB_BATCHES} batches of {BATCH}, scenes rendered in {render_s:.2f} s); int8 "
        f"artifact {quant['artifact']['quantized_bytes']:.0f} of "
        f"{quant['artifact']['f32_bytes']:.0f} float32 bytes ({ratio:.4f}); round trip exact")
    if ratio >= 0.45:
        raise AssertionError(f"the int8 artifact is {ratio:.3f} of the float32 bytes")
    out["ptq"] = quant

    # 5. the W8 checkpoint served through HeadDetector and get_pncc
    w8_path = os.path.join(root, "m_w8.msgpack")
    save_variables(result.variables, w8_path)
    w8 = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=w8_path, device=dev)
    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    torch.cuda.synchronize()
    got = w8.predict_batch(scenes, confidence_threshold=0.5)
    for res in got:
        res.get_pncc()
    out["launches"] = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                       "pncc_render": r.pncc_render_cuda.launches}
    cpu = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=w8_path, device="cpu")
    out["w8_card_vs_cpu"] = card_vs_cpu(got, cpu.predict_batch(scenes, confidence_threshold=0.5),
                                        "W8 detector")
    matched, total, worst = match_heads(got, detector.predict_batch(scenes,
                                                                    confidence_threshold=0.5))
    out["w8_vs_float32"] = {"matched": matched, "heads": total, "worst_iou": worst,
                            "w8_heads": sum(len(g.heads) for g in got)}
    log(f"  W8 detector: launches {out['launches']}; against float32: {matched} of {total} "
        f"heads matched at IoU >= 0.5, worst IoU {worst:.4f}")

    # 6. FLOPs and MFU of the deploy forward at batch 8
    with torch.no_grad(), exact_float32():
        flops = profiling.analytic_flops(model, x) / BATCH
        ms, _ = profiling.time_fn(model, x, warmup=2, iters=5)
    images_per_s = BATCH / (ms / 1e3)
    out["profile"] = {"flops_per_image": flops, "ms_per_batch": ms, "images_per_s": images_per_s,
                      "mfu_fp32": profiling.mfu(flops, images_per_s, profiling.H100_FP32_PEAK_FLOPS)}
    log(f"  deploy forward: {flops:.0f} FLOPs an image, {ms:.3f} ms a batch of {BATCH} "
        f"(time_fn), MFU against the fp32 data-sheet peak {out['profile']['mfu_fp32']:.4f}")
    return out


# ------------------------------------------------------------ phase 12
def seg_argv(data: str, ckpt_root: str, dev) -> list:
    """The entry point's flags for the SegFormer configuration on the
    rendered directory: its own 640 px, batch 8, 30 GT boxes, dense wire and
    bfloat16, random init, one epoch a process, checkpoints under
    ``ckpt_root``."""
    return ["--config-name", SEGFORMER, "--device", str(dev), f"dataset_params.data_dir={data}",
            "dataset_params.train_splits=[train]", "dataset_params.val_splits=[val]",
            f"dataset_params.image_size={SEG_SIZE}", f"dataset_params.batch_size={SEG_BATCH}",
            "training_hyperparams.epochs_per_run=1", f"ckpt_root_dir={ckpt_root}",
            "log_every=4"]


def _largest_rel(got, want) -> float:
    """max |got - want| relative to the largest |want|, float64."""
    got, want = torch.as_tensor(got).cpu().double(), torch.as_tensor(want).cpu().double()
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def seg_card_vs_cpu(dev, trained: dict, loss_cfg) -> dict:
    """One float32 train-mode step (TF32 off) of the full MiT-B5 at
    SEG_CHECK_SIZE px, batch CHECK_BATCH, on the card and on the CPU, each
    also against a float64 run of the network on the CPU
    (``tools/grad_precision``) at the first of two points: the
    configuration's starting point (random init, seed 0, BatchNorm
    calibrated) and the weights phase 12 trained (card and CPU only: the
    float64 run there, ~30 s of the script, was a reading).  Float32 cannot hold this network's gradients to phase 7's
    per-parameter bar: the CPU's own float32 is over 1e-3 of float64 on
    hundreds of parameters.  So at both points the loss components are held
    to LOSS_RTOL and the exact-zero gradients under 1e-5 of the largest, and
    at the starting point the card's gradient over the model is held within
    GRAD_REL_L2 (relative L2) of float64, or no farther from it than the
    CPU's float32 is; the trained point's distance is a reading."""
    from head_detector_tpu_torch.models import build_model, init_model
    from head_detector_tpu_torch.tools.grad_precision import compare, step_gradients
    from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset, collate_samples

    ds = SyntheticHeadsDataset(image_size=SEG_CHECK_SIZE, length=CHECK_BATCH, seed=3,
                               render=True, device=dev)
    images, targets = collate_samples([ds[i] for i in range(CHECK_BATCH)], 30)
    start = init_model(build_model(SEGFORMER, deploy=False).to(dev),
                       torch.Generator().manual_seed(0), (SEG_CHECK_SIZE, SEG_CHECK_SIZE))
    start = {k: v.detach().cpu() for k, v in start.state_dict().items()}
    out = {}
    for point, state in (("start", start), ("trained", trained)):
        t0 = time.perf_counter()
        comps, grads = {}, {}
        sides = [("card", dev, torch.float32), ("cpu", "cpu", torch.float32)]
        if point == "start":
            sides.append(("float64", "cpu", torch.float64))
        for side, where, dtype in sides:
            comps[side], grads[side] = step_gradients(SEGFORMER, state, images, targets,
                                                      loss_cfg, where, dtype)
        card, cpu = comps["card"], comps["cpu"]
        worst_loss = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu
                         if k.startswith("loss"))
        got = compare(grads, GRAD_REL_L2)
        out[point] = {"loss_rel": worst_loss, **got}
        worst = {k: v for k, v in got.items() if k.startswith("worst_")}
        log(f"  card vs {' vs '.join(s for s, _, _ in sides[1:])} (CPU), MiT-B5 at "
            f"{SEG_CHECK_SIZE} px, batch {CHECK_BATCH}, {point} weights "
            f"({time.perf_counter() - t0:.1f} s): loss {cpu['loss']:.6f}, num_pos "
            f"{cpu['num_pos']:.0f}, loss components card vs CPU {worst_loss:.3e} (bar "
            f"{LOSS_RTOL:g}); gradient relative L2 over the model {got['model_rel_l2']}; "
            f"parameters over {GRAD_REL_L2:g} of {got['parameters']}: {got['over']}; worst "
            f"against the last side {worst}; the exact-zero gradients: "
            f"{got['exact_zero']:.3e} of the largest")
        if card["num_pos"] != cpu["num_pos"] or worst_loss > LOSS_RTOL or \
                got["exact_zero"] > 1e-5:
            raise AssertionError(f"SegFormer training, {point} weights: card and CPU disagree")
    rel = out["start"]["model_rel_l2"]
    if rel["card-float64"] > max(GRAD_REL_L2, rel["cpu-float64"]):
        raise AssertionError("SegFormer training: the card's float32 gradient is farther from "
                             "float64 than the CPU's")
    return out


def phase_segformer(dev, flame_model, root: str, flagship_data: str, evaluation: dict) -> dict:
    """The SegFormer configuration at full width (MiT-B5 with the L heads,
    640 px, batch 8, bfloat16, the dense wire with 30 GT boxes): render its
    dataset, train it from random init through the entry point, time its
    step, hold a float32 step against the CPU, score and export the step
    with ``tools/eval_checkpoint``, serve the export through
    ``EvalPredictor``, and run the protocols on phase 9's stand-ins (its
    FDDB stand-in is the start of ``flagship_data``'s validation split;
    ``evaluation`` is phase 9's result)."""
    from head_detector_tpu_torch import profiling
    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.evaluation.evaluate_dad import DadEvaluator, DadSample
    from head_detector_tpu_torch.evaluation.evaluate_fddb import evaluate_fddb
    from head_detector_tpu_torch.evaluation.predictor import EvalPredictor
    from head_detector_tpu_torch.models import SegFormerYoloHeads, build_model
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.tools import eval_checkpoint, run_protocols
    from head_detector_tpu_torch.tools.make_fddb_standin import make_fddb_standin
    from head_detector_tpu_torch.tools.render_synthetic_dataset import render_split
    from head_detector_tpu_torch.train.__main__ import build_trainer
    from head_detector_tpu_torch.train.dataset import collate_samples
    from head_detector_tpu_torch.train.loss import Targets
    from head_detector_tpu_torch.train.trainer import images_to_device
    from head_detector_tpu_torch.weights import load_variables

    import cv2

    is_cuda = torch.device(dev).type == "cuda"
    data = os.path.join(root, "seg_data")
    dad_dir, fddb_dir = evaluation["dad_dir"], evaluation["fddb_dir"]
    out = {}
    # 1. the dataset, with the launch counts zeroed
    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    _synchronize(dev)
    t0 = time.perf_counter()
    for split, count, seed in (("train", SEG_TRAIN, 0), ("val", SEG_VAL, 1)):
        render_split(data, split, count, SEG_SIZE, seed=seed, device=dev,
                     flame_model=flame_model, log_every=0)
    _synchronize(dev)
    render_s = time.perf_counter() - t0
    want_launches = renderer_launches("train", SEG_TRAIN) + renderer_launches(
        "val", SEG_VAL, seed=1)
    render_launches = r.rasterize_zbuffer_cuda.launches
    out["scenes_per_s"] = (SEG_TRAIN + SEG_VAL) / render_s
    log(f"  rendered {SEG_TRAIN} + {SEG_VAL} scenes at {SEG_SIZE} px in {render_s:.2f} s: "
        f"{out['scenes_per_s']:.2f} scenes/s; rasterize_zbuffer launches {render_launches} "
        f"(expected {want_launches}, one a pass)")
    if render_launches != want_launches:
        raise AssertionError("the renderer did not launch the kernel once a pass")

    # 2. one epoch through the entry point, from random init
    t0 = time.perf_counter()
    trainer = build_trainer(seg_argv(data, os.path.join(root, "seg_runs"), dev))
    net = trainer.model
    cfg = trainer.cfg
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  {SEGFORMER}: {type(net).__name__} (MiT-B5 depths {net.mit.depths}, heads of "
        f"{net.arch.name}; {n_params} parameters, {net.dtype} compute) at {cfg.image_size} px, "
        f"batch {cfg.batch_size}, {cfg.max_gt_boxes} GT boxes, "
        f"{type(trainer.train_dataset).__name__}, random init, ready in "
        f"{time.perf_counter() - t0:.2f} s; cut: {SEG_TRAIN} training and {SEG_VAL} "
        f"validation scenes, one epoch of {trainer.steps_per_epoch} steps of the config's "
        f"{cfg.max_epochs}-epoch schedule")
    if not isinstance(net, SegFormerYoloHeads) or net.dtype != torch.bfloat16 or \
            (cfg.image_size, cfg.batch_size, cfg.max_gt_boxes) != (SEG_SIZE, SEG_BATCH, 30):
        raise AssertionError("the segformer trainer is not the configuration's")
    ckpt_dir = cfg.ckpt_dir
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _synchronize(dev)
    t0 = time.perf_counter()
    metrics = trainer.train()
    _synchronize(dev)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if is_cuda else 0
    steps = trainer.state.step
    losses = [_components(c) for c in trainer.step_components]
    if steps != trainer.steps_per_epoch or trainer.ckpt.latest_step() != steps or \
            not all(np.isfinite(v) for c in losses for v in c.values()):
        raise AssertionError(f"segformer training: step {steps}, losses {losses}")
    if not {"KeypointsNME", "KeypointsFailureRate", "RPYError"} <= set(metrics) or \
            not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"segformer validation metrics: {metrics}")
    timing = trainer.timings[-1]
    out.update(loader_images_per_s=timing["images"] / timing["train_s"],
               peak_memory_bytes=peak, loss_first=losses[0], loss_last=losses[-1],
               validation=metrics)
    log(f"  one epoch of {steps} steps in {train_s:.2f} s (train {timing['train_s']:.2f}, "
        f"validate {timing['validate_s']:.2f}, save {timing['save_s']:.2f}); loader-fed "
        f"{out['loader_images_per_s']:.2f} images/s; checkpoint at step "
        f"{trainer.ckpt.latest_step()}; peak memory {peak / 2**30:.3f} GiB")
    log(f"  loss at each step: {[round(c['loss'], 4) for c in losses]}")
    log(f"  validation (EMA): {metrics}")
    saved_ema = {k: v.detach().cpu().clone() for k, v in
                 {**trainer.state.ema, **trainer.state.batch_stats()}.items()}

    # 3. the step alone on device-resident batches, collated once
    ds = trainer.train_dataset
    batches = []
    for b in range(SEG_TIMED):
        images, targets = collate_samples(
            [ds[i] for i in range(b * SEG_BATCH, (b + 1) * SEG_BATCH)], cfg.max_gt_boxes)
        batches.append((torch.as_tensor(images).to(dev), Targets(*targets).to(dev)))
    step_ms = []
    for images, targets in batches:
        _synchronize(dev)
        s0 = time.perf_counter()
        trainer.step_fn(trainer.state, images, targets)
        _synchronize(dev)
        step_ms.append((time.perf_counter() - s0) * 1e3)
    steady = step_ms[1:]
    _synchronize(dev)
    s0 = time.perf_counter()
    for images, targets in batches:
        trainer.step_fn(trainer.state, images, targets)
    _synchronize(dev)
    device_ips = len(batches) * SEG_BATCH / (time.perf_counter() - s0)
    net.eval()
    with torch.no_grad():
        fwd_flops = profiling.analytic_flops(net, images_to_device(batches[0][0][:1], dev))
    step_flops = 3 * fwd_flops  # forward + backward, per image
    mfu = profiling.mfu(step_flops, device_ips, profiling.H100_BF16_PEAK_FLOPS)
    busy = None
    if is_cuda:
        try:
            images, targets = batches[0]
            busy = profile_window(f"one SegFormer train step, batch {SEG_BATCH} at {SEG_SIZE} px",
                                  lambda: trainer.step_fn(trainer.state, images, targets))
        except RuntimeError as exc:  # the profiler is a reading, not a check
            log(f"  segformer profiler: not measured ({exc})")
    out.update(step_ms_first=step_ms[0], step_ms_median=float(np.median(steady)),
               step_ms_spread=[min(steady), max(steady)], device_fed_images_per_s=device_ips,
               forward_flops_per_image=fwd_flops, step_flops_per_image=step_flops,
               mfu_bf16=mfu, device_busy_share=busy)
    log(f"  step alone (device-resident batches, synchronised): first {step_ms[0]:.2f} ms, then "
        f"median {out['step_ms_median']:.2f} ms ({min(steady):.2f}-{max(steady):.2f}) over "
        f"{len(steady)}; device-fed {device_ips:.2f} images/s ({len(batches)} steps back to "
        f"back); busy {'not measured' if busy is None else f'{100 * busy:.1f}%'}")
    log(f"  FLOPs (profiling.analytic_flops): forward {fwd_flops:.0f} an image, step 3x that "
        f"= {step_flops:.0f}; MFU against the bfloat16 data-sheet peak {mfu:.4f}")

    # 4. a float32 step at the starting point and at the trained weights,
    # card against CPU against float64
    state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    out["card_vs_cpu_step"] = seg_card_vs_cpu(dev, state, cfg.loss)

    # 5. the step scored (raw and EMA) and exported as a float32 msgpack
    t0 = time.perf_counter()
    scored = eval_checkpoint.main([
        "--ckpt-dir", ckpt_dir, "--arch", SEGFORMER, "--image-size", str(SEG_SIZE),
        "--which", "both", "--data-dir", data, "--batch-size", str(SEG_BATCH),
        "--device", str(dev)])
    export = os.path.join(root, "segformer_ema.msgpack")
    eval_checkpoint.main(["--ckpt-dir", ckpt_dir, "--arch", SEGFORMER, "--image-size",
                          str(SEG_SIZE), "--which", "ema", "--no-eval", "--export-msgpack",
                          export, "--device", str(dev)])
    out["eval_checkpoint"] = scored
    log(f"  eval_checkpoint --arch {SEGFORMER} --which both ({time.perf_counter() - t0:.2f} s "
        f"with the EMA export, {os.path.getsize(export)} bytes): raw {scored['raw']}; "
        f"EMA {scored['ema']}")
    if set(scored) != {"raw", "ema"} or not all(
            np.isfinite(v) for m in scored.values() for v in m.values()):
        raise AssertionError(f"eval_checkpoint metrics: {scored}")

    # 6. the export served by EvalPredictor, against the trainer's EMA model
    variables = load_variables(export)
    predictor = EvalPredictor(model_name=SEGFORMER, variables=variables, image_size=SEG_SIZE,
                              device=dev)
    reference = build_model(SEGFORMER, deploy=False).to(dev)
    reference.load_state_dict(saved_ema, strict=True)  # the EMA weights of the saved step
    reference.eval()
    val_images, _ = collate_samples([trainer.val_dataset[i] for i in range(SEG_BATCH)], 30)
    x = images_to_device(val_images, dev)
    with torch.no_grad(), exact_float32():
        got, _ = predictor.model(x)
        want, _ = reference(x)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"  the EMA export through load_variables and EvalPredictor('{SEGFORMER}'): "
        f"decoded outputs on a validation batch of {SEG_BATCH} bit-equal to the trainer's EMA "
        f"weights in a float32 model: {same}")
    if not same:
        raise AssertionError("EvalPredictor on the export differs from the trainer's EMA model")
    del reference, trainer, net, batches

    # 7. the protocols on phase 9's stand-ins, then the card against the CPU
    protocols = run_protocols.main([
        "--checkpoint", export, "--arch", SEGFORMER, "--image-size", str(SEG_SIZE),
        "--dad-json", os.path.join(dad_dir, "dataset.json"), "--dad-base", dad_dir,
        "--fddb-dir", fddb_dir, "--out", os.path.join(root, "seg_protocols.json"),
        "--device", str(dev)])
    with open(os.path.join(dad_dir, "dataset.json")) as f:
        samples = [DadSample.from_config(c, dad_dir) for c in json.load(f)["standin"]]
    n_fddb = evaluation["fddb_images"]
    out.update(dad=protocols["dad"], fddb=protocols["fddb"],
               dad_host_ms=protocols["seconds"]["dad"] * 1e3 / len(samples),
               fddb_host_ms=protocols["seconds"]["fddb"] * 1e3 / n_fddb)
    log(f"  run_protocols --arch {SEGFORMER} --image-size {SEG_SIZE}: DAD ({len(samples)} "
        f"samples) {protocols['dad']}, host {out['dad_host_ms']:.2f} ms/sample; FDDB ({n_fddb} "
        f"images) {protocols['fddb']}, host {out['fddb_host_ms']:.2f} ms/image")
    if not 0.0 <= protocols["fddb"]["AP"] <= 1.0:
        raise AssertionError(f"segformer protocol results: {protocols}")

    fddb_check = os.path.join(root, "seg_fddb_check")
    make_fddb_standin(flagship_data, fddb_check, "val", limit=SEG_CHECK_SAMPLES)
    kw = dict(model_name=SEGFORMER, variables=variables, image_size=SEG_SIZE,
              confidence_threshold=0.2, nms_iou_threshold=0.5, post_nms_max_predictions=30)
    probe = cv2.cvtColor(cv2.imread(samples[0].image_path), cv2.COLOR_BGR2RGB)
    sides = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        pred = EvalPredictor(device=where, **kw)
        padded, _ = pred.preprocess(probe)
        with torch.no_grad(), exact_float32():
            decoded, _ = pred.model(images_to_device(padded[None], pred.device))
        evaluator = DadEvaluator(samples[:SEG_CHECK_SAMPLES], pred)
        dad_result = evaluator()
        pred.callback = fddb_callback(pred)
        sides[str(where)] = {"raw": [t.cpu() for t in decoded], "dad": dad_result,
                             "per_sample": _per_sample(evaluator),
                             "fddb": evaluate_fddb(fddb_check, pred),
                             "seconds": time.perf_counter() - t0}
        del pred
    card, cpu = sides[str(dev)], sides["cpu"]
    raw_worst = max(_largest_rel(g, w) for g, w in zip(card["raw"], cpu["raw"]))
    worst = {"nme_2d": 0.0, "chamfer": 0.0, "rot_error": 0.0, "angle_error": 0.0, "z_n": 0.0}
    if [g["index"] for g in card["per_sample"]] != [w["index"] for w in cpu["per_sample"]]:
        raise AssertionError("SegFormer: card and CPU select different heads")
    for g, w in zip(card["per_sample"], cpu["per_sample"]):
        for k in ("nme_2d", "chamfer"):
            worst[k] = max(worst[k], abs(g[k] - w[k]) / abs(w[k]))
        for k in ("rot_error", "angle_error", "z_n"):
            worst[k] = max(worst[k], abs(g[k] - w[k]))
    ap_diff = abs(card["fddb"]["AP"] - cpu["fddb"]["AP"])
    bars = {"nme_2d": 1e-3, "chamfer": 1e-3, "rot_error": 1e-4, "angle_error": 1e-2, "z_n": 1e-2}
    out.update(protocol_card_vs_cpu=worst, raw_card_vs_cpu=raw_worst,
               fddb_ap_card_vs_cpu=ap_diff, dad_heads_selected=len(card["per_sample"]))
    log(f"  card against CPU (float32, TF32 off; CPU {cpu['seconds']:.2f} s, card "
        f"{card['seconds']:.2f} s): the predictor's decoded outputs on a DAD sample, largest "
        f"difference {raw_worst:.3e} of each output's scale (bar {SEG_RAW_FRAC:g}); "
        f"{len(card['per_sample'])} of {SEG_CHECK_SAMPLES} DAD samples with a head above conf "
        f"0.2 on both, the same heads; largest differences "
        + ", ".join(f"{k} {v:.3e} (bar {bars[k]:g})" for k, v in worst.items())
        + f"; FDDB AP of {SEG_CHECK_SAMPLES} images {card['fddb']['AP']:.6f} against "
        f"{cpu['fddb']['AP']:.6f}, |d| {ap_diff:.3e} (bar 1e-3)")
    if raw_worst > SEG_RAW_FRAC or any(worst[k] > bars[k] for k in bars) or ap_diff > 1e-3:
        raise AssertionError("the SegFormer protocols on the card disagree with the CPU")
    out["launches"] = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                       "pncc_render": r.pncc_render_cuda.launches}
    log(f"  launches on the segformer path: {out['launches']}")
    return out


def dp_argv(root: str, name: str, float32: bool, train: int, epochs: int = 1,
            extra=()) -> list:
    """The entry point's flags for phase 14: yolo_heads_m with rendered
    scenes, warm-started from the shipped checkpoint, global batch DP_BATCH
    at DP_SIZE px, checkpoints under ``root/name``."""
    return ["--config-name", MODEL, "--device", "cuda", "dataset_params.render=true",
            f"pretrained_weights={CHECKPOINT}", f"dataset_params.image_size={DP_SIZE}",
            f"dataset_params.batch_size={DP_BATCH}", f"dataset_params.train_length={train}",
            f"dataset_params.val_length={DP_VAL}", f"training_hyperparams.max_epochs={epochs}",
            f"training_hyperparams.mixed_precision={'false' if float32 else 'true'}",
            f"ckpt_root_dir={root}", f"experiment_name={name}", "log_every=1000", *extra]


def dp_resume_runs(root: str) -> dict:
    """Phase 14 (c)'s float32 runs: two epochs of one step uninterrupted,
    and the same two epochs as a cut run and a resumed one."""
    return {"uninterrupted": dp_argv(root, "f32_two", True, DP_BATCH, epochs=2),
            "cut": dp_argv(root, "cut", True, DP_BATCH, epochs=2,
                           extra=["training_hyperparams.epochs_per_run=1"]),
            "resumed": dp_argv(root, "cut", True, DP_BATCH, epochs=2,
                               extra=["training_hyperparams.resume=true"])}


def plain_run(argv: list, dev, timed: int = 0) -> dict:
    """Today's one-card trainer on ``argv``: its summary as a rank's."""
    from head_detector_tpu_torch.train.__main__ import build_trainer, state_digest, time_steps

    trainer = build_trainer(argv, device=dev)
    trainer.train()
    _synchronize(dev)
    out = {"components": [_components(c) for c in trainer.step_components],
           "digest": state_digest(trainer.state), "trainer": trainer,
           "state": {"batch_stats": {k: v.detach().cpu() for k, v in
                                     trainer.state.batch_stats().items()},
                     "grads": {n: p.grad.detach().cpu() for n, p in
                               trainer.model.named_parameters() if p.grad is not None}}}
    if timed:
        out["step_ms"] = time_steps(trainer, timed)
    return out


def _rel_l2(got: dict, want: dict) -> float:
    """Relative L2 distance of two trees of tensors, over all their entries."""
    num = sum(float(torch.sum((got[k].double() - w.double()) ** 2)) for k, w in want.items())
    den = sum(float(torch.sum(w.double() ** 2)) for w in want.values())
    return (num / den) ** 0.5


def _stats_worst(got: dict, want: dict) -> float:
    """Largest |d| of the running statistics, over each tensor's largest magnitude."""
    return max(float((got[k] - w).abs().max() / w.abs().max().clamp(min=1e-12))
               for k, w in want.items() if "running" in k)


def phase_data_parallel(dev, flame_model) -> dict:
    """Data parallelism on one card: the dry run, the slice's path at full
    width (two gloo ranks sharing the card, one NCCL rank, today's trainer),
    checkpoint and resume, validation, and streaming replicas."""
    from head_detector_tpu_torch.multichip import dryrun_multichip
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.pipeline import StreamingDetector
    from head_detector_tpu_torch.train.__main__ import run_data_parallel
    from head_detector_tpu_torch.train.checkpoint import CheckpointManager
    from head_detector_tpu_torch.train.dataset import render_scene

    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, backend="gloo", device=dev, timeout_s=DP_TIMEOUT)
    log(f"  (a) dryrun_multichip(2, gloo, both ranks on {dev}): |d| {dry['abs_diff']:.3e} "
        f"(loss {dry['loss']:.6f}, 1-rank {dry['ref_loss']:.6f}); {dry['identical']} tensors "
        f"bit-identical; {time.perf_counter() - t0:.1f} s")

    out = {"dryrun": {k: dry[k] for k in ("loss", "ref_loss", "abs_diff", "identical")}}
    with tempfile.TemporaryDirectory() as root:
        # float32: two epochs of one step (the first step's components, the
        # last step's gradient and statistics); bfloat16: one step, then
        # DP_TIMED steps timed alone
        f32 = lambda name: dp_argv(root, name, True, DP_BATCH, epochs=2)  # noqa: E731
        bf16 = lambda name: dp_argv(root, name, False, DP_BATCH)  # noqa: E731
        resume_runs = dp_resume_runs(root)
        t0 = time.perf_counter()
        two = run_data_parallel(
            [(resume_runs["uninterrupted"], {"return_state": True, "validate": True}),
             (bf16("bf16_two"), {"timed_steps": DP_TIMED}), resume_runs["cut"],
             (resume_runs["resumed"], {"return_state": True})], 2, [dev, dev], "gloo",
            timeout_s=DP_TIMEOUT)
        t1 = time.perf_counter()
        one = run_data_parallel(
            [(f32("f32_one"), {"return_state": True}), (bf16("bf16_one"), {"timed_steps": DP_TIMED})],
            1, [dev], "nccl", timeout_s=DP_TIMEOUT)
        t2 = time.perf_counter()
        plain = plain_run(f32("f32_plain"), dev)
        plain_bf16 = plain_run(bf16("bf16_plain"), dev, timed=DP_TIMED)
        t3 = time.perf_counter()
        log(f"  (b) {MODEL} at {DP_SIZE} px, global batch {DP_BATCH}, rendered scenes: two gloo "
            f"ranks on {dev} {t1 - t0:.1f} s (4 runs), one NCCL rank {t2 - t1:.1f} s (2 runs), "
            f"today's trainer {t3 - t2:.1f} s (2 runs)")

        want = plain["components"][0]
        for label, got in (("two gloo ranks", two[0][0]), ("one NCCL rank", one[0][0])):
            comps = got["components"][0]
            worst = max(abs(comps[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want
                        if k.startswith("loss"))
            grad = _rel_l2(got["state"]["grads"], plain["state"]["grads"])
            stats = _stats_worst(got["state"]["batch_stats"], plain["state"]["batch_stats"])
            log(f"  float32, {label} vs today's trainer: first step's loss {comps['loss']:.6f} "
                f"(today {want['loss']:.6f}), num_pos {comps['num_pos']:.0f} "
                f"({want['num_pos']:.0f}), worst loss component relative {worst:.3e}; the "
                f"second step's model gradient relative L2 {grad:.3e}, BatchNorm statistics "
                f"after it worst relative {stats:.3e}")
            out[f"float32_{'two' if 'two' in label else 'one'}"] = {
                "loss_rel": worst, "grad_rel_l2": grad, "stats_rel": stats}
            if comps["num_pos"] != want["num_pos"] or worst > LOSS_RTOL or \
                    grad > GRAD_REL_L2 or stats > DP_STATS_RTOL:
                raise AssertionError(f"data parallel: {label} strays from the one-card step")
        for i, label in enumerate(("float32 steps", "bfloat16 steps", "cut", "resumed")):
            if two[0][i]["digest"] != two[1][i]["digest"]:
                raise AssertionError(f"data parallel: the ranks' replicas differ after {label}")
        log("  parameters, EMA and BatchNorm statistics bit-identical across the two ranks "
            "after each of the 4 runs (sha256 of every tensor)")
        ms = {"two_gloo": two[0][1]["step_ms"], "one_nccl": one[0][1]["step_ms"],
              "plain": plain_bf16["step_ms"]}
        out["bf16_step_ms"] = {k: float(np.median(v[1:])) for k, v in ms.items()}
        out["bf16_step_ms_all"] = ms
        log(f"  bfloat16 step alone (device-resident rows, synchronised), median of the last "
            f"{DP_TIMED - 1}: {out['bf16_step_ms']}; every reading {ms}")
        bf16_loss = {"two_gloo": two[0][1]["components"][-1]["loss"],
                     "one_nccl": one[0][1]["components"][-1]["loss"],
                     "plain": plain_bf16["components"][-1]["loss"]}
        log(f"  bfloat16 loss at the trained step: {bf16_loss}")
        if not all(np.isfinite(v) for v in bf16_loss.values()):
            raise AssertionError("data parallel: non-finite bfloat16 loss")
        if torch.cuda.device_count() >= 2:
            nccl = run_data_parallel([(f32("f32_nccl"), {"return_state": True})], 2,
                                     ["cuda:0", "cuda:1"], "nccl", timeout_s=DP_TIMEOUT)
            grad = _rel_l2(nccl[0][0]["state"]["grads"], plain["state"]["grads"])
            log(f"  two NCCL ranks on two cards: loss {nccl[0][0]['components'][0]['loss']:.6f}, "
                f"gradient relative L2 {grad:.3e}")
            if grad > GRAD_REL_L2 or nccl[0][0]["digest"] != nccl[1][0]["digest"]:
                raise AssertionError("data parallel: NCCL over two cards strays")
        else:
            log("  two NCCL ranks on two cards: skipped, this machine has one card")

        # (c) one checkpoint writer; resume; validation
        manager = CheckpointManager(os.path.join(root, "cut"))
        lines = len(manager.metrics_history())
        w, c = two[0][0], two[0][3]
        params_rel = _rel_l2(c["state"]["params"], w["state"]["params"])
        log(f"  (c) cut after one epoch and resumed under two ranks: steps on disk "
            f"{manager.all_steps()}, {lines} history lines (one an epoch: rank 0 alone "
            f"writes); resumed at step {c['step']} (uninterrupted {w['step']}), parameters "
            f"relative L2 {params_rel:.3e}, bit-equal {c['digest'] == w['digest']}")
        if manager.all_steps() != [1, 2] or lines != 2 or c["step"] != w["step"] or \
                params_rel > DP_RESUME_REL:
            raise AssertionError("data parallel: resume differs from the uninterrupted run")
        trainer = plain["trainer"]
        state = w["state"]
        trainer.model.load_state_dict({**state["params"], **state["batch_stats"]}, strict=True)
        trainer.state.ema = {k: v.to(dev) for k, v in state["ema_params"].items()}
        val_one = trainer.validate()
        val_rel = max(abs(w["validation"][k] - v) / max(abs(v), 1e-12)
                      for k, v in val_one.items())
        log(f"  validate() under two ranks vs one, at the same weights: worst relative "
            f"{val_rel:.3e} ({w['validation']})")
        if w["validation"].keys() != val_one.keys() or val_rel > DP_VAL_RTOL:
            raise AssertionError("data parallel: validation under two ranks differs")
        out.update(resume_params_rel_l2=params_rel, resume_bit_equal=c["digest"] == w["digest"],
                   validation_rel=val_rel)

    # (d) streaming replicas
    kw = dict(model_name=MODEL, checkpoint=CHECKPOINT, image_size=STREAM_SIZE,
              batch_size=STREAM_BATCH, dtype=torch.bfloat16, verts_dtype=torch.bfloat16,
              mesh_subset="head", decode_budget=256)
    scenes = [render_scene(SCENE_SEED, i, STREAM_SIZE, MAX_HEADS, device=dev,
                           flame_model=flame_model) for i in range(STREAM_BATCH)]
    single = StreamingDetector(device=dev, **kw)
    pair = StreamingDetector(devices=[dev, dev], **kw)
    want = list(single.run(scenes))
    got = list(pair.run(scenes))
    score = max(float(np.abs(g["scores"] - o["scores"]).max()) for g, o in zip(got, want))
    box = max(float(np.abs(g["boxes_xyxy"] - o["boxes_xyxy"]).max()) for g, o in zip(got, want))
    valid = all(np.array_equal(g["valid"], o["valid"]) for g, o in zip(got, want))
    slots = all(sorted(g["vertices"]) == sorted(o["vertices"]) for g, o in zip(got, want))
    vert_ok = slots and all(torch.allclose(v.float(), o["vertices"][k].float(), atol=0.05,
                                           rtol=1e-2)
                            for g, o in zip(got, want) for k, v in g["vertices"].items())
    meshes = sum(len(g["vertices"]) for g in got)
    log(f"  (d) StreamingDetector(devices=[{dev}, {dev}]) vs [{dev}], {STREAM_BATCH} scenes at "
        f"{STREAM_SIZE} px, bfloat16: {len(pair.replicas)} replicas of {pair.rows} rows; "
        f"valid equal {valid}, score |d| {score:.3e}, box |d| {box:.3e} px, {meshes} meshes "
        f"on the same slots {slots}, within 0.05 + 1e-2 relative {vert_ok}")
    if not (valid and vert_ok) or score > 1e-5 or box > 1e-3 or len(got) != len(scenes):
        raise AssertionError("data parallel: streaming replicas differ from one device")
    out.update(stream_score_abs=score, stream_box_abs=box)

    launches = {name: sum(run["launches"][name] for rank in two + one for run in rank)
                for name in ("rasterize_zbuffer", "pncc_render")}
    launches["rasterize_zbuffer"] += r.rasterize_zbuffer_cuda.launches
    launches["pncc_render"] += r.pncc_render_cuda.launches
    out["launches"] = launches
    log(f"  launches on the data-parallel path (the ranks' renderers, today's trainer's and "
        f"the streamed scenes): {launches}")
    return out


def native_objs(results, root: str) -> dict:
    """``MeshSaver`` on phase 3's heads: the native writer against the
    Python one, byte for byte, in ms an image."""
    import filecmp

    from head_detector_tpu_torch.detection_result import MeshSaver

    saver = MeshSaver()
    if saver._native is None:
        raise AssertionError("MeshSaver did not take the native writer")
    ms = {"native": 0.0, "python": 0.0}
    files = 0
    for i, res in enumerate(results):
        verts = np.stack([h.vertices_3d for h in res.heads]) if res.heads else np.zeros((0,))
        paths = {k: [os.path.join(root, f"obj_{k}", f"{i}_{j}.obj") for j in range(len(res.heads))]
                 for k in ms}
        for kind, write in (("native", saver.save_many), ("python", saver.save_many_python)):
            os.makedirs(os.path.join(root, f"obj_{kind}"), exist_ok=True)
            t0 = time.perf_counter()
            write(verts, paths[kind])
            ms[kind] += (time.perf_counter() - t0) * 1e3 / len(results)
        for a, b in zip(paths["native"], paths["python"]):
            if not filecmp.cmp(a, b, shallow=False):
                raise AssertionError(f"native OBJ {a} differs from the Python writer's")
            files += 1
    if not files:
        raise AssertionError("phase 3 gave no heads to write")
    log(f"  OBJ: {files} files of phase 3's heads byte-equal through both writers; native "
        f"{ms['native']:.3f} ms/img, Python {ms['python']:.3f} ms/img")
    return {"obj_files": files, "obj_native_ms_per_img": ms["native"],
            "obj_python_ms_per_img": ms["python"]}


def native_letterbox(flame_model) -> dict:
    """``StreamingDetector``'s host letterbox through cv2 and through the
    native library (``HDT_LETTERBOX=native``) on phase 6's scenes: at the
    stream's 1024 px (its own call, scale 1) and at 640 px."""
    from head_detector_tpu_torch.pipeline import StreamingDetector
    from head_detector_tpu_torch.train.dataset import render_scene

    scenes = [render_scene(SCENE_SEED, i, STREAM_SIZE, MAX_HEADS, device=flame_model.device,
                           flame_model=flame_model) for i in range(LETTERBOX_SCENES)]
    out = {}
    for size in (STREAM_SIZE, IMAGE_SIZE):
        stub = type("Stub", (), {"image_size": size})()
        got = {}
        for kind in ("cv2", "native"):
            os.environ.pop("HDT_LETTERBOX", None)
            if kind == "native":
                os.environ["HDT_LETTERBOX"] = "native"
            StreamingDetector._letterbox_host(stub, scenes[0])
            t0 = time.perf_counter()
            got[kind] = [StreamingDetector._letterbox_host(stub, s) for s in scenes]
            out[f"{kind}_ms_per_img_{size}"] = (time.perf_counter() - t0) * 1e3 / len(scenes)
        os.environ.pop("HDT_LETTERBOX", None)
        worst = max(int(np.abs(a[0].astype(int) - b[0].astype(int)).max())
                    for a, b in zip(got["cv2"], got["native"]))
        if any(a[1] != b[1] for a, b in zip(got["cv2"], got["native"])):
            raise AssertionError(f"letterbox scales differ at {size} px")
        bar = 0 if size == STREAM_SIZE else LETTERBOX_COUNTS
        if worst > bar:
            raise AssertionError(f"native letterbox at {size} px is {worst} counts from cv2")
        out[f"max_counts_{size}"] = worst
        log(f"  letterbox of {len(scenes)} scenes ({STREAM_SIZE} px) to {size} px: native "
            f"{'equal to' if worst == 0 else f'within {worst} counts of'} cv2; cv2 "
            f"{out[f'cv2_ms_per_img_{size}']:.3f} ms/img, native "
            f"{out[f'native_ms_per_img_{size}']:.3f} ms/img")
    return out


def native_raster(flame_model, kernel_device_ms: float) -> dict:
    """``rasterize_zbuffer_native`` (host) against the CUDA kernel on the
    main path's fullest scene, a head at a time: hit agreement and |color| at
    the kernel's bar, sliver triangles' pixels exempt from the color bound
    (float32 rounding over sin^2 of a tiny corner angle: the native code
    contracts to FMAs, the kernel does not; tests/test_torch_native.py)."""
    from head_detector_tpu_torch import native
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.train.dataset import scene_params, scene_tables, scene_vertices

    dev = flame_model.device
    tris, colors = scene_tables(dev)
    scenes = [scene_vertices(scene_params(SCENE_SEED, i, IMAGE_SIZE, MAX_HEADS)[0], flame_model)
              for i in range(BATCH)]
    fullest = max(scenes, key=lambda v: v.shape[0])
    canvas, hit = r.rasterize_zbuffer_cuda(fullest, tris, colors, IMAGE_SIZE, IMAGE_SIZE)
    torch.cuda.synchronize()
    v_host, t_host, c_host = fullest.cpu().numpy(), tris.cpu().numpy(), colors.cpu().numpy()
    p = v_host[:, t_host, :2].astype(np.float64)  # [n, F, 3, 2]
    e0, e1 = p[..., 2, :] - p[..., 0, :], p[..., 1, :] - p[..., 0, :]
    d00, d11, d01 = (e0 * e0).sum(-1), (e1 * e1).sum(-1), (e0 * e1).sum(-1)
    sliver = (d00 * d11 - d01 * d01) < 1e-3 * d00 * d11
    agree, err, exempt_share, sliver_err = 1.0, 0.0, 0.0, 0.0
    for i in range(v_host.shape[0]):
        cn, hn = native.rasterize_zbuffer_native(v_host[i], t_host, c_host, IMAGE_SIZE, IMAGE_SIZE)
        ck, hk = canvas[i].cpu().numpy(), hit[i].cpu().numpy()
        _, exempt = r.rasterize_zbuffer_plain(fullest[i:i + 1].cpu(),
                                              tris[torch.as_tensor(sliver[i], device=dev)].cpu(),
                                              colors.cpu(), IMAGE_SIZE, IMAGE_SIZE)
        exempt = exempt[0].numpy()
        both = hn & hk
        agree = min(agree, float((hn == hk).mean()))
        d = np.abs(cn - ck).max(-1)
        err = max(err, float(d[both & ~exempt].max()) if (both & ~exempt).any() else 0.0)
        sliver_err = max(sliver_err, float(d[both & exempt].max()) if (both & exempt).any()
                         else 0.0)
        exempt_share = max(exempt_share, float(exempt[hk].mean()) if hk.any() else 0.0)
    if agree < HIT_AGREEMENT or err >= COLOR_TOL or exempt_share > 0.01:
        raise AssertionError(f"native rasterizer against the kernel: hit agreement {agree}, "
                             f"|color| {err}, sliver share {exempt_share}")
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(v_host.shape[0]):
            native.rasterize_zbuffer_native(v_host[i], t_host, c_host, IMAGE_SIZE, IMAGE_SIZE)
        reps.append((time.perf_counter() - t0) * 1e3)
    host_ms = float(np.median(reps))
    log(f"  rasterize_zbuffer_native against the kernel on the fullest scene "
        f"({v_host.shape[0]} heads, F={t_host.shape[0]}, {IMAGE_SIZE}x{IMAGE_SIZE}): hit "
        f"agreement {agree:.6f}, max |dcolor| {err:.3g} off slivers ({sliver_err:.3g} on "
        f"{100 * exempt_share:.3f}% of hit pixels under sliver triangles); host "
        f"{host_ms:.3f} ms (median of 3) against the kernel's device_ms "
        f"{kernel_device_ms:.4f}")
    return {"raster_hit_agreement": agree, "raster_max_color": err,
            "raster_sliver_color": sliver_err, "raster_sliver_share": exempt_share,
            "raster_native_host_ms": host_ms, "raster_kernel_device_ms": kernel_device_ms}


def phase_last_modules(dev, flame_model, root: str, results, evaluation: dict,
                       kernel_device_ms: float) -> dict:
    """Phase 15: the native host library, the competitor protocol, the
    parity runner and the campaign tools, on the card's machine."""
    import contextlib
    import io

    from head_detector_tpu_torch import native
    from head_detector_tpu_torch.detector import HeadDetector
    from head_detector_tpu_torch.evaluation.evaluate_competitors import evaluate_external_detector
    from head_detector_tpu_torch.evaluation.evaluate_fddb import read_fddb_annotations
    from head_detector_tpu_torch.ops import rasterize as r
    from head_detector_tpu_torch.tools import (
        archive_campaign,
        finish_campaign,
        run_campaign,
        verify_reference_parity,
    )

    out = {}
    if not native.available():  # built at its first use (MeshSaver, phase 3)
        raise AssertionError(f"the native host library did not build: {native.build_error()}")
    log(f"  (a) native library {os.path.relpath(native.library_path(), ROOT)} for host "
        f"{native.host_key()!r}")
    out.update(native_objs(results, root))
    out.update(native_letterbox(flame_model))
    out.update(native_raster(flame_model, kernel_device_ms))

    fddb = evaluation["fddb_dir"]
    truth = read_fddb_annotations(fddb)
    answers = {}
    for name, boxes in truth.items():
        image = cv2_rgb(os.path.join(fddb, "images", name))
        answers[image.tobytes()] = np.asarray(boxes, np.float64).reshape(-1, 4)
    perfect = evaluate_external_detector(
        fddb, lambda image: (answers[image.tobytes()], np.full(len(answers[image.tobytes()]), 0.9)))
    if abs(perfect["AP"] - 1.0) > 1e-6 or abs(perfect["AP50"] - 1.0) > 1e-6:
        raise AssertionError(f"a perfect mock detector scored {perfect}")
    det = HeadDetector(model=MODEL, image_size=EVAL_SIZE, checkpoint=CHECKPOINT, device=dev)

    def head_detector(image):
        heads = det(image, confidence_threshold=0.5).heads
        boxes = np.array([[h.bbox.x, h.bbox.y, h.bbox.x + h.bbox.w, h.bbox.y + h.bbox.h]
                          for h in heads], np.float64).reshape(-1, 4)
        return boxes, np.array([h.score for h in heads], np.float64)

    t0 = time.perf_counter()
    ours = evaluate_external_detector(fddb, head_detector)
    fddb_s = time.perf_counter() - t0
    del det
    log(f"  (b) competitor protocol on phase 9's FDDB stand-in ({len(truth)} images): a "
        f"perfect mock scores AP {perfect['AP']:.6f}; HeadDetector ({MODEL}, {EVAL_SIZE} px) "
        f"as a competitor AP {ours['AP']:.4f}, AP50 {ours['AP50']:.4f} in {fddb_s:.2f} s")
    out.update(competitor_perfect_ap=perfect["AP"], competitor_head_detector=ours)

    t0 = time.perf_counter()
    parity = verify_reference_parity.self_test(MODEL, IMAGE_SIZE, PARITY_IMAGES, device=dev,
                                               work_dir=root, print_fn=lambda *a: None)
    parity_s = time.perf_counter() - t0
    for name, rep in (("pth_against_trcd", parity["pth_against_trcd"]),
                      ("trcd", parity["trcd"])):
        stages = ", ".join(f"{k} {v:.3g}" for k, v in rep["stage_diffs"].items())
        log(f"  (c) parity self-test {name} ({rep['layout']} layout, the .trcd on the card): "
            f"stages (relative) {stages}; min IoU {rep['min_bbox_iou']:.6f}, max vertex L2 "
            f"{rep['max_vertex_l2']:.3g}, flame |d| {rep['max_flame_diff']:.3g}: "
            f"{'PASS' if rep['pass'] else 'FAIL'}")
    if not parity["pass"]:
        raise AssertionError("the parity self-test failed")
    log(f"  (c) parity self-test at {MODEL}, {IMAGE_SIZE} px, {PARITY_IMAGES} images: "
        f"{parity_s:.1f} s")
    out["parity"] = {k: {m: v[m] for m in ("stage_diffs", "min_bbox_iou", "max_vertex_l2")}
                     for k, v in parity.items() if k != "pass"}

    data, logs = os.path.join(root, "campaign_data"), os.path.join(root, "campaign_logs")
    r.rasterize_zbuffer_cuda.launches = 0
    r.pncc_render_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = run_campaign.run_campaign(
        FLAGSHIP, logs, data_dir=data, train_count=CAMPAIGN_TRAIN, val_count=CAMPAIGN_VAL,
        device=str(dev), print_fn=lambda m: log("  " + m),
        overrides=[f"ckpt_root_dir={os.path.join(root, 'campaign_ckpt')}",
                   "experiment_name=campaign", f"pretrained_weights={CHECKPOINT}",
                   "training_hyperparams.max_epochs=2", "training_hyperparams.epochs_per_run=1"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"rasterize_zbuffer": r.rasterize_zbuffer_cuda.launches,
                "pncc_render": r.pncc_render_cuda.launches}
    with open(os.path.join(logs, "chunk_1.log")) as f:
        resumed = "resumed from step" in f.read()
    if run["stopped"] != "complete" or [c["epochs"] for c in run["chunks"]] != [[0], [1]] \
            or not resumed or any(c["rc"] for c in run["chunks"]):
        raise AssertionError(f"run_campaign: {run}")
    t0 = time.perf_counter()
    fin = finish_campaign.finish_campaign(run["ckpt_dir"], data, MODEL, FLAGSHIP_SIZE,
                                          os.path.join(root, "finish"), CAMPAIGN_AVERAGE,
                                          device=str(dev))
    finish_s = time.perf_counter() - t0
    chunk_logs = sorted(os.path.join(logs, f) for f in os.listdir(logs))
    target = archive_campaign.archive_campaign(
        run["ckpt_dir"], "campaign_smoke", os.path.join(root, "campaigns"),
        chunk_logs + [os.path.join(root, "finish", f) for f in os.listdir(
            os.path.join(root, "finish")) if f.endswith(".log")], print_fn=lambda *a: None)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import campaign_report

    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        campaign_report.main(sorted(os.path.join(target, f) for f in os.listdir(target)
                                    if f.startswith("chunk_")))
    table = report.getvalue().splitlines()
    if not table or table[0] != "| Epoch | 0 | 1 |":
        raise AssertionError(f"campaign_report on the archive: {table}")
    render = run["rendered"]
    scenes_s = sum(v["scenes"] for v in render.values()) / sum(v["seconds"]
                                                               for v in render.values())
    log(f"  (d) run_campaign: rendered {CAMPAIGN_TRAIN} + {CAMPAIGN_VAL} scenes at "
        f"{FLAGSHIP_SIZE} px ({scenes_s:.2f} scenes/s), chunks "
        + ", ".join(f"{c['chunk']}: {c['seconds']:.1f} s (epochs {c['epochs']})"
                    for c in run["chunks"])
        + f", {run_s:.1f} s in all; launches {launches}")
    log(f"  (d) finish: best step {fin['best_step']} KeypointsNME "
        f"{fin['best']['KeypointsNME']:.4f}, average of the best {CAMPAIGN_AVERAGE} "
        f"{fin['average']['KeypointsNME']:.4f}, both exported, {finish_s:.1f} s; archive "
        f"{sorted(os.listdir(target))}; campaign_report: {' '.join(table[2:3])}")
    if launches["rasterize_zbuffer"] <= 0:
        raise AssertionError("the campaign path launched no rasterizer kernel")
    out.update(launches=launches, campaign_s=run_s, finish_s=finish_s,
               campaign_chunks=run["chunks"], campaign_best=fin["best"],
               campaign_average=fin["average"], scenes_per_s=scenes_s)
    return out


def cv2_rgb(path: str) -> np.ndarray:
    import cv2

    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def fddb_callback(predictor):
    """The FDDB pass's post-prediction settings, as ``run_protocols`` swaps them in."""
    from head_detector_tpu_torch.post_prediction import YoloHeadsPostPredictionCallback

    return YoloHeadsPostPredictionCallback(
        flame_model=predictor.flame, confidence_threshold=0.5, nms_iou_threshold=0.5,
        pre_nms_max_predictions=1000, post_nms_max_predictions=500)


def flatten_tree(tree, prefix=""):
    """{"/a/b": leaf} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def phase_dp_resume(dev, switches: str) -> dict:
    """Phase 14 (c)'s cut and resumed two-rank run under the deterministic
    switches ``card_probes.SWITCHES[switches]`` (phase 16 (b)), held to
    phase 14's bars."""
    from head_detector_tpu_torch.tools import card_probes

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        dp = card_probes.dp_resume(str(dev), dp_resume_runs(root), switches)
    log(f"  (b) phase 14 (c) with the switches {switches!r} "
        f"{card_probes.SWITCHES[switches]}: resumed vs uninterrupted parameters relative L2 "
        f"{dp['params_rel_l2']:.3e}, digests equal {dp['digests_equal']}, replicas equal "
        f"{dp['replicas_equal']}, ops that warned {dp['warned']}; convolution kernels only in "
        f"the uninterrupted run {dp['kernels_only_uninterrupted']}, only in the cut or resumed "
        f"ones {dp['kernels_only_cut_or_resumed']}, on rank 0 not 1 "
        f"{dp['kernels_rank0_not_rank1']}, on rank 1 not 0 {dp['kernels_rank1_not_rank0']}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not dp["replicas_equal"] or dp["steps"][0] != dp["steps"][1] or \
            dp["params_rel_l2"] > DP_RESUME_REL:
        raise AssertionError(f"phase 16: the two-rank resume strays under {switches!r}")
    return dp


def phase_faults(dev, flagship: dict) -> dict:
    """Probes of the port's faults (``tools/card_probes.py``): (a) the
    validated EMA model of phase 8's flagship state, four ways; (b) phase 14
    (c)'s cut and resumed two-rank run under the deterministic flags; (c)
    the jaw tower's train-mode BatchNorm variances on the card, the CPU and
    in float64; (d) the flagship's steps on the card and the CPU; (e) the
    model gradient at the shipped checkpoint against JAX's float32 error, and
    the worst BatchNorm alone."""
    from head_detector_tpu_torch.tools import card_probes, grad_precision

    out = {}
    t0 = time.perf_counter()
    val = card_probes.main([
        "validation", "--ckpt-dir", flagship["ckpt_dir"], "--data-dir", flagship["data_dir"],
        "--step", "latest", "--image-size", str(FLAGSHIP_SIZE), "--calib-images",
        str(FLAGSHIP_VAL), "--cpu-images", str(FAULTS_CPU_IMAGES), "--device", str(dev)])
    rows = {k: val[k]["protocol"] for k in ("i_ema_live_stats", "ii_live_live_stats",
                                             "iii_ema_recalibrated", "iv_cpu")}
    for key, row in rows.items():
        log(f"  (a) {key}: accuracy {row['accuracy']}, TP {row['tp']} FP {row['fp']} FN "
            f"{row['fn']}, raw NME {row['raw_nme']}, folded NME {row['folded_nme']}, folded "
            f"FR {row['folded_fr']}")
    gap = val["iv_cpu"]["max_score_gap"]
    log(f"  (a) step {val['step']}: EMA to live relative L2 {val['ema_to_live']:.4e}; (i) on "
        f"the card on the CPU's {val['iv_cpu']['images']} images "
        f"{json.dumps(val['iv_cpu']['card_same_images'], default=float)}; card vs CPU score "
        f"|d| {gap:.3e} (bar {FAULTS_SCORE_GAP:g}); recorded "
        f"{json.dumps(val['recorded'], default=float)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not np.isfinite(val["ema_to_live"]) or gap > FAULTS_SCORE_GAP or \
            val["i_ema_live_stats"]["images"] != FLAGSHIP_VAL or \
            val["iv_cpu"]["images"] != FAULTS_CPU_IMAGES:
        raise AssertionError("phase 16: the validation probe failed")
    out["validation"] = {"step": val["step"], "ema_to_live": val["ema_to_live"],
                         "score_gap": gap, **rows}

    dp = phase_dp_resume(dev, "all")
    if not dp["digests_equal"]:
        raise AssertionError("phase 16: the two-rank resume under the deterministic switches "
                             "is not bit-equal to the uninterrupted run")
    out["dp_resume"] = {k: dp[k] for k in ("params_rel_l2", "digests_equal", "replicas_equal",
                                            "warned")}

    t0 = time.perf_counter()
    weights, images, targets, loss_cfg = grad_precision.prepare(
        SEGFORMER, FAULTS_JAW_SIZE, 8, card_probes.LR, card_probes.MAX_STEPS, dev)
    jaw = card_probes.jaw_tower(SEGFORMER, weights, images, targets, loss_cfg, dev)
    least = min(jaw.items(), key=lambda kv: kv[1]["min_var_over_eps"])
    for name, row in jaw.items():
        log(f"  (c) {name}: float64 channel {row['channel']} of least variance "
            f"{row['min_var']:.4e} ({row['min_var_over_eps']:.3e} x eps {row['eps']:g}); card "
            f"{row['card']['min_var']:.4e} (relative error {row['card']['rel_err_at_min']:.3e}, "
            f"over the channels {row['card']['rel_l2']:.3e}), CPU {row['cpu']['min_var']:.4e} "
            f"({row['cpu']['rel_err_at_min']:.3e}, {row['cpu']['rel_l2']:.3e})")
    log(f"  (c) the jaw tower's least variance: {least[0]} {least[1]['min_var']:.4e} = "
        f"{least[1]['min_var_over_eps']:.3e} x eps; {time.perf_counter() - t0:.1f} s")
    if not all(np.isfinite(r["card"]["min_var"]) and np.isfinite(r["cpu"]["min_var"])
               for r in jaw.values()):
        raise AssertionError("phase 16: non-finite jaw-tower statistics")
    out["jaw_tower_least"] = {"bn": least[0], **least[1]}

    t0 = time.perf_counter()
    steps = card_probes.step_runs(dev, MODEL, FAULTS_STEPS_SIZE, FAULTS_BF16_STEPS,
                                  FAULTS_F32_STEPS)
    first = steps["float32"][0]["components"]
    for c in (c for c in first["cpu64"] if c.startswith("loss")):
        want = first["cpu64"][c]
        card, cpu = abs(first["card"][c] - want), abs(first["cpu"][c] - want)
        if not card <= card_probes.LAYER_RATIO * cpu + FAULTS_STEP_FLOOR * abs(want):
            raise AssertionError(f"phase 16: {c} of the flagship's first float32 step on the "
                                 f"card {first['card'][c]} against float64 {want} (CPU "
                                 f"{first['cpu'][c]})")
    rows = steps["bfloat16"] + steps["float32"]
    if not all(np.isfinite(v) for r in rows for cmp in r["components"].values()
               for v in cmp.values()):
        raise AssertionError("phase 16: a non-finite loss component in the flagship's steps")
    for r in rows:
        log(f"  (d) {r['dtype']} step {r['step']}: loss card {r['components']['card']['loss']:.6f} "
            f"CPU {r['components']['cpu']['loss']:.6f} card from one ulp away "
            f"{r['components']['card_ulp']['loss']:.6f}; parameters card vs CPU "
            f"{r['groups']['card_vs_cpu']['model']:.3e}, card vs card one ulp away "
            f"{r['groups']['card_vs_card_ulp']['model']:.3e}")
    log(f"  (d) sha256 of the batches {steps['sha256']}; {time.perf_counter() - t0:.1f} s")
    out["flagship_steps"] = {"sha256": steps["sha256"], "first_float32": first}

    t0 = time.perf_counter()
    bn = card_probes.bn_precision(dev)
    for side, e in bn["errors"].items():
        log(f"  (e) {side} float32 against float64: model {e['model']:.4e}, non-zero leaves "
            f"{e['nonzero']:.4e}, the {bn['exact_zero']} exactly-zero leaves "
            f"{e['zero_over_model']:.3e} of the model's norm; most of the error in "
            f"{json.dumps(e['worst'][:2])}")
    alone = bn["batchnorm_alone"]
    log(f"  (e) {alone['module']} {alone['shape']} alone against float64: " + "; ".join(
        f"{side} " + " ".join(f"{leg} {alone[side][leg]:.3e}"
                              for leg in ("y", "grad_x", "grad_w", "grad_b"))
        + (f" kernels {alone[side]['kernels']}" if "kernels" in alone[side] else "")
        for side in ("card", "card_native", "cpu")))
    log(f"  (e) batch sha256 {bn['batch_sha256']}; the card's error on the non-zero leaves "
        f"is {bn['card_over_jax']:.3f}x JAX's float32 {card_probes.JAX_F32_ERROR:.4e} (bar "
        f"{card_probes.BN_RATIO:g}x); {time.perf_counter() - t0:.1f} s")
    if not all(np.isfinite(v) for e in bn["errors"].values()
               for v in (e["model"], e["nonzero"], e["zero_over_model"])):
        raise AssertionError("phase 16: non-finite gradient errors at the shipped checkpoint")
    if not bn["ok"]:
        raise AssertionError(f"phase 16: the card's float32 gradient is {bn['card_over_jax']:.3f}x "
                             f"JAX's float32 error from float64 (bar {card_probes.BN_RATIO:g}x)")
    out["bn_precision"] = {"card_over_jax": bn["card_over_jax"],
                           **{side: {k: e[k] for k in ("model", "nonzero", "zero_over_model")}
                              for side, e in bn["errors"].items()},
                           "batchnorm_alone": alone}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--dp-switches"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
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
    # the trainer's host lock in this run's temporary directory
    os.environ.setdefault("HDT_CAMPAIGN_LOCK",
                          os.path.join(tempfile.gettempdir(), "hdt_campaign.lock"))
    smi = nvidia_smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    path = cuda_build.build("rasterize")
    log(f"  built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    log(f"  card: {smi}")
    if argv == ["--dp-switches"]:
        from head_detector_tpu_torch.tools import card_probes

        log("phase 16 (b) under each setting of the deterministic switches")
        rows = {}
        for switches in (s for s in card_probes.SWITCHES if s != "all"):  # phase 16 runs "all"
            dp = phase_dp_resume(dev, switches)
            rows[switches] = {k: v for k, v in dp.items() if k != "switches"}
        print(json.dumps({"dp_switches": rows}))
        print(smi)
        return 0

    log("phase 2: kernels vs plain on the card")
    flame_model = FlameModel.from_assets(device=dev)
    entries = phase_kernels(flame_model)
    standin_err, at_standin = phase_standin_kernel(flame_model)

    log("phase 3: main path")
    t0 = time.perf_counter()
    detector = HeadDetector(model=MODEL, image_size=IMAGE_SIZE, checkpoint=CHECKPOINT,
                            device=dev)
    log(f"  restored {detector.restored_leaves[0]}/{detector.restored_leaves[1]} leaves, "
        f"detector ready in {time.perf_counter() - t0:.2f} s")
    scenes, launches, results = phase_main_path(detector, flame_model)
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

    log("phase 8: the flagship training configuration")
    with tempfile.TemporaryDirectory() as root:
        renderer_err, at_renderer = phase_renderer_kernel(flame_model)
        flagship = phase_flagship(dev, flame_model, root)
        log("  " + json.dumps({"flagship": flagship}))

        log("phase 9: export and evaluation")
        evaluation = phase_evaluation(dev, detector, scenes, root, flagship["data_dir"],
                                      flagship["ckpt_dir"])
        log("  " + json.dumps({"evaluation": evaluation}))

        log("phase 10: data factory and tools")
        factory = phase_factory_generation(dev, flame_model, root)
        factory_err, at_factory = phase_factory_kernel(flame_model, *factory.pop("largest"))
        factory.update(phase_factory_tools(dev, scenes, root, flagship["data_dir"],
                                           flagship["ckpt_dir"], factory["split_dir"]))
        log("  " + json.dumps({"factory": factory}, default=float))

        log("phase 11: export and quantization")
        exported = phase_export(dev, detector, scenes, root)
        log("  " + json.dumps({"export": exported}, default=float))
        del detector

        log("phase 12: SegFormer")
        segformer = phase_segformer(dev, flame_model, root, flagship["data_dir"], evaluation)
        log("  " + json.dumps({"segformer": segformer}, default=float))

        log("phase 15: the last modules")
        t0 = time.perf_counter()
        last = phase_last_modules(dev, flame_model, root, results, evaluation,
                                  entries[0]["device_ms"])
        log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")
        log("  " + json.dumps({"last_modules": last}, default=float))

        log("phase 16: faults")
        t0 = time.perf_counter()
        faults = phase_faults(dev, flagship)
        log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
        log("  " + json.dumps({"faults": faults}, default=float))

    log("phase 14: data parallel")
    t0 = time.perf_counter()
    data_parallel = phase_data_parallel(dev, flame_model)
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s")
    log("  " + json.dumps({"data_parallel": data_parallel}, default=float))

    log("phase 13: kernels")
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], renderer_err, standin_err,
                                    factory_err)
    entries[0]["at_renderer"] = at_renderer
    entries[0]["at_standin"] = at_standin
    entries[0]["at_factory"] = at_factory
    for entry in entries:
        serving = entry["launches"]
        entry["launches_by_path"] = {"serving": serving,
                                     "training": training["launches"].get(entry["name"], 0),
                                     "flagship": flagship["launches"].get(entry["name"], 0),
                                     "evaluation": evaluation["launches"].get(entry["name"], 0),
                                     "factory": factory["launches"].get(entry["name"], 0),
                                     "export": exported["launches"].get(entry["name"], 0),
                                     "segformer": segformer["launches"].get(entry["name"], 0),
                                     "data_parallel": data_parallel["launches"].get(
                                         entry["name"], 0),
                                     "campaign": last["launches"].get(entry["name"], 0)}
        entry["launches"] = sum(entry["launches_by_path"].values())
    for name, path in (("rasterize_zbuffer", "evaluation"), ("rasterize_zbuffer", "factory"),
                       ("pncc_render", "export"), ("rasterize_zbuffer", "segformer"),
                       ("rasterize_zbuffer", "data_parallel"), ("rasterize_zbuffer", "campaign")):
        entry = next(e for e in entries if e["name"] == name)
        if entry["launches_by_path"][path] <= 0:
            raise AssertionError(f"{name} was not launched on the {path} path")

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
