"""The port's StreamingDetector stages each batch in place: the letterbox
workers write straight into the rows of a pinned slot set taken from a ring
of ``pipeline_depth + 1``, and the step reads the slot.

On the CPU (the slot is the step's input), TINY arch at 64 px, float32,
random weights, batch 4:

- (a) ``run()``'s outputs are bit-equal to ``_step`` on the stacked
  ``_letterbox_host`` canvases, batch by batch (the short last batch padded
  with copies of its last canvas), over an input that wraps the ring several
  times, for 1 and 8 workers and pipeline depths 1 and 2;
- (b) two replicas on the CPU: each replica's rows bit-equal to ``_step`` on
  its half of the canvases, and the run within the bars of
  tests/test_torch_multichip.py of one replica's;
- (c) a row letterboxed in place equals ``_letterbox_host``'s canvas and the
  fresh-canvas layout byte for byte, through cv2 and ``HDT_LETTERBOX=native``,
  on wide, tall, odd-padded, upscaled and downscaled inputs;
- (d) under a profiler session the producer counts a ring fill a batch taken,
  and none whose wait began before the session;
- (e) a producer error reaches the caller, and a run closed mid-input stops
  its producer and its workers.
"""

import threading
import time

import cv2
import numpy as np
import pytest
import torch

from head_detector_tpu_torch import profiling
from head_detector_tpu_torch.detector import random_variables
from head_detector_tpu_torch.native import available as native_available
from head_detector_tpu_torch.native import letterbox_native
from head_detector_tpu_torch.pipeline import StreamingDetector, _Slot, letterbox_into
from test_model import TINY
from test_torch_options import port_arch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZE, BATCH = 64, 4
KW = dict(image_size=SIZE, batch_size=BATCH, confidence_threshold=1e-6, post_nms_max=10,
          dtype=torch.float32)


@pytest.fixture(scope="module")
def variables():
    return random_variables(port_arch(TINY), SIZE, torch.device("cpu"))


@pytest.fixture(scope="module")
def images():
    """38 images of mixed sizes: 9 full batches of 4 and a short one of 2."""
    rng = np.random.RandomState(3)
    return [rng.randint(0, 255, (rng.randint(30, 110), rng.randint(30, 110), 3), np.uint8)
            for _ in range(38)]


def detector(variables, **kw):
    return StreamingDetector(model_name=port_arch(TINY), variables=variables,
                             **{"device": "cpu", **KW, **kw})


def stepped(det, images):
    """What ``run()`` should emit for ``images``: ``_step`` on each batch's
    ``_letterbox_host`` canvases split over the replicas, as dicts."""
    out = []
    for start in range(0, len(images), BATCH):
        batch = images[start:start + BATCH]
        canvases = [det._letterbox_host(im) for im in batch]
        padded = canvases + [canvases[-1]] * (BATCH - len(batch))
        for k, rep in enumerate(det.replicas):
            rows = padded[k * det.rows:(k + 1) * det.rows]
            boxes, scores, valid, (bidx, sidx, mvalid, verts) = det._step(
                torch.as_tensor(np.stack([c for c, _ in rows])), replica=rep)
            for i, (_, scale) in enumerate(rows):
                if start + k * det.rows + i >= len(images):
                    break
                keep = np.flatnonzero(mvalid.numpy() & (bidx.numpy() == i))
                out.append({"boxes_xyxy": boxes[i].numpy(), "scores": scores[i].numpy(),
                            "valid": valid[i].numpy(), "scale": scale,
                            "vertices": {int(sidx[j]): verts[j] for j in keep}})
    return out


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("boxes_xyxy", "scores", "valid"):
            np.testing.assert_array_equal(g[key], w[key])
        assert g["scale"] == w["scale"]
        assert sorted(g["vertices"]) == sorted(w["vertices"]) and g["vertices"]
        for slot, v in g["vertices"].items():
            assert torch.equal(v, w["vertices"][slot])


@pytest.mark.parametrize("workers", [1, 8])
@pytest.mark.parametrize("depth", [1, 2])
def test_staged_run_equals_step_on_host_canvases(variables, images, workers, depth):
    det = detector(variables, workers=workers, pipeline_depth=depth)
    assert len(images) // BATCH >= 3 * (depth + 1)  # the ring wraps three times or more
    assert_bit_equal(list(det.run(images)), stepped(det, images))


def test_two_cpu_replicas_equal_one(variables, images):
    two = detector(variables, devices=["cpu", "cpu"], workers=3)
    assert len(two.replicas) == 2 and two.rows == 2
    got = list(two.run(images))
    assert_bit_equal(got, stepped(two, images))
    want = list(detector(variables, workers=3).run(images))
    for g, w in zip(got, want):  # a batch of 2 convolves in other sums than one of 4
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
        np.testing.assert_allclose(g["boxes_xyxy"], w["boxes_xyxy"], atol=1e-3, rtol=3e-5)
        assert g["scale"] == w["scale"]
        assert sorted(g["vertices"]) == sorted(w["vertices"])
        for slot, v in g["vertices"].items():
            np.testing.assert_allclose(v.float().numpy(), w["vertices"][slot].float().numpy(),
                                       atol=0.05, rtol=1e-2)


def fresh_canvas(image, size):
    """The layout of a fresh 127 canvas with the cv2 picture pasted in."""
    scale = min(size / image.shape[0], size / image.shape[1])
    nh, nw = int(image.shape[0] * scale + 0.5), int(image.shape[1] * scale + 0.5)
    canvas = np.full((size, size, 3), 127, np.uint8)
    top, left = (size - nh) // 2, (size - nw) // 2
    canvas[top:top + nh, left:left + nw] = cv2.resize(image, (nw, nh),
                                                      interpolation=cv2.INTER_LINEAR)
    return canvas, scale


@pytest.mark.parametrize("path", ["cv2", "native"])
def test_in_place_rows_equal_host_canvases(monkeypatch, path):
    if path == "native":
        if not native_available():
            pytest.skip("the native host library does not build here")
        monkeypatch.setenv("HDT_LETTERBOX", "native")
    rng = np.random.RandomState(5)
    # wide, tall, odd padding on each axis, upscaled, downscaled, square
    shapes = [(37, 90), (90, 37), (45, 64), (64, 51), (13, 29), (211, 150), (80, 80)]
    ims = [rng.randint(0, 255, (h, w, 3), np.uint8) for h, w in shapes]
    slot = _Slot((len(ims), SIZE, SIZE, 3), torch.device("cpu"))
    slot.rows[...] = 3  # stale bytes: every byte of a row must be written
    stub = type("Stub", (), {"image_size": SIZE})()
    for i, im in enumerate(ims):
        scale = letterbox_into(im, slot.rows[i])
        canvas, host_scale = StreamingDetector._letterbox_host(stub, im)
        want, want_scale = (letterbox_native(im, SIZE) if path == "native"
                            else fresh_canvas(im, SIZE))
        np.testing.assert_array_equal(slot.rows[i], canvas)
        np.testing.assert_array_equal(slot.rows[i], want)
        assert scale == host_scale == want_scale
    assert torch.equal(slot.dev, torch.as_tensor(slot.rows))  # the step's input


def test_ring_counters_under_a_profiler_session(variables, images, tmp_path):
    det = detector(variables, workers=2, pipeline_depth=1)
    with profiling.trace(str(tmp_path)):
        out = list(det.run(images))
    snap = profiling.snapshot()
    profiling.reset()
    batches = -(-len(images) // BATCH)
    assert len(out) == len(images)
    assert snap["counters"]["pipeline.ring_fills"] == batches
    assert snap["counters"]["pipeline.ring_wait_ns"] >= 0
    assert snap["counters"]["pipeline.letterbox_images"] == len(images)
    assert snap["spans"]["pipeline.upload"]["count"] == batches


def test_ring_wait_begun_before_a_session_is_not_counted(variables, images, tmp_path):
    det = detector(variables, workers=2, pipeline_depth=1)
    run = det.run(images)
    next(run)  # the producer fills both slot sets and waits for a free one
    time.sleep(1.0)
    assert not profiling.recording()
    t0 = time.perf_counter_ns()
    with profiling.trace(str(tmp_path)):
        assert profiling.recording()
        rest = list(run)
    inside = time.perf_counter_ns() - t0
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert len(rest) == len(images) - 1
    assert 0 < counters["pipeline.ring_fills"] < -(-len(images) // BATCH)
    assert 0 <= counters["pipeline.ring_wait_ns"] <= inside


def test_producer_error_reaches_the_caller_mid_input(variables, images):
    det = detector(variables, workers=2)
    bad = images[:21] + [np.zeros((40, 50), np.uint8)] + images[21:]  # no colour axis
    got = []
    with pytest.raises(ValueError):
        for out in det.run(bad):
            got.append(out)
    assert len(got) <= 20


def test_closing_a_run_mid_input_stops_its_producer(variables, images):
    det = detector(variables, workers=2, pipeline_depth=1)
    before = set(threading.enumerate())
    run = det.run(images * 3)
    first = [next(run) for _ in range(5)]
    assert len(first) == 5 and len(set(threading.enumerate()) - before) >= 2
    closer = threading.Thread(target=run.close)
    closer.start()
    closer.join(timeout=60)
    assert not closer.is_alive(), "closing the run hung"
    assert set(threading.enumerate()) == before  # the producer and its workers joined
