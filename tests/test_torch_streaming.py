"""The port's StreamingDetector on the CPU against the JAX package's.

Float32 (as tests/test_pipeline.py drives the JAX one): TINY arch, 64 px,
batch 4, 10 random images of mixed sizes, the same JAX-initialised weights
in both (BatchNorm statistics calibrated on the letterboxed inputs, which
keeps the random network's float32 rounding from growing layer by layer,
as a trained network's does not).  Per image: ``valid`` equal, scores
within 1e-5, vertices (bfloat16 on the wire in both) within atol 0.05 /
rtol 1e-2, the JAX suite's own bars; boxes within 1e-3 px plus 3e-5 of
their size.  That relative term is float32 reassociation: the two packages'
convolutions sum in other orders, and the DFL decode times stride 32 turns
that into 2.7e-3 px on boxes of up to 340 px (measured; scores differ by
5.6e-6); with weights folded by the JAX package the difference is the same,
so it is not the fold.  The tail batch is padded and only real images are
emitted.

Bfloat16 on the shipped yolo_heads_m checkpoint (the random TINY network is
not stable in bfloat16; see tests/test_torch_options.py) at 192 px, batch
4, rendered scenes, detections matched by IoU.  Measured here: box IoU >=
0.9884, score |d| <= 0.0070; the bars are those with a 2x margin, box IoU
>= 0.976 and score |d| <= 1.4e-2 (tighter than 0.95 and 2e-2).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu.models import build_model as jax_build_model
from head_detector_tpu.models.yolo_heads import calibrate_batch_stats
from head_detector_tpu.pipeline import StreamingDetector as JaxStreamingDetector
from head_detector_tpu_torch.pipeline import StreamingDetector
from head_detector_tpu_torch.train.dataset import render_scene
from test_model import TINY
from test_torch_options import M_CHECKPOINT, port_arch, tiny_variables

KW = dict(image_size=64, batch_size=4, confidence_threshold=1e-6, post_nms_max=10)


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 255, (rng.randint(40, 90), rng.randint(40, 90), 3), np.uint8)
            for _ in range(10)]


@pytest.fixture(scope="module")
def f32_runs(images):
    canvases = []
    for im in images:  # the streaming letterbox: INTER_LINEAR, centred, 127
        scale = min(64 / im.shape[0], 64 / im.shape[1])
        nh, nw = int(im.shape[0] * scale + 0.5), int(im.shape[1] * scale + 0.5)
        canvas = np.full((64, 64, 3), 127, np.uint8)
        top, left = (64 - nh) // 2, (64 - nw) // 2
        canvas[top:top + nh, left:left + nw] = cv2.resize(im, (nw, nh))
        canvases.append(canvas)
    variables = calibrate_batch_stats(jax_build_model(TINY), tiny_variables(),
                                      jnp.asarray(np.stack(canvases) / 255.0, jnp.float32))
    want = JaxStreamingDetector(model_name=TINY, variables=variables, dtype=jnp.float32, **KW)
    got = StreamingDetector(model_name=port_arch(TINY),
                            variables=jax.tree_util.tree_map(np.asarray, variables),
                            dtype=torch.float32, device="cpu", workers=2, **KW)
    return list(want.run(images)), list(got.run(images)), got


def test_streaming_matches_jax_float32(f32_runs):
    want, got, _ = f32_runs
    assert len(got) == len(want) == 10
    print("streaming float32, port vs JAX: score |d|",
          max(np.abs(g["scores"] - w["scores"]).max() for g, w in zip(got, want)),
          "box |d|", max(np.abs(g["boxes_xyxy"] - w["boxes_xyxy"]).max()
                         for g, w in zip(got, want)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
        np.testing.assert_allclose(g["boxes_xyxy"], w["boxes_xyxy"], atol=1e-3, rtol=3e-5)
        assert g["scale"] == w["scale"]
        assert sorted(g["vertices"]) == sorted(w["vertices"])
        for slot, v in g["vertices"].items():
            np.testing.assert_allclose(v.float().numpy(),
                                       np.asarray(w["vertices"][slot], np.float32),
                                       atol=0.05, rtol=1e-2)


def test_streaming_tail_batch_and_vertices(f32_runs, images):
    """10 images in batches of 4: the last batch is two real images padded
    with copies of the last, and emits two results, equal to a run of those
    images alone.  ``vertices`` maps the valid NMS slots to [2470, 3]
    tensors (the ``head`` subset) in bfloat16."""
    _, got, det = f32_runs
    for r, im in zip(got, images):
        assert r["boxes_xyxy"].shape == (10, 4) and r["scores"].shape == (10,)
        assert r["scale"] == min(64 / im.shape[0], 64 / im.shape[1])
        n_valid = int(r["valid"].sum())
        assert isinstance(r["vertices"], dict) and len(r["vertices"]) == n_valid > 0
        for slot, v in r["vertices"].items():
            assert r["valid"][slot]
            assert v.shape == (2470, 3) and v.dtype == torch.bfloat16
    alone = list(det.run(images[8:]))
    assert len(alone) == 2
    for a, r in zip(alone, got[8:]):
        np.testing.assert_array_equal(a["boxes_xyxy"], r["boxes_xyxy"])
        for slot, v in a["vertices"].items():
            torch.testing.assert_close(v, r["vertices"][slot], rtol=0, atol=0)
    assert list(det.run([])) == []


def test_streaming_producer_error_reaches_the_caller(f32_runs):
    _, _, det = f32_runs
    with pytest.raises(ValueError):
        list(det.run([np.zeros((4, 4), np.uint8)] * 5))  # no colour axis


def test_streaming_matches_jax_bfloat16():
    scenes = [render_scene(11, i, size=192, max_heads=3, device="cpu") for i in range(5)]
    kw = dict(model_name="yolo_heads_m", checkpoint=M_CHECKPOINT, image_size=192,
              batch_size=4, confidence_threshold=0.3)
    want = list(JaxStreamingDetector(**kw).run(scenes))
    got = list(StreamingDetector(device="cpu", workers=2, **kw).run(scenes))
    worst = {"iou": 1.0, "score": 0.0}
    matched = 0
    for g, w in zip(got, want):
        for j in np.flatnonzero(w["valid"]):
            ious = _iou(w["boxes_xyxy"][j], g["boxes_xyxy"][g["valid"]])
            k = int(np.argmax(ious))
            worst["iou"] = min(worst["iou"], float(ious[k]))
            worst["score"] = max(worst["score"],
                                 abs(float(g["scores"][g["valid"]][k] - w["scores"][j])))
            matched += 1
    print("streaming bfloat16, port vs JAX:", worst, matched)
    assert matched >= 3
    assert worst["iou"] >= 0.976 and worst["score"] <= 1.4e-2


def _iou(box, boxes):
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    area = lambda b: np.prod(b[..., 2:] - b[..., :2], axis=-1)
    return inter / (area(box) + area(boxes) - inter)


def test_streaming_runs_on_cuda_by_default():
    """The entry point asks for the card unless it is given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here; the refusal is for hosts without it")
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingDetector(model_name="yolo_heads_m", checkpoint=M_CHECKPOINT)
