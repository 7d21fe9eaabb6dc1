"""The port's evaluation library and protocols against the JAX package on the
CPU: the DAD metrics, ``calculate_rpy``, ``HeadMesh``, ``transforms3dmm``,
``coco_map``, ``EvalPredictor``, the DAD / AFLW / BIWI / FDDB / WIDER
protocols and ``run_protocols``, and the stand-in renderers.

Bars, and why:
- metrics and geometry on the same numpy inputs: within 1e-6 relative
  (float64 numpy on both sides; the FLAME decode and the rotations are
  float32 in both and held to 1e-6 of the largest magnitude); the float32
  chamfer distance within 1e-5 relative; ``coco_map`` and the 68 landmark
  indices equal.
- ``EvalPredictor`` (the shipped yolo_heads_m checkpoint at 256 px): the
  same count of detections, boxes within 1e-3 px + 3e-5 of the box's
  larger side (float32 reassociation after DFL x stride grows with the box,
  not with a corner's distance from the origin; see
  ``test_torch_streaming.py``), scores within 1e-4, 2D vertices and
  ``mm_params`` within 1e-4 of their largest magnitude.
- the protocols on the shipped yolo_heads_m checkpoint at 256 px, on scenes
  the port renders (real heads, detected far from the thresholds): every
  result key within 1e-3 relative of the JAX value, AP values within 1e-6,
  the same head selected on every DAD sample.
- the DAD stand-in renderer against the JAX tool run in a subprocess (4
  samples, 128 px, up to 3 heads): the same keys and attributes, floats
  within 1e-5 of each field's largest magnitude; the PNGs equal on >= 99.9%
  of pixels, none off by more than 1 level (the host rasterizer of the JAX
  tool and the port's plain one differ on sliver triangles; ROADMAP Queue
  3); the FDDB stand-in byte-equal to the JAX tool's.

Every test draws from its own ``np.random.RandomState``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from head_detector_tpu.evaluation import dad_metrics as jdm
from head_detector_tpu.evaluation import detection_ap as jap
from head_detector_tpu.evaluation import evaluate_dad as jdad
from head_detector_tpu.evaluation import evaluate_fddb as jfddb
from head_detector_tpu.evaluation import evaluate_pose as jpose
from head_detector_tpu.evaluation import evaluate_wider as jwider
from head_detector_tpu.evaluation import transforms3dmm as jt3
from head_detector_tpu.evaluation.head_mesh import HeadMesh as JaxHeadMesh
from head_detector_tpu.detector import load_variables as jax_load_variables
from head_detector_tpu.evaluation.predictor import EvalPredictor as JaxEvalPredictor
from head_detector_tpu.head_info import FlameParams as JaxFlameParams
from head_detector_tpu.head_info import RPY as JaxRPY
from head_detector_tpu.ops import rotation as jrot
from head_detector_tpu.post_prediction import (
    YoloHeadsPostPredictionCallback as JaxCallback,
)
from head_detector_tpu.post_prediction import YoloHeadsPredictions as JaxPredictions
from head_detector_tpu_torch.evaluation import dad_metrics as dm
from head_detector_tpu_torch.evaluation import detection_ap as ap
from head_detector_tpu_torch.evaluation import evaluate_dad as dad
from head_detector_tpu_torch.evaluation import evaluate_fddb as fddb
from head_detector_tpu_torch.evaluation import evaluate_pose as pose
from head_detector_tpu_torch.evaluation import evaluate_wider as wider
from head_detector_tpu_torch.evaluation import transforms3dmm as t3
from head_detector_tpu_torch.evaluation.head_mesh import HeadMesh
from head_detector_tpu_torch.evaluation.predictor import EvalPredictor
from head_detector_tpu_torch.flame import FlameModel
from head_detector_tpu_torch.head_info import RPY, FlameParams
from head_detector_tpu_torch.ops import rotation
from head_detector_tpu_torch.post_prediction import YoloHeadsPostPredictionCallback
from head_detector_tpu_torch.post_prediction import YoloHeadsPredictions
from head_detector_tpu_torch.tools import make_fddb_standin, run_protocols
from head_detector_tpu_torch.tools.render_dad_testset import render_testset
from head_detector_tpu_torch.tools.render_synthetic_dataset import render_split
from test_model import TINY
from test_torch_options import M_CHECKPOINT, port_arch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M_SIZE = 256
DAD_SETTINGS = dict(confidence_threshold=0.2, nms_iou_threshold=0.5,
                    post_nms_max_predictions=30)
POSE_SETTINGS = dict(confidence_threshold=0.5, nms_iou_threshold=0.5,
                     post_nms_max_predictions=30)
DETECTION_SETTINGS = dict(confidence_threshold=0.5, nms_iou_threshold=0.5,
                          pre_nms_max_predictions=1000, post_nms_max_predictions=500)
AP_KEYS = ("AP", "AP50", "AP75", "AR100")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work in one thread for this module: the suite runs
    several test processes at once, and torch's default of one thread per
    core oversubscribes the cores (a yolo_heads_m forward at 256 px took
    51 s beside five busy processes, 0.4 s in one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_max(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_results_close(got: dict, want: dict):
    """Every key of the JAX result: AP values within 1e-6, counts equal,
    every other float within 1e-3 relative."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (int, np.integer)) and not isinstance(w, bool):
            assert g == w, k
        elif k in AP_KEYS:
            assert abs(g - w) <= 1e-6, (k, g, w)
        else:
            assert abs(g - w) <= 1e-3 * abs(w), (k, g, w)


# ---------------------------------------------------------------- metrics
def test_dad_metrics_match_jax():
    rng = np.random.RandomState(0)
    pred, gt = rng.randn(68, 2) * 40 + 100, rng.randn(68, 2) * 40 + 100
    assert abs(dm.nme_2d(pred, gt, (30.0, 45.0)) - jdm.nme_2d(pred, gt, (30.0, 45.0))) <= \
        1e-6 * jdm.nme_2d(pred, gt, (30.0, 45.0))
    p3, g3 = rng.randn(2, 300, 3), rng.randn(2, 300, 3)
    assert dm.calc_zn(p3, g3) == jdm.calc_zn(p3, g3)
    q = np.linalg.qr(rng.randn(4, 3, 3))[0]
    r = np.linalg.qr(rng.randn(4, 3, 3))[0]
    for name in ("rotation_frobenius_error", "rotation_angle_error_deg"):
        got, want = getattr(dm, name)(q, r), getattr(jdm, name)(q, r)
        assert abs(got - want) <= 1e-6 * abs(want), name
    src = rng.randn(5023, 3)
    lm_s, lm_t = src[:7], rng.randn(7, 3) * 2 + 1
    assert rel_max(dm.procrustes_align(src, lm_s, lm_t), jdm.procrustes_align(src, lm_s, lm_t)) \
        <= 1e-6
    lm68 = rng.randn(68, 3)
    for got, want in zip(dm.scale_gt_to_standard(src, lm68), jdm.scale_gt_to_standard(src, lm68)):
        assert rel_max(got, want) <= 1e-6
    a, b = rng.randn(5023, 3) * 10, rng.randn(5023, 3) * 10
    got, want = dm.chamfer_distance(a, b), jdm.chamfer_distance(a, b)
    assert abs(got - want) <= 1e-5 * want
    assert dm.chamfer_distance(torch.as_tensor(a), torch.as_tensor(b)) == got
    np.testing.assert_array_equal(dm.get_68_landmark_indices(), jdm.get_68_landmark_indices())
    np.testing.assert_array_equal(dm.get_7_landmarks_from_68(lm68),
                                  jdm.get_7_landmarks_from_68(lm68))


def test_calculate_rpy_matches_jax():
    rng = np.random.RandomState(1)
    for _ in range(8):
        v = rng.randn(6).astype(np.float32)
        got, want = rotation.calculate_rpy(v), jrot.calculate_rpy(v)
        assert isinstance(got, RPY)
        assert rel_max(tuple(got), tuple(want)) <= 1e-6


def test_coco_map_matches_jax():
    rng = np.random.RandomState(2)
    preds, gts = [], []
    for i in range(6):
        n, m = rng.randint(0, 6), rng.randint(0 if i else 1, 5)
        xy = rng.uniform(0, 200, (m, 2))
        gt = np.concatenate([xy, xy + rng.uniform(10, 60, (m, 2))], 1)
        jitter = gt[rng.randint(0, max(m, 1), n)] if m else rng.uniform(0, 200, (n, 4))
        boxes = jitter + rng.randn(n, 4) * 4
        preds.append((boxes, rng.rand(n)))
        gts.append(gt)
    assert ap.coco_map(preds, gts) == jap.coco_map(preds, gts)
    assert ap.coco_map(preds[:1], [np.zeros((0, 4))]) == jap.coco_map(preds[:1],
                                                                        [np.zeros((0, 4))])


def test_head_mesh_matches_jax():
    rng = np.random.RandomState(3)
    params = (rng.randn(3, 413) * 0.2).astype(np.float32)
    params[:, 409:412] = rng.uniform(-0.5, 0.5, (3, 3))
    params[:, 412] = rng.uniform(-0.3, 0.3, 3)
    got = HeadMesh(image_size=256, device="cpu")
    want = JaxHeadMesh(image_size=256)
    x, xj = torch.from_numpy(params), jnp.asarray(params)
    for zero in (False, True):
        assert rel_max(got.vertices_3d(x, zero_rotation=zero),
                       want.vertices_3d(xj, zero_rotation=zero)) <= 1e-6
    want3 = np.asarray(want.reprojected_vertices(xj, to_2d=False))
    assert rel_max(got.reprojected_vertices(x, to_2d=False), want3) <= 1e-6
    assert rel_max(got.reprojected_vertices(x), want3[..., :2]) <= 1e-6
    pads = [3, -2, 5, 0]
    assert rel_max(got.adjust_3dmm_to_paddings(x, pads),
                   want.adjust_3dmm_to_paddings(xj, pads)) <= 1e-6


def test_transforms3dmm_match_jax():
    rng = np.random.RandomState(4)
    image = rng.randint(0, 255, (120, 160, 3), np.uint8)
    params = (rng.randn(1, 413) * 0.2).astype(np.float32)
    params[0, 409:412] = [0.1, -0.2, 0.0]
    rpy = (25.0, -10.0, 5.0)
    got_img, got_p = t3.vertically_align(image, FlameParams.from_3dmm(params.copy()),
                                         RPY(*rpy), 256)
    want_img, want_p = jt3.vertically_align(image, JaxFlameParams.from_3dmm(params.copy()),
                                            JaxRPY(*rpy), 256)
    np.testing.assert_array_equal(got_img, want_img)
    assert rel_max(got_p.to_3dmm_tensor(), np.asarray(want_p.to_3dmm_tensor())) <= 1e-6
    verts = rng.randn(5023, 3)
    assert abs(t3.get_scale(verts) - jt3.get_scale(verts)) <= 1e-6 * jt3.get_scale(verts)
    np.testing.assert_array_equal(t3.get_skull_center(verts), jt3.get_skull_center(verts))
    np.testing.assert_array_equal(t3.euler_angles_to_rotation_matrix(0.3, -0.2, 0.1),
                                  jt3.euler_angles_to_rotation_matrix(0.3, -0.2, 0.1))


# ---------------------------------------------------------- EvalPredictor
def test_eval_predictor_matches_jax(m_predictors, standins):
    """The shipped yolo_heads_m checkpoint at 256 px (the predictors the
    protocol tests share, so the JAX forward is compiled once) on the DAD
    stand-in's scenes in three input shapes, two needing the longest-side
    resize and the bottom/right pad.  A random network is no test of this bar: its
    FLAME scale is an exponential of its output (1.36e4 with the port's TINY
    initialisation at 64 px), through which float32 noise of the
    convolutions reaches 1.03e-4 of the largest 2D vertex."""
    got, want = use_settings(m_predictors, DAD_SETTINGS)
    (scene, _), (other, _) = _rendered_images(standins)[:2]
    for image in (scene, cv2.resize(other, (400, 300)), scene[40:216].copy()):
        g, w = got(image), want(image)
        assert len(g.scores) == len(w.scores) > 0
        size = (w.bboxes_xyxy[:, 2:] - w.bboxes_xyxy[:, :2]).max(1, keepdims=True)
        assert np.all(np.abs(g.bboxes_xyxy - w.bboxes_xyxy) <= 1e-3 + 3e-5 * size)
        assert np.abs(g.scores - w.scores).max() <= 1e-4
        assert rel_max(g.predicted_2d_vertices, w.predicted_2d_vertices) <= 1e-4
        assert rel_max(g.mm_params, w.mm_params) <= 1e-4
        assert rel_max(g.predicted_3d_vertices, w.predicted_3d_vertices) <= 1e-4
    # the random initialisation: every leaf of its own tree restored
    fresh = EvalPredictor(model_name=port_arch(TINY), image_size=64, confidence_threshold=1e-6,
                          post_nms_max_predictions=5, device="cpu")
    assert len(fresh(np.zeros((50, 64, 3), np.uint8)).scores) == 5


# ---------------------------------------------------------------- stand-ins
def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"hdt_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    """The port's stand-ins on the CPU at 256 px: a DAD set of 4 samples (up
    to 3 heads) and an FDDB set from a rendered validation split of 3 scenes."""
    root = tmp_path_factory.mktemp("standins")
    flame = FlameModel.from_assets(device="cpu")
    dad_dir, fddb_dir, synth = str(root / "dad"), str(root / "fddb"), str(root / "synth")
    render_testset(dad_dir, count=4, image_size=M_SIZE, max_heads=3, device="cpu",
                   flame_model=flame, log_every=0)
    render_split(synth, "val", count=3, image_size=M_SIZE, seed=1, device="cpu",
                 flame_model=flame, log_every=0)
    assert make_fddb_standin.make_fddb_standin(synth, fddb_dir) == 3
    with open(os.path.join(dad_dir, "dataset.json")) as f:
        index = json.load(f)
    return {"dad": dad_dir, "fddb": fddb_dir, "synth": synth, "index": index}


def test_fddb_standin_matches_jax_tool(standins, tmp_path, monkeypatch):
    out = str(tmp_path / "fddb_jax")
    monkeypatch.setattr(sys, "argv", ["make_fddb_standin.py", "--src", standins["synth"],
                                      "--out", out])
    _load_jax_tool("make_fddb_standin").main()
    for rel in ["label.txt"] + [os.path.join("images", n)
                                for n in sorted(os.listdir(os.path.join(out, "images")))]:
        with open(os.path.join(out, rel), "rb") as f, \
                open(os.path.join(standins["fddb"], rel), "rb") as g:
            assert f.read() == g.read(), rel


def _compare_datasets(got_dir, want_dir):
    with open(os.path.join(got_dir, "dataset.json")) as f:
        got = json.load(f)["standin"]
    with open(os.path.join(want_dir, "dataset.json")) as f:
        want = json.load(f)["standin"]
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["attributes"] == w["attributes"]
        assert g["image_path"] == w["image_path"]
        for key in ("bbox", "model_view_matrix", "landmarks_68_2d", "vertices_3d", "_params_dad"):
            worst = max(worst, rel_max(g[key], w[key]))
        a = cv2.imread(os.path.join(got_dir, g["image_path"])).astype(int)
        b = cv2.imread(os.path.join(want_dir, w["image_path"])).astype(int)
        diff = np.abs(a - b).max(-1)
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1, g["image_path"]
    assert worst <= 1e-5, worst


def test_dad_standin_matches_jax_tool(tmp_path):
    """4 samples at 128 px, up to 3 heads: the port's tool (plain rasterizer)
    against the JAX tool (host rasterizer) run in a subprocess."""
    args = ["--count", "4", "--image-size", "128", "--max-heads", "3"]
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "render_dad_testset.py"),
                           "--out", want_dir] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    from head_detector_tpu_torch.tools import render_dad_testset

    render_dad_testset.main(["--out", got_dir, "--device", "cpu"] + args)
    _compare_datasets(got_dir, want_dir)


def test_dad_gt_conventions_oracle(standins):
    """The GT of a port-rendered sample, fed back as the prediction in the
    predictor's frame, scores ~perfectly under the port's DadEvaluator, as
    under the JAX one."""
    cfg = standins["index"]["standin"][0]
    abs_v = np.asarray(cfg["vertices_3d"]) * np.array([1.0, -1.0, -1.0])
    params = np.asarray(cfg["_params_dad"], np.float32)

    def oracle(predictions):
        return lambda image: predictions(
            scores=np.array([1.0]),
            bboxes_xyxy=np.array([[*abs_v[:, :2].min(0), *abs_v[:, :2].max(0)]]),
            mm_params=params[None],
            predicted_3d_vertices=abs_v[None],
            predicted_2d_vertices=abs_v[None, :, :2],
        )

    result = dad.DadEvaluator([dad.DadSample.from_config(cfg, standins["dad"])],
                              oracle(YoloHeadsPredictions))()
    want = jdad.DadEvaluator([jdad.DadSample.from_config(cfg, standins["dad"])],
                             oracle(JaxPredictions))()
    assert result["nme_2d"] < 1e-6 and result["rot_error"] < 1e-5
    assert result["angle_error"] < 1e-3 and result["z_n"] == 1.0 and result["chamfer"] < 1e-6
    for k, w in want.items():
        assert abs(result[k] - w) <= 1e-5 * max(abs(w), 1e-3), (k, result[k], w)


# ---------------------------------------------------------------- protocols
@pytest.fixture(scope="module")
def m_predictors():
    """(port, JAX) EvalPredictor of the shipped yolo_heads_m checkpoint at
    256 px with the DAD settings; tests swap the callbacks.  The checkpoint's
    leaves are float16: the port makes every leaf float32 before any
    arithmetic (``weights.py``), so the JAX predictor gets the same leaves in
    float32 (they agree to 2e-7 of the largest FLAME parameter and 4e-7 in
    score on rendered scenes).  Fed the float16 leaves themselves, the JAX
    training-layout forward mixes float16 into its arithmetic and moves a
    score by up to 0.039 on the same scenes, a difference of the reference's
    float16 handling and not of the protocols."""
    got = EvalPredictor(model_name="yolo_heads_m", checkpoint=M_CHECKPOINT, image_size=M_SIZE,
                        device="cpu", **DAD_SETTINGS)
    f32 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                 jax_load_variables(M_CHECKPOINT))
    want = JaxEvalPredictor(model_name="yolo_heads_m", variables=f32, image_size=M_SIZE,
                            **DAD_SETTINGS)
    return got, want


def use_settings(predictors, settings):
    got, want = predictors
    got.callback = YoloHeadsPostPredictionCallback(flame_model=got.flame, **settings)
    want.callback = JaxCallback(flame_model=want.flame, **settings)
    return got, want


@pytest.fixture(scope="module")
def jax_dad(m_predictors, standins):
    """The JAX package's DAD pass and FDDB pass over the stand-ins, in
    ``tools/run_protocols.py``'s order and settings."""
    _, want = use_settings(m_predictors, DAD_SETTINGS)
    samples = [jdad.DadSample.from_config(c, standins["dad"])
               for c in standins["index"]["standin"]]
    evaluator = jdad.DadEvaluator(samples, want)
    result = evaluator()
    _, want = use_settings(m_predictors, DETECTION_SETTINGS)
    return evaluator, result, jfddb.evaluate_fddb(standins["fddb"], want)


def test_dad_evaluator_matches_jax(m_predictors, standins, jax_dad):
    got, _ = use_settings(m_predictors, DAD_SETTINGS)
    want_eval, want, _ = jax_dad
    samples = [dad.DadSample.from_config(c, standins["dad"])
               for c in standins["index"]["standin"]]
    evaluator = dad.DadEvaluator(samples, got)
    result = evaluator()
    print("DAD, port:", result, "JAX:", want)
    assert all(np.isfinite(v) for v in want.values())
    assert_results_close(result, want)
    assert len(evaluator.selected) == len(samples)
    for name, values in want_eval.metrics.items():
        assert len(evaluator.metrics[name]) == len(values)
        for g, w in zip(evaluator.metrics[name], values):
            assert abs(g - w) <= 1e-3 * abs(w), (name, g, w)
    for attr, groups in want_eval.attribute_metrics.items():
        assert set(evaluator.attribute_metrics[attr]) == set(groups), attr
        for group, by_metric in groups.items():
            for name, values in by_metric.items():
                np.testing.assert_allclose(evaluator.attribute_metrics[attr][group][name],
                                           values, rtol=1e-3)


def test_run_protocols_main_matches_jax(standins, jax_dad, tmp_path):
    _, want_dad, want_fddb = jax_dad
    out = str(tmp_path / "protocols.json")
    got = run_protocols.main([
        "--checkpoint", M_CHECKPOINT, "--arch", "yolo_heads_m", "--image-size", str(M_SIZE),
        "--dad-json", os.path.join(standins["dad"], "dataset.json"),
        "--dad-base", standins["dad"], "--fddb-dir", standins["fddb"], "--out", out,
        "--device", "cpu"])
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(got, default=float))
    assert set(got) == {"checkpoint", "arch", "image_size", "dad", "fddb", "seconds"}
    print("FDDB, port:", got["fddb"], "JAX:", want_fddb)
    assert want_fddb["AP50"] > 0.5
    assert_results_close(got["dad"], want_dad)
    assert_results_close(got["fddb"], want_fddb)


def _rendered_images(standins):
    """(RGB image, DAD config) of every DAD stand-in sample."""
    out = []
    for cfg in standins["index"]["standin"]:
        image = cv2.imread(os.path.join(standins["dad"], cfg["image_path"]))
        out.append((cv2.cvtColor(image, cv2.COLOR_BGR2RGB), cfg))
    return out


def test_aflw_evaluator_matches_jax(m_predictors, standins, tmp_path):
    """AFLW2000 layout (``imageNNNNN.jpg`` + ``.mat`` with ``Pose_Para`` and
    ``pt3d_68``) of the stand-in samples; one sample beyond 99 degrees is
    skipped by both."""
    rng = np.random.RandomState(6)
    for i, (image, cfg) in enumerate(_rendered_images(standins)):
        cv2.imwrite(str(tmp_path / f"image{i:05d}.jpg"), cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
        pose_para = np.zeros((1, 7))
        pose_para[0, :3] = np.deg2rad(rng.uniform(-40, 40, 3) if i < 3 else [120.0, 0, 0])
        lm = np.asarray(cfg["landmarks_68_2d"])
        pt3d = np.concatenate([lm, np.zeros((68, 1))], 1).T
        scipy.io.savemat(str(tmp_path / f"image{i:05d}.mat"),
                         {"Pose_Para": pose_para, "pt3d_68": pt3d})
    got_p, want_p = use_settings(m_predictors, POSE_SETTINGS)
    got = pose.AFLWEvaluator(str(tmp_path), got_p)()
    want = jpose.AFLWEvaluator(str(tmp_path), want_p)()
    assert want["evaluated"] == 3 and want["failed"] == 0
    assert_results_close(got, want)


def test_biwi_evaluator_matches_jax(m_predictors, standins, tmp_path):
    """BIWI layout (``*_rgb.png`` + ``*_pose.txt``) of the stand-in
    samples, the GT rotation from each sample's model-view matrix."""
    d = tmp_path / "01"
    d.mkdir()
    for i, (image, cfg) in enumerate(_rendered_images(standins)):
        cv2.imwrite(str(d / f"frame_{i:05d}_rgb.png"), cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
        rot = np.asarray(cfg["model_view_matrix"])[:3, :3]
        np.savetxt(str(d / f"frame_{i:05d}_pose.txt"), np.vstack([rot, [10.0, 20.0, 900.0]]))
    got_p, want_p = use_settings(m_predictors, POSE_SETTINGS)
    got = pose.BIWIEvaluator(str(tmp_path), got_p)()
    want = jpose.BIWIEvaluator(str(tmp_path), want_p)()
    assert want["evaluated"] == 4
    assert_results_close(got, want)


def test_fddb_and_wider_match_jax(m_predictors, standins, jax_dad, tmp_path):
    """``evaluate_fddb`` on the FDDB stand-in (against the JAX pass of
    ``jax_dad``), and ``evaluate_wider`` on the same scenes in the WIDER
    layout (xywh rows, one event directory, an image with no box), with the
    submission files compared line for line."""
    got_p, want_p = use_settings(m_predictors, DETECTION_SETTINGS)
    got = fddb.evaluate_fddb(standins["fddb"], got_p)
    want = jax_dad[2]
    assert want["AP50"] > 0.5
    assert_results_close(got, want)

    root = tmp_path / "wider"
    event = "0--Parade"
    img_dir = root / "WIDER_val" / "images" / event
    img_dir.mkdir(parents=True)
    (root / "wider_face_split").mkdir()
    lines = []
    ann_dir = os.path.join(standins["synth"], "val", "annotations")
    for name in sorted(os.listdir(ann_dir)):
        stem = os.path.splitext(name)[0]
        image = cv2.imread(os.path.join(standins["fddb"], "images", stem + ".jpg"))
        cv2.imwrite(str(img_dir / f"{stem}.jpg"), image)
        boxes = np.load(os.path.join(ann_dir, name))["bbox"]
        lines += [f"{event}/{stem}.jpg", str(len(boxes))]
        lines += [" ".join(str(int(round(v))) for v in b) + " 0 0 0 0 0 0" for b in boxes]
    cv2.imwrite(str(img_dir / "empty.jpg"), np.full((M_SIZE, M_SIZE, 3), 90, np.uint8))
    lines += [f"{event}/empty.jpg", "0", "0 0 0 0 0 0 0 0 0 0"]
    (root / "wider_face_split" / "wider_face_val_bbx_gt.txt").write_text("\n".join(lines) + "\n")
    got = wider.evaluate_wider(str(root), got_p, save_dir=str(tmp_path / "got"))
    want = jwider.evaluate_wider(str(root), want_p, save_dir=str(tmp_path / "want"))
    assert want["AP50"] > 0.5
    assert_results_close(got, want)
    for name in os.listdir(tmp_path / "want" / event):
        g = (tmp_path / "got" / event / name).read_text().split("\n")
        w = (tmp_path / "want" / event / name).read_text().split("\n")
        assert g[:2] == w[:2] and len(g) == len(w), name
        for lg, lw in zip(g[2:-1], w[2:-1]):
            # within one unit of the format (%.1f boxes, %.4f scores)
            a, b = np.float64(lg.split()), np.float64(lw.split())
            assert np.all(np.abs(a[:4] - b[:4]) <= 0.1 + 1e-9) and abs(a[4] - b[4]) <= 1e-4 + 1e-9
