"""The port's competitor protocol against the JAX package's on the CPU.

Follows ``tests/test_evaluation.py``'s competitor cases: a perfect mock
detector scores AP 1.0 through ``evaluate_external_detector``, malformed
img2pose artifacts raise, and the makers of the real competitors raise
``RuntimeError`` without their packages.  On the port's FDDB stand-in (a
rendered validation split through ``tools/make_fddb_standin``) a seeded
imperfect mock scores the same AP through both packages' function.
"""

import os

import cv2
import numpy as np
import pytest

from head_detector_tpu.evaluation import evaluate_competitors as jax_competitors
from head_detector_tpu_torch.evaluation import evaluate_competitors as competitors
from head_detector_tpu_torch.evaluation.evaluate_fddb import read_fddb_annotations
from head_detector_tpu_torch.tools.make_fddb_standin import make_fddb_standin
from head_detector_tpu_torch.tools.render_synthetic_dataset import render_split
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _labelled_images(root, rng, count=3):
    img_dir = root / "images" / "d"
    img_dir.mkdir(parents=True)
    lines, truth = [], {}
    for i in range(count):
        name = f"d/{i}.jpg"
        cv2.imwrite(str(root / "images" / name), rng.randint(0, 255, (60, 80, 3), np.uint8))
        boxes = []
        for _ in range(2):
            x, y = rng.randint(0, 30, 2)
            w, h = rng.randint(10, 25, 2)
            boxes.append([x, y, x + w, y + h])
        truth[name] = np.asarray(boxes, float)
        lines.append(f"# {name}")
        lines += [f"{b[0]} {b[1]} {b[2]} {b[3]}" for b in boxes]
    (root / "label.txt").write_text("\n".join(lines) + "\n")
    return truth


def test_perfect_mock_detector_scores_ap_one(tmp_path):
    truth = _labelled_images(tmp_path, np.random.RandomState(7))
    order = iter(list(truth))

    def perfect_detector(image):
        boxes = truth[next(order)]  # images are read in label order
        return boxes, np.full(len(boxes), 0.9)

    result = competitors.evaluate_external_detector(str(tmp_path), perfect_detector)
    assert result["AP50"] == pytest.approx(1.0, abs=1e-6)
    assert result["AP"] == pytest.approx(1.0, abs=1e-6)


def test_img2pose_artifact_parsing(tmp_path):
    np.save(tmp_path / "reference_3d_68_points_trans.npy", np.zeros((68, 3)))
    np.save(tmp_path / "WIDER_train_pose_mean_v1.npy", np.zeros(6))
    np.save(tmp_path / "WIDER_train_pose_stddev_v1.npy", np.ones(6))
    arts = competitors.load_img2pose_artifacts(str(tmp_path))
    assert arts["threed_68_points"].shape == (68, 3)
    assert sorted(arts) == sorted(jax_competitors.load_img2pose_artifacts(str(tmp_path)))

    np.save(tmp_path / "WIDER_train_pose_mean_v1.npy", np.zeros(5))
    with pytest.raises(ValueError):
        competitors.load_img2pose_artifacts(str(tmp_path))
    np.save(tmp_path / "WIDER_train_pose_mean_v1.npy", np.zeros(6))
    np.save(tmp_path / "reference_3d_68_points_trans.npy", np.zeros((5, 3)))
    with pytest.raises(ValueError):
        competitors.load_img2pose_artifacts(str(tmp_path))
    os.remove(tmp_path / "WIDER_train_pose_stddev_v1.npy")
    with pytest.raises(FileNotFoundError):
        competitors.load_img2pose_artifacts(str(tmp_path))


def test_gated_makers_raise_without_their_packages(tmp_path):
    np.save(tmp_path / "reference_3d_68_points_trans.npy", np.zeros((68, 3)))
    np.save(tmp_path / "WIDER_train_pose_mean_v1.npy", np.zeros(6))
    np.save(tmp_path / "WIDER_train_pose_stddev_v1.npy", np.ones(6))
    with pytest.raises(RuntimeError, match="img2pose is not installed"):
        competitors.make_img2pose_detector(str(tmp_path))
    with pytest.raises(RuntimeError, match="insightface is not installed"):
        competitors.make_scrfd_detector()
    with pytest.raises(RuntimeError):
        competitors.main(["--data-dir", str(tmp_path)])


def test_ap_matches_jax_on_the_fddb_standin(tmp_path):
    synth, fddb = str(tmp_path / "synth"), str(tmp_path / "fddb")
    render_split(synth, "val", count=6, image_size=96, seed=1, device="cpu", max_heads=3)
    assert make_fddb_standin(synth, fddb) == 6
    truth = read_fddb_annotations(fddb)
    rng = np.random.RandomState(11)
    answers = {}  # a fixed imperfect answer an image, keyed by its pixels
    for name, boxes in truth.items():
        image = cv2.cvtColor(cv2.imread(os.path.join(fddb, "images", name)), cv2.COLOR_BGR2RGB)
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        jitter = rng.uniform(-4, 4, boxes.shape)
        extra = rng.uniform(0, 80, (rng.randint(0, 3), 2))
        false = np.concatenate([extra, extra + rng.uniform(5, 15, extra.shape)], axis=1)
        answers[image.tobytes()] = (np.concatenate([boxes + jitter, false]),
                                    rng.uniform(0.1, 1.0, len(boxes) + len(false)))

    def detector(image):
        return answers[image.tobytes()]

    got = competitors.evaluate_external_detector(fddb, detector)
    want = jax_competitors.evaluate_external_detector(fddb, detector)
    assert 0.0 < got["AP"] < 1.0
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
