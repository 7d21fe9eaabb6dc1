"""The port's campaign tools, host lock wait and FLOP estimate on the CPU.

* ``tools.run_campaign`` renders its own set (8 training and 2 validation
  scenes at 64 px) and trains ``flagship_campaign`` (cut to yolo_heads_n from
  random init, batch 2) as two one-epoch chunks, the second a resume, in
  processes of the entry point; the chunked run's ``metrics.jsonl`` and final weights equal an
  uninterrupted two-epoch run's;
* ``tools.finish_campaign`` scores the best step and the average of the best
  2 and exports them; ``tools.archive_campaign`` copies the record, and
  ``tools/campaign_report.py`` parses the archive;
* ``hostlock.wait_until_free`` keeps the JAX package's protocol: free, held
  until the holder lets go, held to the deadline, a dead holder;
* ``profiling.flops_estimate`` equals ``analytic_flops``, and JAX's estimate
  of a matmul.
"""

import contextlib
import io
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu import hostlock as jhostlock
from head_detector_tpu import profiling as jax_profiling
from head_detector_tpu_torch import hostlock, profiling
from head_detector_tpu_torch.detector import random_variables
from head_detector_tpu_torch.export import build_deploy
from head_detector_tpu_torch.models import get_arch
from head_detector_tpu_torch.tools import archive_campaign, finish_campaign, run_campaign
from head_detector_tpu_torch.train.__main__ import build_trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _overrides(root, name, per_run):
    return ["dataset_params.image_size=64", "dataset_params.batch_size=2",
            "dataset_params.num_workers=1", "architecture=yolo_heads_n",
            "training_hyperparams.max_epochs=2", f"training_hyperparams.epochs_per_run={per_run}",
            f"ckpt_root_dir={root}", f"experiment_name={name}"]


def test_campaign_chunks_finish_and_archive(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the chunks' processes: one thread each
    data, ckpts = str(tmp_path / "data"), str(tmp_path / "ckpt")
    common = dict(config_name="flagship_campaign", data_dir=data, train_count=8, val_count=2,
                  device="cpu", print_fn=lambda *a: None)
    chunked = run_campaign.run_campaign(log_dir=str(tmp_path / "logs"),
                                        overrides=_overrides(ckpts, "chunked", 1), **common)
    assert chunked["stopped"] == "complete"
    assert set(chunked["rendered"]) == {"train", "val"}
    assert chunked["rendered"]["train"]["scenes"] == 8
    assert [c["epochs"] for c in chunked["chunks"]] == [[0], [1]]
    assert all(c["rc"] == 0 for c in chunked["chunks"])
    with open(tmp_path / "logs" / "chunk_1.log") as f:
        assert "resumed from step 4" in f.read()

    # the same run uninterrupted, through the entry point's trainer in this process
    whole = build_trainer(["--config-name", "flagship_campaign", "--device", "cpu",
                           f"dataset_params.data_dir={data}", *_overrides(ckpts, "whole", 2)])
    whole.train()
    with open(os.path.join(chunked["ckpt_dir"], "metrics.jsonl")) as f:
        got = f.read()
    with open(os.path.join(whole.cfg.ckpt_dir, "metrics.jsonl")) as f:
        assert got == f.read()
    a = torch.load(os.path.join(chunked["ckpt_dir"], "8", "state.pt"), map_location="cpu")
    b = torch.load(os.path.join(whole.cfg.ckpt_dir, "8", "state.pt"), map_location="cpu")
    for key in ("params", "batch_stats", "ema_params"):
        for name, value in b[key].items():
            assert torch.equal(a[key][name], value), (key, name)

    out = str(tmp_path / "finish")
    done = finish_campaign.finish_campaign(chunked["ckpt_dir"], data, arch="yolo_heads_n",
                                           image_size=64, out=out, average_best=2, device="cpu")
    assert done["best_step"] in (4, 8)
    assert {"KeypointsNME", "KeypointsFailureRate"} <= set(done["best"])
    assert {"KeypointsNME", "KeypointsFailureRate"} <= set(done["average"])
    assert all(os.path.isfile(p) for p in done["exports"])
    with open(os.path.join(out, "eval_avg2.log")) as f:
        assert "averaging 2 best steps: [4, 8]" in f.read()

    logs = sorted(str(p) for p in (tmp_path / "logs").glob("chunk_*.log"))
    target = archive_campaign.archive_campaign(
        chunked["ckpt_dir"], name="smoke_r1", dest=str(tmp_path / "campaigns"),
        logs=logs + [os.path.join(out, "eval_best.log")], print_fn=lambda *a: None)
    assert sorted(os.listdir(target)) == ["best.json", "chunk_0.log", "chunk_1.log",
                                          "eval_best.log", "metrics.jsonl"]
    with open(os.path.join(target, "best.json")) as f:
        assert json.load(f)["step"] == done["best_step"]
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import campaign_report

    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        campaign_report.main(sorted(os.path.join(target, f) for f in os.listdir(target)
                                    if f.startswith("chunk_")))
    lines = report.getvalue().splitlines()
    assert lines[0] == "| Epoch | 0 | 1 |"
    assert lines[2].startswith("| KeypointsNME")
    assert any(line.startswith("best epoch:") for line in lines)


def test_run_campaign_stops_on_a_failed_chunk(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = run_campaign.run_campaign("flagship_campaign", str(tmp_path / "logs"),
                                    data_dir=str(tmp_path / "data"), train_count=2,
                                    val_count=1, device="cpu", print_fn=lambda *a: None,
                                    overrides=["dataset_params.image_size=64",
                                               "architecture=no_such_arch"])
    assert out["stopped"] == "failed" and len(out["chunks"]) == 1
    assert out["chunks"][0]["rc"] != 0


@pytest.fixture
def lock(tmp_path, monkeypatch):
    path = str(tmp_path / "campaign.lock")
    monkeypatch.setenv("HDT_CAMPAIGN_LOCK", path)
    monkeypatch.setattr(jhostlock, "LOCK_PATH", path)
    return path


def test_wait_until_free_matches_jax(lock):
    for module in (hostlock, jhostlock):
        assert module.wait_until_free(5.0, poll_s=0.01) is False  # free: no wait
    hostlock.acquire()
    for module in (hostlock, jhostlock):
        t0 = time.monotonic()
        assert module.wait_until_free(0.1, poll_s=0.02) is True  # held to the deadline
        assert time.monotonic() - t0 >= 0.1
    for module in (hostlock, jhostlock):
        hostlock.acquire()
        threading.Timer(0.1, os.unlink, (lock,)).start()  # the holder lets go
        assert module.wait_until_free(5.0, poll_s=0.02) is False
    for module in (hostlock, jhostlock):
        hostlock.acquire(pid=2**22 + 12345)  # a dead holder: stale
        assert module.wait_until_free(5.0, poll_s=0.01) is False
        assert not os.path.exists(lock)


def test_flops_estimate_matches_analytic_flops():
    variables = random_variables(get_arch("yolo_heads_n"), 64, "cpu")
    model, _ = build_deploy("yolo_heads_n", variables, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 64, 64).astype(np.float32))
    assert profiling.flops_estimate(model, x) == profiling.analytic_flops(model, x) > 0
    a = np.random.RandomState(1).rand(32, 48).astype(np.float32)
    b = np.random.RandomState(2).rand(48, 16).astype(np.float32)
    got = profiling.flops_estimate(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    want = jax_profiling.flops_estimate(jax.jit(jnp.matmul), jnp.asarray(a), jnp.asarray(b))
    assert got == want == 2 * 32 * 48 * 16
    assert profiling.flops_estimate(torch.relu, torch.from_numpy(a)) == 0.0
