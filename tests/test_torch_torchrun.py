"""The ``torchrun`` branch of the port's training entry point on the CPU.

``python -m torch.distributed.run ... -m head_detector_tpu_torch.train
--device cpu`` (gloo; ``distributed.init_from_env`` and ``train.__main__``'s
``RANK``/``WORLD_SIZE`` branch) trains yolo_heads_n at 64 px, global batch 4,
one epoch of two steps, as two ranks: one launcher with two processes, and
two launchers of one process each (``--nnodes 2``, both on 127.0.0.1, the
reachable stand-in for two hosts).  The checkpoint that rank 0 writes has the
state digest (parameters, BatchNorm statistics and EMA, bit for bit) of
``run_data_parallel`` on the same flags, which spawns its ranks itself.
"""

import hashlib
import os
import socket
import subprocess
import sys

import pytest
import torch

from head_detector_tpu_torch.train import __main__ as entry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(root, name):
    kw = {"architecture": "yolo_heads_n", "dataset_params.render": "true",
          "dataset_params.image_size": 64, "dataset_params.batch_size": 4,
          "dataset_params.train_length": 8, "dataset_params.val_length": 4,
          "dataset_params.max_heads": 2, "dataset_params.max_gt_boxes": 4,
          "dataset_params.num_workers": 1, "training_hyperparams.max_epochs": 1,
          "training_hyperparams.mixed_precision": "false",
          "ckpt_root_dir": root, "experiment_name": name, "log_every": 1}
    return ["--config-name", "yolo_heads_m", "--device", "cpu"] + [
        f"{k}={v}" for k, v in kw.items()]


def _digest(state: dict) -> str:
    """``train.__main__.state_digest`` of a saved ``TrainState``."""
    h = hashlib.sha256()
    for tree in (state["params"], state["batch_stats"], state["ema_params"]):
        for name in sorted(tree):
            h.update(name.encode())
            h.update(tree[name].reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spawned"))
    ranks = entry.run_data_parallel(_argv(root, "spawned"), 2, ["cpu", "cpu"])
    assert ranks[0][0]["digest"] == ranks[1][0]["digest"]
    return ranks[0][0]


@pytest.mark.parametrize("nodes", [1, 2])
def test_torchrun_matches_run_data_parallel(spawned, tmp_path, nodes):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    port = _free_port()
    launch = [sys.executable, "-m", "torch.distributed.run", "--master-addr", "127.0.0.1",
              "--master-port", str(port)]
    train = ["-m", "head_detector_tpu_torch.train", *_argv(str(tmp_path), "torchrun")]
    if nodes == 1:
        commands = [launch + ["--nproc-per-node", "2"] + train]
    else:
        commands = [launch + ["--nnodes", "2", "--node-rank", str(r), "--nproc-per-node", "1"]
                    + train for r in range(2)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in commands]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "[train] final metrics" in "".join(outs)  # rank 0 only prints its metrics
    state = torch.load(os.path.join(str(tmp_path), "torchrun", str(spawned["step"]),
                                    "state.pt"), map_location="cpu")
    assert state["step"] == spawned["step"] == 2
    assert _digest(state) == spawned["digest"]
