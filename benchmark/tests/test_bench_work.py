"""The work counts come from the configuration's shapes, whatever layout the
port serves."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import work
from benchmark.reference.pipeline import arch_from_dict

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def arch(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return arch_from_dict(json.load(f)["arch"])


def port_flops(net, size):
    x = torch.empty(1, 3, size, size, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net.to("meta")(x)
    return counter.get_total_flops()


@pytest.mark.parametrize("deploy", [True, False])
def test_bench_work_yolo_heads_m_count_same_in_either_port_layout(deploy):
    """The deploy forward's count of yolo_heads_m is the FLOPs of the port's
    fused network, and it reads the same whichever layout the port serves."""
    from head_detector_tpu_torch.models import build_model

    m = arch("yolo_heads_m")
    served = build_model("yolo_heads_m", deploy=deploy, skip_flame=True).eval()
    fused = build_model("yolo_heads_m", deploy=True, skip_flame=True).eval()
    count = work.deploy_forward_flops(m, 640)
    assert count == port_flops(fused, 640)
    assert count < port_flops(served, 640) or deploy
    assert count == pytest.approx(92.50167e9, rel=1e-6)


def test_bench_work_train_and_pncc_counts():
    m, big = arch("yolo_heads_m"), arch("yolo_heads_l")
    assert work.train_step_flops(big, 640) > 3 * work.deploy_forward_flops(big, 640)
    assert work.train_step_flops(m, 1280) == pytest.approx(4 * work.train_step_flops(m, 640),
                                                           rel=1e-6)
    assert work.pncc_render_bytes(2, 5023, 9000, 640, 480) == (
        2 * 5023 * 12 + 9000 * 12 + 5023 * 12 + 640 * 480 * 3)
