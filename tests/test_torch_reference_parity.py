"""The port's reference-parity runner on the CPU, and against the JAX tool.

``--self-test`` (a seeded random SuperGradients state saved as ``.pth``, the
port's ``.trcd`` exported from it, the chain verified on both) passes at
yolo_heads_n, 64 px.  The JAX tool's own self-test artifact (its torch twin
with its seeded random state, traced with SuperGradients names) is then fed
to the port's runner as the reference: the port converts its state dict,
holds every stage and the decoded outputs to it, and its decoded boxes and
posed vertices on the battery are within IoU 0.99 and relative vertex L2
1e-3 of what the JAX tool's flax model decodes from the same state.
"""

import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu.flame import FlameModel as JaxFlameModel
from head_detector_tpu.flame import reproject_spatial_vertices as jax_reproject
from head_detector_tpu.models import build_model as jax_build_model
from head_detector_tpu_torch.flame import FlameModel, reproject_spatial_vertices
from head_detector_tpu_torch.tools import verify_reference_parity as parity
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SIZE = "yolo_heads_n", 64


def _quiet(*_a, **_k):
    pass


def test_self_test_passes(tmp_path):
    out = tmp_path / "report.json"
    assert parity.main(["--self-test", "--arch", ARCH, "--size", str(SIZE), "--n-images", "2",
                        "--device", "cpu", "--json-out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["pass"]
    first, alone = report["pth_against_trcd"], report["trcd"]
    assert first["layout"] == "training" and alone["layout"] == "deploy"
    assert first["table_roundtrip"] == 0.0
    for r in (first, alone):
        assert set(r["stage_diffs"]) == set(parity.STAGES)
        assert max(r["stage_diffs"].values()) < parity.STAGE_TOL
        assert r["min_bbox_iou"] >= 0.99 and r["max_vertex_l2"] <= 1e-3
    assert max(alone["stage_diffs"].values()) == 0.0  # its own weights, its own graph


@pytest.fixture(scope="module")
def jax_artifact():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from verify_reference_parity import verify as jax_verify

    report = jax_verify(None, arch=ARCH, size=SIZE, n_images=2, self_test=True,
                        print_fn=_quiet)
    assert report["pass"]
    yield report["checkpoint"]
    shutil.rmtree(os.path.dirname(report["checkpoint"]), ignore_errors=True)


def test_port_holds_the_jax_tools_artifact(jax_artifact):
    report = parity.verify(jax_artifact, ARCH, SIZE, n_images=2, device="cpu", print_fn=_quiet)
    assert report["pass"], report
    assert report["layout"] == "training" and report["table_roundtrip"] == 0.0
    assert set(report["stage_diffs"]) == set(parity.STAGES)


def test_port_decodes_as_the_jax_tool(jax_artifact):
    from convert_torch_checkpoint import convert as jax_convert

    state = {k: v for k, v in torch.jit.load(jax_artifact, map_location="cpu")
             .state_dict().items()}
    jtree, _ = jax_convert(state)
    jmodel = jax_build_model(ARCH)
    jvars = {"params": jtree["params"], "batch_stats": jtree["batch_stats"]}
    tree, _ = parity.load_checkpoint(jax_artifact, "cpu")
    model = parity.build_port_model(ARCH, tree, "cpu")
    flame, jflame = FlameModel.from_assets(device="cpu"), JaxFlameModel.from_assets()
    for x in parity.battery(0, SIZE, 2):
        boxes, _, rows = parity.decode(model, x)
        decoded, _ = jmodel.apply(jvars, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
                                  train=False)
        jb = np.asarray(decoded.boxes_xyxy, np.float32)[0]
        js = np.asarray(decoded.scores, np.float32)[0, :, 0]
        jf = np.asarray(decoded.flame_params, np.float32)[0]
        sel = np.argsort(-js)[:parity.TOP_ANCHORS]
        assert parity.box_iou(boxes.numpy()[sel], jb[sel]).min() >= 0.99
        ours = reproject_spatial_vertices(flame, rows[sel], to_2d=False)[2].double().numpy()
        theirs = np.asarray(jax_reproject(jflame, jnp.asarray(jf[sel]), to_2d=False)[2],
                            np.float64)
        l2 = np.linalg.norm(ours - theirs, axis=-1).max() / max(1.0, np.abs(theirs).max())
        assert l2 <= 1e-3
