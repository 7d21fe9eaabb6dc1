"""The port's dependency-free ONNX exporter against the JAX package's on the
CPU: its bytes round-trip through its own reader and through the JAX
package's (``OnnxGraph.parse``), the JAX interpreter runs them to the port's
outputs, the graph is standard opset 13, and ``run_onnx(device="cpu")``
reproduces the eager port model and the JAX export of the same variables at
2e-4.  The int8, fp16 and pre-NMS top-k legs are held to the bars of
``tests/test_onnx_export.py``, the int8 weights to the port's (and JAX's)
``quantize_array`` bit for bit.

Inputs: yolo_heads_n at 64 px with the weights ``tests/test_onnx_export.py``
exports, the JAX mirror's torch default initialisation under
``torch.manual_seed(0)``, carried into a flax tree by the port's converter;
images from seeded ``RandomState``s.
"""

import copy

import numpy as np
import pytest
import torch

from head_detector_tpu import onnx_export as jax_onnx
from head_detector_tpu import quantization as jax_quantization
from head_detector_tpu.torch_mirror import build_torch_mirror, load_flax_variables
from head_detector_tpu_torch import onnx_export, quantization, torch_mirror
from head_detector_tpu_torch.tools.convert_torch_checkpoint import convert
from test_torch_export import ARCH, SIZE
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

OPSET_13 = {
    "Conv", "ConvTranspose", "BatchNormalization", "Relu", "MaxPool", "Concat", "Clip",
    "Pad", "Transpose", "Reshape", "Slice", "Softmax", "Sigmoid", "Tanh", "Exp", "Add",
    "Sub", "Mul", "Div", "MatMul", "Unsqueeze", "Cast", "DequantizeLinear", "TopK",
    "GatherND",
}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    torch.manual_seed(0)
    variables, _ = convert(build_torch_mirror(ARCH).state_dict())
    model = torch_mirror.decoded_outputs(ARCH, variables)
    path = str(tmp_path_factory.mktemp("onnx") / "n.onnx")
    graph = onnx_export.export_onnx(ARCH, image_size=(SIZE, SIZE), model=model, path=path)
    return variables, model, graph, path


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).rand(1, 3, SIZE, SIZE).astype(np.float32)


def _run(graph, x):
    return [o.numpy() for o in onnx_export.run_onnx(graph, {"image": x}, device="cpu")]


def test_serialization_round_trip(exported):
    _, _, graph, path = exported
    with open(path, "rb") as f:
        parsed = onnx_export.OnnxGraph.parse(f.read())
    assert [n["op"] for n in parsed.nodes] == [n["op"] for n in graph.nodes]
    for got, want in zip(parsed.nodes, graph.nodes):  # float attributes travel as float32
        assert got["attrs"] == {k: float(np.float32(v)) if isinstance(v, float) else v
                                for k, v in want["attrs"].items()}
    assert parsed.initializers.keys() == graph.initializers.keys()
    for k, v in graph.initializers.items():
        assert parsed.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(parsed.initializers[k], v)
    assert parsed.inputs == graph.inputs and parsed.outputs == graph.outputs


def test_jax_reader_and_interpreter_run_port_bytes(exported, image):
    _, _, graph, path = exported
    with open(path, "rb") as f:
        data = f.read()
    parsed = jax_onnx.OnnxGraph.parse(data)
    assert [n["op"] for n in parsed.nodes] == [n["op"] for n in graph.nodes]
    want = _run(graph, image)
    got = jax_onnx.run_onnx(parsed, {"image": image})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


def test_opset_13_ir_7(exported):
    _, _, graph, path = exported
    with open(path, "rb") as f:
        r = onnx_export._Reader(f.read())
    fields = {}
    while not r.eof():
        field, _, val = r.field()
        fields.setdefault(field, []).append(val)
    assert fields[1] == [7]  # ir_version
    (opset,) = fields[8]
    o = onnx_export._Reader(opset)
    entries = dict(o.field()[::2] for _ in range(2))
    assert entries == {1: b"", 2: 13}
    assert {n["op"] for n in graph.nodes} <= OPSET_13
    assert graph.inputs == [("image", [1, 3, SIZE, SIZE])]


def test_untranslated_op_raises():
    class Gelu(torch.nn.Module):
        def forward(self, x):
            return (torch.nn.functional.gelu(x),)

    with pytest.raises(NotImplementedError, match="aten::gelu"):
        onnx_export.export_onnx(ARCH, image_size=(32, 32), model=Gelu())


def test_run_onnx_matches_eager_and_jax_export(exported, image):
    variables, model, graph, _ = exported
    with torch.no_grad():
        eager = [o.numpy() for o in model(torch.from_numpy(image))]
    out = _run(graph, image)
    mirror = build_torch_mirror(ARCH)
    load_flax_variables(mirror, variables)
    mirror.eval()
    jax_graph = jax_onnx.export_onnx(ARCH, image_size=(SIZE, SIZE), mirror=mirror)
    jax_out = jax_onnx.run_onnx(jax_graph, {"image": image})
    assert len(out) == len(jax_out) == 3
    for o, e, j in zip(out, eager, jax_out):
        assert o.shape == e.shape == j.shape
        np.testing.assert_allclose(o, e, atol=2e-4)
        np.testing.assert_allclose(o, j, atol=2e-4)


def test_int8_leg(exported, image):
    variables, model, graph, _ = exported
    g8 = onnx_export.export_onnx(ARCH, image_size=(SIZE, SIZE), model=model, quantize="int8")
    dq = [n for n in g8.nodes if n["op"] == "DequantizeLinear"]
    assert len(dq) == sum(n["op"] == "Conv" for n in graph.nodes)
    assert all(graph.initializers[n["inputs"][1]].dtype == np.float32
               for n in graph.nodes if n["op"] == "ConvTranspose")

    # the weights: the port's quantize_array, and JAX's quantize_graph on the
    # port's plain graph gives the same initializers bit for bit
    for n in dq:
        w = graph.initializers[n["outputs"][0]]
        q, scale = quantization.quantize_array(w, axis=0)
        np.testing.assert_array_equal(g8.initializers[n["inputs"][0]], q)
        np.testing.assert_array_equal(g8.initializers[n["inputs"][1]], scale.reshape(-1))
        jq, jscale = jax_quantization.quantize_array(w, axis=0)
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(scale, jscale)
    jax_g8 = jax_onnx.OnnxGraph.parse(graph.serialize())
    jax_onnx.quantize_graph(jax_g8, "int8")
    assert jax_g8.initializers.keys() == g8.initializers.keys()
    for k, v in g8.initializers.items():
        np.testing.assert_array_equal(jax_g8.initializers[k], v)

    parsed = onnx_export.OnnxGraph.parse(g8.serialize())
    assert all(parsed.initializers[k].dtype == np.int8 for k in parsed.initializers
               if k.endswith("_q8"))
    ref, out = _run(graph, image), _run(parsed, image)
    folded = copy.deepcopy(parsed)  # DequantizeLinear folded by hand: the same outputs
    for n in [n for n in folded.nodes if n["op"] == "DequantizeLinear"]:
        q = folded.initializers[n["inputs"][0]].astype(np.float32)
        scale = folded.initializers[n["inputs"][1]].reshape([-1] + [1] * (q.ndim - 1))
        folded.initializers[n["outputs"][0]] = q * scale
        folded.nodes.remove(n)
    for a, b in zip(out, _run(folded, image)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ref[1], out[1], atol=5e-2)
    box_scale = max(float(np.max(np.abs(ref[0]))), 1.0)
    assert np.max(np.abs(ref[0] - out[0])) / box_scale < 5e-2


def test_fp16_leg(exported, image):
    _, model, graph, _ = exported
    g16 = onnx_export.export_onnx(ARCH, image_size=(SIZE, SIZE), model=model, quantize="fp16")
    parsed = onnx_export.OnnxGraph.parse(g16.serialize())
    halves = [k for k in parsed.initializers if k.endswith("_f16")]
    assert halves and all(parsed.initializers[k].dtype == np.float16 for k in halves)
    assert sum(n["op"] == "Cast" for n in parsed.nodes) == len(halves)
    np.testing.assert_allclose(_run(graph, image)[1], _run(parsed, image)[1], atol=1e-2)


def test_pre_nms_topk_leg(exported):
    _, model, graph, _ = exported
    k = 20
    g = onnx_export.export_onnx(ARCH, image_size=(SIZE, SIZE), model=model, pre_nms_top_k=k)
    parsed = onnx_export.OnnxGraph.parse(g.serialize())
    assert [n for n, _ in parsed.outputs] == ["pre_nms_boxes", "pre_nms_scores",
                                              "pre_nms_flame"]
    x = np.random.RandomState(1).rand(1, 3, SIZE, SIZE).astype(np.float32)
    dense, out = _run(graph, x), _run(parsed, x)
    scores = dense[1].reshape(dense[1].shape[0], -1)
    for b in range(scores.shape[0]):
        order = np.argsort(-scores[b], kind="stable")[:k]
        np.testing.assert_array_equal(out[0][b], dense[0][b][order])
        np.testing.assert_allclose(out[1][b].reshape(-1), scores[b][order])
        np.testing.assert_array_equal(out[2][b], dense[2][b][order])
    assert (np.diff(out[1].reshape(-1)) <= 0).all()


def test_attribute_negative_ints_round_trip():
    name, vals = onnx_export._parse_attribute(onnx_export._attribute("perm", [0, 2, -1, -2]))
    assert name == "perm" and vals == [0, 2, -1, -2]
    name, val = onnx_export._parse_attribute(onnx_export._attribute("axis", -3))
    assert name == "axis" and val == -3


def test_quantize_graph_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        onnx_export.quantize_graph(onnx_export.OnnxGraph(), mode="int4")
