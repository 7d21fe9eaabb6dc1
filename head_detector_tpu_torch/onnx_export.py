"""Dependency-free ONNX export of the port's detection graph.

Counterpart of ``head_detector_tpu/onnx_export.py``.  The reference's richest
export path is ONNX (``yolo_head_training/yolo_head/exportable_mesh_model.py:
29-504``: onnx + onnxsim + TensorRT / INT8 legs).  The ``onnx`` package is not
installed where this runs, and ``torch.onnx.export`` needs it, so this module
writes the protobuf itself:

1. **Graph capture**: ``torch.jit.trace`` of the port's own deploy model
   with dense FLAME towers (``torch_mirror.DecodedOutputs``: boxes, scores,
   globalised FLAME), then ``torch.jit.freeze`` without the passes that
   change numerics (so ``BatchNormalization`` stays a node, as in the
   model), then constant propagation, which folds every op on constants
   (the anchors are constants of the trace).  The shape arithmetic left
   (``aten::size``, ``NumToTensor``, ``Int``, ``mul``, ``rsub``, list
   construction) folds here, against the concrete evaluation of the
   translated graph on the example: the export is fixed-size, as the
   reference's ``heads.cache_anchors`` makes its export.
2. **Translation**: the frozen graph of the port holds ``aten::_convolution``
   (``Conv``, or ``ConvTranspose`` for the neck's 2x2/s2 upsamples),
   ``batch_norm`` (``BatchNormalization``), ``relu``, ``tanh``,
   ``sigmoid``, ``exp``, ``max_pool2d`` (``MaxPool``), ``cat``
   (``Concat``), ``add`` / ``sub`` / ``mul`` / ``div``, ``clamp``
   (``Clip``), ``pad`` (``Pad``), ``permute`` (``Transpose``), ``reshape``,
   ``slice``, ``softmax``, ``unsqueeze``, ``einsum('bakm,m->bak')`` (the DFL
   expectation, ``MatMul`` + ``Reshape``) and ``to`` (the identity between
   float32 tensors, else ``Cast``): each maps onto an ONNX opset-13 op, and
   any other op raises.
3. **Serialization**: a hand-rolled protobuf writer emits a ``ModelProto``
   (ir_version 7, opset 13); the matching reader parses it back.
4. **Verification**: :func:`run_onnx` executes a graph with torch
   functional ops on a torch device (the card by default).
5. **Quantized legs** (``quantize='int8'|'fp16'``, :func:`quantize_graph`):
   per-channel int8 weight initializers + ``DequantizeLinear``, or float16
   initializers + ``Cast``; :func:`attach_pre_nms_topk` appends the
   reference's ``VGGHeadDecodingModule`` (``TopK`` + ``GatherND``).
   TensorRT engines stay out of scope, as in the JAX package.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from head_detector_tpu_torch.device import resolve_device
from head_detector_tpu_torch.quantization import quantize_array

# --------------------------------------------------------------------------- #
# Minimal protobuf wire-format writer / reader
# --------------------------------------------------------------------------- #


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _str_field(field: int, value: str) -> bytes:
    return _len_delim(field, value.encode())


class _Reader:
    """Just enough protobuf parsing to round-trip our own ModelProto."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def varint(self) -> int:
        shift = n = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    def field(self) -> Tuple[int, int, Any]:
        k = self.varint()
        field, wire = k >> 3, k & 7
        if wire == 0:
            return field, wire, self.varint()
        if wire == 2:
            ln = self.varint()
            payload = self.data[self.pos : self.pos + ln]
            self.pos += ln
            return field, wire, payload
        if wire == 5:
            v = struct.unpack("<f", self.data[self.pos : self.pos + 4])[0]
            self.pos += 4
            return field, wire, v
        raise ValueError(f"unsupported wire type {wire}")


# ONNX TensorProto data types
_DT_FLOAT, _DT_INT64, _DT_INT32, _DT_BOOL = 1, 7, 6, 9
_DT_INT8, _DT_FLOAT16 = 3, 10
_NP_TO_DT = {
    np.dtype(np.float32): _DT_FLOAT,
    np.dtype(np.int64): _DT_INT64,
    np.dtype(np.int32): _DT_INT32,
    np.dtype(np.bool_): _DT_BOOL,
    np.dtype(np.int8): _DT_INT8,
    np.dtype(np.float16): _DT_FLOAT16,
}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b"".join(_int_field(1, int(d)) for d in arr.shape)
    out += _int_field(2, _NP_TO_DT[arr.dtype])
    out += _str_field(8, name)
    out += _len_delim(9, arr.tobytes())
    return out


def _parse_tensor(payload: bytes) -> Tuple[str, np.ndarray]:
    r = _Reader(payload)
    dims: List[int] = []
    dtype = _DT_FLOAT
    name = ""
    raw = b""
    while not r.eof():
        field, wire, val = r.field()
        if field == 1:
            dims.append(val)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    arr = np.frombuffer(raw, dtype=_DT_TO_NP[dtype]).reshape(dims)
    return name, arr


_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_INTS = 1, 2, 3, 7


def _attribute(name: str, value) -> bytes:
    out = _str_field(1, name)
    if isinstance(value, str):
        out += _len_delim(4, value.encode()) + _int_field(20, _ATTR_STRING)
    elif isinstance(value, float):
        out += _key(2, 5) + struct.pack("<f", value) + _int_field(20, _ATTR_FLOAT)
    elif isinstance(value, (list, tuple)):
        out += b"".join(_int_field(8, int(v)) for v in value)
        out += _int_field(20, _ATTR_INTS)
    elif isinstance(value, (int, np.integer)):
        out += _int_field(3, int(value)) + _int_field(20, _ATTR_INT)
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return out


def _parse_attribute(payload: bytes):
    r = _Reader(payload)
    name, atype = "", None
    ints: List[int] = []
    sval = fval = ival = None
    while not r.eof():
        field, wire, val = r.field()
        if field == 1:
            name = val.decode()
        elif field == 2:
            fval = val
        elif field == 3:
            ival = val
        elif field == 4:
            sval = val.decode()
        elif field == 8:
            ints.append(val)
        elif field == 20:
            atype = val
    if atype == _ATTR_INTS:
        # same unsigned-varint sign correction as the single-INT case
        return name, [v - (1 << 64) if v >= (1 << 63) else v for v in ints]
    if atype == _ATTR_INT:
        # varints are unsigned on the wire; ONNX ints are int64
        return name, ival - (1 << 64) if ival >= (1 << 63) else ival
    if atype == _ATTR_FLOAT:
        return name, fval
    if atype == _ATTR_STRING:
        return name, sval
    return name, ints or ival or fval or sval


def _node_proto(node: Dict) -> bytes:
    out = b"".join(_str_field(1, i) for i in node["inputs"])
    out += b"".join(_str_field(2, o) for o in node["outputs"])
    out += _str_field(4, node["op"])
    for k, v in node.get("attrs", {}).items():
        out += _len_delim(5, _attribute(k, v))
    return out


def _parse_node(payload: bytes) -> Dict:
    r = _Reader(payload)
    node = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
    while not r.eof():
        field, wire, val = r.field()
        if field == 1:
            node["inputs"].append(val.decode())
        elif field == 2:
            node["outputs"].append(val.decode())
        elif field == 4:
            node["op"] = val.decode()
        elif field == 5:
            k, v = _parse_attribute(val)
            node["attrs"][k] = v
    return node


def _value_info(name: str, shape: Sequence[int]) -> bytes:
    dims = b"".join(_len_delim(1, _int_field(1, int(d))) for d in shape)
    tshape = _len_delim(2, dims)
    ttype = _len_delim(1, _int_field(1, _DT_FLOAT) + tshape)
    return _str_field(1, name) + _len_delim(2, ttype)


def _parse_value_info(payload: bytes) -> Tuple[str, List[int]]:
    r = _Reader(payload)
    name, shape = "", []
    while not r.eof():
        field, wire, val = r.field()
        if field == 1:
            name = val.decode()
        elif field == 2:
            rt = _Reader(val)
            while not rt.eof():
                f2, w2, v2 = rt.field()
                if f2 == 1:  # tensor_type
                    rtt = _Reader(v2)
                    while not rtt.eof():
                        f3, w3, v3 = rtt.field()
                        if f3 == 2:  # shape
                            rs = _Reader(v3)
                            while not rs.eof():
                                f4, w4, v4 = rs.field()
                                if f4 == 1:
                                    rd = _Reader(v4)
                                    while not rd.eof():
                                        f5, w5, v5 = rd.field()
                                        if f5 == 1:
                                            shape.append(v5)
    return name, shape


class OnnxGraph:
    """In-memory representation: nodes + initializers + graph IO."""

    def __init__(self):
        self.nodes: List[Dict] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[Tuple[str, List[int]]] = []
        self.outputs: List[Tuple[str, List[int]]] = []
        self.name = "head_detector_tpu_torch"

    def serialize(self) -> bytes:
        g = b"".join(_len_delim(1, _node_proto(n)) for n in self.nodes)
        g += _str_field(2, self.name)
        g += b"".join(
            _len_delim(5, _tensor_proto(k, v)) for k, v in self.initializers.items()
        )
        g += b"".join(_len_delim(11, _value_info(n, s)) for n, s in self.inputs)
        g += b"".join(_len_delim(12, _value_info(n, s)) for n, s in self.outputs)

        model = _int_field(1, 7)  # ir_version 7
        model += _str_field(2, "head_detector_tpu_torch")
        model += _str_field(3, "0.1")
        model += _len_delim(8, _str_field(1, "") + _int_field(2, 13))  # opset 13
        model += _len_delim(7, g)
        return model

    @classmethod
    def parse(cls, data: bytes) -> "OnnxGraph":
        out = cls()
        r = _Reader(data)
        graph_payload = None
        while not r.eof():
            field, wire, val = r.field()
            if field == 7:
                graph_payload = val
        if graph_payload is None:
            raise ValueError("no GraphProto in model")
        rg = _Reader(graph_payload)
        while not rg.eof():
            field, wire, val = rg.field()
            if field == 1:
                out.nodes.append(_parse_node(val))
            elif field == 2:
                out.name = val.decode()
            elif field == 5:
                k, v = _parse_tensor(val)
                out.initializers[k] = v
            elif field == 11:
                out.inputs.append(_parse_value_info(val))
            elif field == 12:
                out.outputs.append(_parse_value_info(val))
        return out




def quantize_graph(graph: "OnnxGraph", mode: str = "int8") -> int:
    """Post-pass: convert Conv weight initializers to the requested
    quantized storage — the reference's export ``quantization_mode``
    (``exportable_mesh_model.py:175-184``) re-done as standard portable
    ONNX instead of a TensorRT engine:

    * ``int8``: per-output-channel symmetric int8 initializer +
      ``DequantizeLinear`` (weight-QDQ form; axis 0 = OIHW out channels).
    * ``fp16``: float16 initializer + ``Cast`` back to float.

    Inserted nodes are prepended (their inputs are initializers only, so
    topological order is preserved).  Returns the number of weights
    converted.  ConvTranspose weights are left in f32: their ONNX layout
    puts output channels on axis 1 of a grouped tensor — the reference's
    selective quantizer exempts odd layouts the same way."""
    if mode not in ("int8", "fp16"):
        raise ValueError(f"unknown quantize mode {mode!r}")
    new_nodes: List[Dict] = []
    count = 0
    for node in graph.nodes:
        if node["op"] != "Conv":
            continue
        wname = node["inputs"][1]
        w = graph.initializers.get(wname)
        if w is None or w.dtype != np.float32:
            continue
        count += 1
        if mode == "fp16":
            graph.initializers[wname + "_f16"] = w.astype(np.float16)
            del graph.initializers[wname]
            new_nodes.append({
                "op": "Cast", "inputs": [wname + "_f16"],
                "outputs": [wname], "attrs": {"to": _DT_FLOAT},
            })
        elif mode == "int8":
            q, scale = quantize_array(w, axis=0)
            graph.initializers[wname + "_q8"] = q
            graph.initializers[wname + "_scale"] = (
                scale.reshape(-1).astype(np.float32)
            )
            del graph.initializers[wname]
            new_nodes.append({
                "op": "DequantizeLinear",
                "inputs": [wname + "_q8", wname + "_scale"],
                "outputs": [wname], "attrs": {"axis": 0},
            })
        else:
            raise ValueError(f"unknown quantize mode {mode!r}")
    graph.nodes[:0] = new_nodes
    return count


def attach_pre_nms_topk(graph: "OnnxGraph", k: int) -> None:
    """Append the reference's export decoding module to the graph.

    Functional spec ``yolo_head_training/yolo_head/yolo_heads.py:47-86``
    (``VGGHeadDecodingModule``): select the top-``k`` anchors per image by
    score and gather boxes/scores/flame at those indices, so the artifact
    emits pre-NMS candidate sets ``[B, k, *]`` — the reference's actual
    exported ONNX surface.  (Its ``attach_onnx_pose_nms`` stitching is dead
    code: ``attach_nms_postprocessing`` is False on every branch of
    ``exportable_mesh_model.py:342-390``; ``postprocessing=True`` exports
    the top-k decoding module only.)

    Appends ``TopK`` + ``GatherND(batch_dims=1)`` nodes and REPLACES the
    graph outputs with ``pre_nms_boxes/pre_nms_scores/pre_nms_flame``.
    """
    (bname, bshape), (sname, sshape), (fname, fshape) = graph.outputs
    num_anchors = int(sshape[1])
    k = int(min(k, num_anchors))
    graph.initializers["pre_nms_k"] = np.asarray([k], np.int64)

    score_2d = sname
    if len(sshape) == 3:  # [B, A, 1] -> [B, A] for TopK over anchors
        graph.initializers["pre_nms_shape2d"] = np.asarray(
            [int(sshape[0]), num_anchors], np.int64
        )
        graph.nodes.append({
            "op": "Reshape", "inputs": [sname, "pre_nms_shape2d"],
            "outputs": ["pre_nms_scores2d"], "attrs": {},
        })
        score_2d = "pre_nms_scores2d"
    graph.nodes.append({
        "op": "TopK", "inputs": [score_2d, "pre_nms_k"],
        "outputs": ["pre_nms_scores_topk", "pre_nms_idx"],
        "attrs": {"axis": 1, "largest": 1, "sorted": 1},
    })
    graph.initializers["pre_nms_unsq_axes"] = np.asarray([2], np.int64)
    graph.nodes.append({
        "op": "Unsqueeze", "inputs": ["pre_nms_idx", "pre_nms_unsq_axes"],
        "outputs": ["pre_nms_idx3"], "attrs": {},
    })
    new_outputs = []
    for src, shape, out in (
        (bname, bshape, "pre_nms_boxes"),
        (sname, sshape, "pre_nms_scores"),
        (fname, fshape, "pre_nms_flame"),
    ):
        if out == "pre_nms_scores" and len(sshape) == 2:
            # [B, A] scores: the sorted TopK values ARE the gathered scores
            new_outputs.append(("pre_nms_scores_topk", [int(shape[0]), k]))
            continue
        graph.nodes.append({
            "op": "GatherND", "inputs": [src, "pre_nms_idx3"],
            "outputs": [out], "attrs": {"batch_dims": 1},
        })
        new_outputs.append((out, [int(shape[0]), k] + [int(d) for d in shape[2:]]))
    graph.outputs = new_outputs



# --------------------------------------------------------------------------- #
# torch JIT graph -> OnnxGraph translation
# --------------------------------------------------------------------------- #

# torch ScalarType enum -> dtype, as JIT graphs carry them
_SCALAR_TYPES = {0: torch.uint8, 1: torch.int8, 2: torch.int16, 3: torch.int32,
                 4: torch.int64, 5: torch.float16, 6: torch.float32, 7: torch.float64,
                 11: torch.bool, 15: torch.bfloat16}
_TORCH_TO_DT = {torch.float32: _DT_FLOAT, torch.float16: _DT_FLOAT16, torch.int64: _DT_INT64,
                torch.int32: _DT_INT32, torch.int8: _DT_INT8, torch.bool: _DT_BOOL}
_DT_TO_TORCH = {v: k for k, v in _TORCH_TO_DT.items()}
_BINARY = {"aten::add": "Add", "aten::sub": "Sub", "aten::mul": "Mul", "aten::div": "Div"}
_UNARY = {"aten::relu": "Relu", "aten::tanh": "Tanh", "aten::sigmoid": "Sigmoid",
          "aten::exp": "Exp"}


def _const_value(node) -> Any:
    """Value of a prim::Constant node (tensor / scalar / list / str / None)."""
    if node.output().type().kind() == "NoneType" or not node.attributeNames():
        return None
    return getattr(node, node.kindOf("value"))("value")


def _slice_t(x, dim, start, end, step):
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, end if end is not None and end < 2**62 else None, step)
    return x[tuple(idx)]


# shape arithmetic left after constant propagation: sizes of runtime tensors
# (aten::size, resolved from the concrete evaluation) turned into tensors and back
_FOLD = {
    "aten::mul": lambda a, b: torch.mul(torch.as_tensor(a), torch.as_tensor(b)),
    "aten::rsub": lambda a, b, alpha=1: torch.sub(torch.as_tensor(b), torch.as_tensor(a),
                                                  alpha=alpha),
    "aten::Int": lambda x: int(x),
    "prim::NumToTensor": lambda x: torch.tensor(x),
}


def export_onnx(
    model_name,
    variables: Optional[dict] = None,
    image_size: Tuple[int, int] = (640, 640),
    path: Optional[str] = None,
    model=None,
    quantize: Optional[str] = None,
    pre_nms_top_k: Optional[int] = None,
) -> OnnxGraph:
    """Export the port's detection graph as ONNX.

    :param variables: flax tree (training or deploy layout) to load; None
        gives ``detector.random_variables`` at ``image_size``
    :param model: a prebuilt ``torch_mirror.DecodedOutputs`` (overrides
        ``model_name`` / ``variables``)
    :param quantize: None | 'int8' | 'fp16' (:func:`quantize_graph`)
    :param pre_nms_top_k: append :func:`attach_pre_nms_topk` with this k
    :return: the in-memory OnnxGraph (also written to ``path`` if given)

    The graph is traced and evaluated on the CPU at batch 1."""
    from head_detector_tpu_torch.torch_mirror import decoded_outputs, trace_decoded

    if model is None:
        if variables is None:
            from head_detector_tpu_torch.detector import random_variables
            from head_detector_tpu_torch.models import get_arch

            variables = random_variables(get_arch(model_name), image_size[0], "cpu")
        model = decoded_outputs(model_name, variables)
    frozen = torch.jit.freeze(trace_decoded(model.eval(), image_size),
                              optimize_numerics=False)
    graph = frozen.graph
    torch._C._jit_pass_constant_propagation(graph)
    torch._C._jit_pass_dce(graph)

    og = OnnxGraph()
    env: Dict = {}  # torch Value -> ("const", obj) | ("rt", onnx name) | ("rt_list", values)
    concrete: Dict[str, torch.Tensor] = {}
    counter = [0]

    def fresh(prefix: str) -> str:
        counter[0] += 1
        return f"{prefix}_{counter[0]}"

    def add_init(arr, prefix="const") -> str:
        a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        if a.dtype not in _NP_TO_DT:
            a = a.astype(np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32)
        name = fresh(prefix)
        og.initializers[name] = a
        return name

    def is_const(value) -> bool:
        return env[value][0] == "const"

    def const_of(value):
        tag, obj = env[value]
        if tag != "const":
            raise ValueError(f"expected a constant, got a runtime value {value}")
        return obj

    def as_rt(value) -> str:
        tag, obj = env[value]
        if tag == "rt":
            return obj
        name = add_init(torch.as_tensor(obj, dtype=torch.float32)
                        if not isinstance(obj, torch.Tensor) else obj)
        env[value] = ("rt", name)
        return name

    def emit(op: str, inputs: List[str], n_out: int = 1, attrs: Dict = None) -> List[str]:
        """Append a node and run it at once on the example (shapes for
        ``aten::size`` come from there, and every translated op is checked
        the moment it is made)."""
        outs = [fresh(op.lower()) for _ in range(n_out)]
        node = {"op": op, "inputs": inputs, "outputs": outs, "attrs": attrs or {}}
        og.nodes.append(node)
        for name in inputs:
            if name and name not in concrete:
                concrete[name] = torch.from_numpy(np.array(og.initializers[name]))
        _exec_node(node, concrete)
        return outs

    inputs = [v for v in graph.inputs() if "self" not in v.debugName()]
    if len(inputs) != 1:
        raise ValueError(f"expected one graph input, got {[v.debugName() for v in inputs]}")
    env[inputs[0]] = ("rt", "image")
    og.inputs.append(("image", [1, 3, image_size[0], image_size[1]]))
    concrete["image"] = torch.rand(1, 3, image_size[0], image_size[1])

    def fold(kind: str, node) -> bool:
        """Evaluate a node whose inputs are all constants."""
        ins = list(node.inputs())
        if not all(is_const(v) for v in ins):
            return False
        vals = [const_of(v) for v in ins]
        if kind == "prim::ListConstruct":
            env[node.output()] = ("const", vals)
        elif kind in _FOLD:
            env[node.output()] = ("const", _FOLD[kind](*vals))
        else:
            return False
        return True

    for node in graph.nodes():
        kind = node.kind()
        ins = list(node.inputs())
        if kind == "prim::Constant":
            env[node.output()] = ("const", _const_value(node))
            continue
        if kind == "aten::size":
            sizes = list(concrete[as_rt(ins[0])].shape)
            env[node.output()] = ("const", sizes if len(ins) == 1 else sizes[const_of(ins[1])])
            continue
        if fold(kind, node):
            continue
        if kind == "prim::ListConstruct":  # a list of runtime tensors (Concat inputs)
            env[node.output()] = ("rt_list", ins)
            continue
        if kind == "prim::TupleConstruct":
            for v in ins:
                name = as_rt(v)
                og.outputs.append((name, list(concrete[name].shape)))
            continue

        if kind == "aten::_convolution":
            stride, padding, dilation = (const_of(v) for v in ins[3:6])
            attrs = {"strides": stride, "dilations": dilation, "group": const_of(ins[8]),
                     "pads": list(padding) + list(padding)}
            conv_in = [as_rt(ins[0]), add_init(const_of(ins[1]), "weight")]
            if const_of(ins[2]) is not None:
                conv_in.append(add_init(const_of(ins[2]), "bias"))
            if const_of(ins[6]):  # the neck's ConvTranspose2d(2, 2) upsamples
                attrs["output_padding"] = const_of(ins[7])
                (o,) = emit("ConvTranspose", conv_in, attrs=attrs)
            else:
                (o,) = emit("Conv", conv_in, attrs=attrs)
        elif kind == "aten::batch_norm":
            names = [as_rt(ins[0])] + [add_init(const_of(v), "bn") for v in ins[1:5]]
            (o,) = emit("BatchNormalization", names, attrs={"epsilon": float(const_of(ins[7]))})
        elif kind in _UNARY:
            (o,) = emit(_UNARY[kind], [as_rt(ins[0])])
        elif kind == "aten::to":
            dtype = next(_SCALAR_TYPES[const_of(v)] for v in ins[1:]
                         if is_const(v) and isinstance(const_of(v), int))
            x = as_rt(ins[0])
            if concrete[x].dtype == dtype:
                env[node.output()] = ("rt", x)
                continue
            (o,) = emit("Cast", [x], attrs={"to": _TORCH_TO_DT[dtype]})
        elif kind == "aten::max_pool2d":
            k, stride, padding, dilation, ceil_mode = (const_of(v) for v in ins[1:6])
            if ceil_mode or any(d != 1 for d in dilation):
                raise NotImplementedError("max_pool2d with dilation or ceil_mode")
            (o,) = emit("MaxPool", [as_rt(ins[0])], attrs={
                "kernel_shape": k, "strides": stride or k, "pads": list(padding) * 2})
        elif kind == "aten::cat":
            tag, lst = env[ins[0]]
            names = [as_rt(v) for v in lst] if tag == "rt_list" else [add_init(v) for v in lst]
            (o,) = emit("Concat", names, attrs={"axis": const_of(ins[1])})
        elif kind in _BINARY:
            if len(ins) > 2 and const_of(ins[2]) not in (1, 1.0, None):
                raise NotImplementedError(f"{kind} with alpha / rounding {const_of(ins[2])}")
            (o,) = emit(_BINARY[kind], [as_rt(ins[0]), as_rt(ins[1])])
        elif kind == "aten::clamp":
            lo, hi = const_of(ins[1]), const_of(ins[2])
            names = [as_rt(ins[0]), add_init(np.float32(lo)) if lo is not None else ""]
            if hi is not None:
                names.append(add_init(np.float32(hi)))
            (o,) = emit("Clip", names)
        elif kind == "aten::pad":
            x = as_rt(ins[0])
            tpad = list(const_of(ins[1]))  # last dim first, in pairs
            mode = const_of(ins[2]) or "constant"
            rank = concrete[x].dim()
            begins, ends = [0] * rank, [0] * rank
            for i in range(len(tpad) // 2):
                begins[rank - 1 - i], ends[rank - 1 - i] = tpad[2 * i], tpad[2 * i + 1]
            (o,) = emit("Pad", [x, add_init(np.asarray(begins + ends, np.int64)),
                                add_init(np.float32(const_of(ins[3]) or 0.0))],
                        attrs={"mode": mode})
        elif kind == "aten::permute":
            (o,) = emit("Transpose", [as_rt(ins[0])], attrs={"perm": const_of(ins[1])})
        elif kind == "aten::reshape":
            (o,) = emit("Reshape", [as_rt(ins[0]),
                                    add_init(np.asarray(const_of(ins[1]), np.int64))])
        elif kind == "aten::softmax":
            (o,) = emit("Softmax", [as_rt(ins[0])], attrs={"axis": const_of(ins[1])})
        elif kind == "aten::unsqueeze":
            (o,) = emit("Unsqueeze", [as_rt(ins[0]),
                                      add_init(np.asarray([const_of(ins[1])], np.int64))])
        elif kind == "aten::slice":
            end = const_of(ins[3])
            bounds = (const_of(ins[2]) or 0, min(end if end is not None else 2**62, 2**62),
                      const_of(ins[1]), const_of(ins[4]))
            (o,) = emit("Slice", [as_rt(ins[0])] + [add_init(np.asarray([b], np.int64))
                                                     for b in bounds])
        elif kind == "aten::einsum":
            eq = const_of(ins[0]).replace(" ", "")
            if eq != "bakm,m->bak":
                raise NotImplementedError(f"einsum {eq}")
            x, proj = env[ins[1]][1]
            (mm,) = emit("MatMul", [as_rt(x), add_init(const_of(proj).reshape(-1, 1), "dfl")])
            shape = add_init(np.asarray(concrete[mm].shape[:-1], np.int64))
            (o,) = emit("Reshape", [mm, shape])
        else:
            raise NotImplementedError(f"untranslated op {kind}: {node}")
        env[node.output()] = ("rt", o)

    if pre_nms_top_k:
        attach_pre_nms_topk(og, pre_nms_top_k)
    if quantize:
        quantize_graph(og, mode=quantize)
    if path:
        with open(path, "wb") as f:
            f.write(og.serialize())
    return og


# --------------------------------------------------------------------------- #
# Interpreter (verification harness, not a runtime)
# --------------------------------------------------------------------------- #


def run_onnx(graph: OnnxGraph, feeds: Dict[str, Any], device="cuda") -> List[torch.Tensor]:
    """Run ``graph`` on ``feeds`` (numpy arrays or tensors) with torch
    functional ops on ``device``; returns the outputs as tensors there."""
    dev = resolve_device(device)
    vals: Dict[str, torch.Tensor] = {
        k: torch.from_numpy(np.array(v)).to(dev) for k, v in graph.initializers.items()}
    vals.update({k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                 .to(dev) for k, v in feeds.items()})
    for node in graph.nodes:
        _exec_node(node, vals)
    return [vals[name] for name, _ in graph.outputs]


def _ints(t: torch.Tensor) -> List[int]:
    return [int(v) for v in t.reshape(-1).tolist()]


def _exec_node(node: Dict, vals: Dict[str, torch.Tensor]) -> None:
    """Run one node on the tensors of ``vals`` (on their device)."""
    op, ins, outs = node["op"], node["inputs"], node["outputs"]
    attrs = node.get("attrs", {})

    def t(i):
        return vals[ins[i]] if i < len(ins) and ins[i] else None

    if op in ("Conv", "ConvTranspose"):
        pads = attrs.get("pads", [0, 0, 0, 0])
        if pads[:2] != pads[2:]:
            raise NotImplementedError(f"{op} with asymmetric pads {pads}")
        kw = dict(stride=attrs.get("strides", [1, 1]), padding=pads[:2],
                  dilation=attrs.get("dilations", [1, 1]), groups=attrs.get("group", 1))
        if op == "Conv":
            y = F.conv2d(t(0), t(1), t(2), **kw)
        else:
            y = F.conv_transpose2d(t(0), t(1), t(2),
                                   output_padding=attrs.get("output_padding", [0, 0]), **kw)
    elif op == "BatchNormalization":
        y = F.batch_norm(t(0), t(3), t(4), t(1), t(2), training=False,
                         eps=attrs.get("epsilon", 1e-5))
    elif op == "Relu":
        y = torch.relu(t(0))
    elif op == "Tanh":
        y = torch.tanh(t(0))
    elif op == "Sigmoid":
        y = torch.sigmoid(t(0))
    elif op == "Exp":
        y = torch.exp(t(0))
    elif op == "MaxPool":
        pads = attrs.get("pads", [0, 0, 0, 0])
        y = F.max_pool2d(t(0), attrs["kernel_shape"], stride=attrs.get("strides"),
                         padding=pads[:2])
    elif op == "Concat":
        y = torch.cat([vals[i] for i in ins], dim=attrs["axis"])
    elif op in ("Add", "Sub", "Mul", "Div"):
        fn = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": torch.div}[op]
        y = fn(t(0), t(1))
    elif op == "Clip":
        lo, hi = t(1), t(2)
        y = torch.clamp(t(0), None if lo is None else lo.item(),
                        None if hi is None else hi.item())
    elif op == "Pad":
        pads = _ints(t(1))
        rank = len(pads) // 2
        tpad = []
        for i in range(rank - 1, -1, -1):
            tpad += [pads[i], pads[i + rank]]
        y = F.pad(t(0), tpad, mode=attrs.get("mode", "constant"),
                  value=float(t(2).item()) if t(2) is not None else 0.0)
    elif op == "Transpose":
        y = t(0).permute(attrs["perm"])
    elif op == "Reshape":
        y = t(0).reshape(_ints(t(1)))
    elif op == "Softmax":
        y = torch.softmax(t(0), dim=attrs["axis"])
    elif op == "Unsqueeze":
        y = t(0).unsqueeze(_ints(t(1))[0])
    elif op == "Slice":
        (start,), (end,), (dim,), (step,) = (_ints(t(i)) for i in range(1, 5))
        y = _slice_t(t(0), dim, start, end, step)
    elif op == "MatMul":
        y = torch.matmul(t(0), t(1))
    elif op == "DequantizeLinear":
        q, scale = t(0).to(torch.float32), t(1).to(torch.float32)
        if scale.dim() == 1 and q.dim() > 1:
            shape = [1] * q.dim()
            shape[attrs.get("axis", 1)] = scale.shape[0]
            scale = scale.reshape(shape)
        zp = t(2).to(torch.float32) if t(2) is not None else 0.0
        y = (q - zp) * scale
    elif op == "Cast":
        y = t(0).to(_DT_TO_TORCH[attrs["to"]])
    elif op == "TopK":
        (k,) = _ints(t(1))
        v, idx = torch.topk(t(0), k, dim=attrs.get("axis", -1),
                            largest=bool(attrs.get("largest", 1)),
                            sorted=bool(attrs.get("sorted", 1)))
        vals[outs[0]], vals[outs[1]] = v, idx.to(torch.int64)
        return
    elif op == "GatherND":
        data, idx = t(0), t(1)
        if int(attrs.get("batch_dims", 0)) != 1 or idx.shape[-1] != 1:
            raise NotImplementedError(f"GatherND {attrs} with index depth {idx.shape[-1]}")
        rows = torch.arange(data.shape[0], device=data.device)[:, None]
        y = data[rows, idx[..., 0]]
    else:
        raise NotImplementedError(f"interpreter op {op}")
    vals[outs[0]] = y
