"""TensorFlow interop: import and export frozen GraphDefs, and train
an imported graph.

Counterpart of ``bigdl_tpu/utils/tf_interop.py``: the ``GraphDef`` codec
(``_decode_tensor``/``_encode_tensor`` :115-191, ``_Attr``/``_NodeDef``/
``parse_graphdef`` :193-297), ``TensorflowLoader`` (:306-1511: the op
converters, the constant folding of shape-arithmetic subgraphs
:413-530, the NHWC -> NCHW axis mapping :550-592, Switch/Merge
conditionals and while frames :594-676, Dequantize folded in weight
position), the input-pipeline lift (``extract_input_pipeline``,
``TFInputPipeline``, ``model_outputs``, :1515-1711), ``load_tf``,
``TFTrainingSession``/``BigDLSessionImpl`` (:1713-1805) over the
port's ``LocalOptimizer`` and ``DistriOptimizer``, ``GraphDefBuilder``
(:1812-1920) and ``TensorflowSaver`` (:1922-2069).

No TF and no protobuf runtime: the protos go through the port's wire
reader and writer (``utils/caffe.py``).  For the same weights the
saver writes the JAX package's bytes (node names come from the class
names, which the packages share), and each package's loader reads the
other's graphs.  ``TensorflowLoader(..., device=)`` builds every
module on the device (the card unless the caller asks for the CPU) and
copies each weight there as an f32 tensor (``utils/caffe.py``'s
``_assign``).  A graph
with a while frame becomes a ``DynamicGraph`` (the masked do-while
loop of ``nn/graph.py``, ``loop_max_iterations`` iterations at most,
trip count >= 1); one without becomes a ``Graph``, its conditionals
run by select semantics (``nn/control_ops.py``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.utils.caffe import (_assign, _read_varint, _varint,
                                         _WireWriter, _w_int, _w_ints,
                                         _w_msgs, _w_str, _w_strs,
                                         parse_wire)

# tf DataType enum values
_DT_FLOAT, _DT_DOUBLE, _DT_INT32, _DT_INT64 = 1, 2, 3, 9
_DT_BOOL, _DT_HALF, _DT_BFLOAT16 = 10, 19, 14
_DT_UINT8, _DT_INT16, _DT_INT8, _DT_STRING = 4, 5, 6, 7
_DT_QINT8, _DT_QUINT8, _DT_UINT16 = 11, 12, 17

_DT_NP = {
    _DT_FLOAT: np.float32,
    _DT_DOUBLE: np.float64,
    _DT_INT32: np.int32,
    _DT_INT64: np.int64,
    _DT_BOOL: np.bool_,
    _DT_UINT8: np.uint8,
    _DT_INT16: np.int16,
    _DT_INT8: np.int8,
    _DT_UINT16: np.uint16,
    _DT_QINT8: np.int8,
    _DT_QUINT8: np.uint8,
}


_NP_DTYPES = _DT_NP


class TFConversionException(Exception):
    pass


def _numpy_strided_slice(arr, begin, end, strides, nd):
    """Evaluate a StridedSlice on a constant operand, honouring the
    begin/end/shrink-axis masks (ellipsis/new-axis unsupported)."""
    begin = begin.reshape(-1).astype(int)
    end = end.reshape(-1).astype(int)
    strides = strides.reshape(-1).astype(int)
    masks = {k: (int(nd.attr(k).i or 0) if nd.attr(k) else 0)
             for k in ("begin_mask", "end_mask", "ellipsis_mask",
                       "new_axis_mask", "shrink_axis_mask")}
    if masks["ellipsis_mask"] or masks["new_axis_mask"]:
        raise TFConversionException(
            "StridedSlice ellipsis/new_axis masks unsupported")
    idx = []
    for i in range(len(begin)):
        b = None if masks["begin_mask"] & (1 << i) else begin[i]
        e = None if masks["end_mask"] & (1 << i) else end[i]
        if masks["shrink_axis_mask"] & (1 << i):
            idx.append(int(begin[i]))
        else:
            idx.append(slice(b, e, int(strides[i])))
    return arr[tuple(idx)]


# ==========================================================================
# TensorProto / AttrValue / NodeDef decoding
# ==========================================================================


def _decode_tensor(tp: Dict[int, list]) -> np.ndarray:
    dtype = _w_int(tp, 1, _DT_FLOAT)
    shape_msg = _w_msgs(tp, 2)
    dims = []
    if shape_msg:
        for d in _w_msgs(shape_msg[0], 2):  # TensorShapeProto.dim
            dims.append(_w_int(d, 1, -1))
    if dtype == _DT_STRING:
        # string_val = repeated bytes field 8 — an object array of bytes
        vals = [bytes(v) for wt, v in tp.get(8, []) if wt == 2]
        arr = np.empty(len(vals), dtype=object)
        arr[:] = vals
        if dims:
            arr = arr.reshape(dims)
        return arr
    np_dt = _DT_NP.get(dtype)
    if np_dt is None:
        raise TFConversionException(f"unsupported tensor dtype {dtype}")
    content = tp.get(4)
    if content:
        arr = np.frombuffer(content[-1][1], dtype=np_dt)
    else:
        # scalar/short-form repeated fields: float_val=5 double_val=6
        # int_val=7 int64_val=10 bool_val=11 half_val=13
        vals: List = []
        for wt, v in tp.get(5, []):
            vals.extend(np.frombuffer(v, "<f4") if wt == 2
                        else [struct.unpack("<f", v)[0]])
        for wt, v in tp.get(7, []):
            if wt == 0:
                vals.append(int(v))
            else:
                mv = memoryview(v)
                pos = 0
                while pos < len(mv):
                    x, pos = _read_varint(mv, pos)
                    vals.append(x)
        for wt, v in tp.get(10, []):
            if wt == 0:
                vals.append(int(v))
        arr = np.asarray(vals, dtype=np_dt)
        if dims and arr.size == 1 and int(np.prod(dims)) > 1:
            arr = np.full(dims, arr.reshape(-1)[0], dtype=np_dt)
    if dims:
        arr = arr.reshape(dims)
    return arr


def _encode_tensor(arr: np.ndarray) -> _WireWriter:
    w = _WireWriter()
    if arr.dtype == object or arr.dtype.kind in ("S", "U"):
        # DT_STRING: string_val = repeated bytes field 8
        w.varint(1, _DT_STRING)
        shape = _WireWriter()
        for d in arr.shape:
            dim = _WireWriter()
            dim.varint(1, d)
            shape.message(2, dim)
        w.message(2, shape)
        for s in arr.reshape(-1):
            w.bytes_(8, s.encode() if isinstance(s, str) else bytes(s))
        return w
    dt = {np.float32: _DT_FLOAT, np.float64: _DT_DOUBLE,
          np.int32: _DT_INT32, np.int64: _DT_INT64,
          np.uint8: _DT_UINT8, np.int8: _DT_INT8}[arr.dtype.type]
    w.varint(1, dt)
    shape = _WireWriter()
    for d in arr.shape:
        dim = _WireWriter()
        dim.varint(1, d)
        shape.message(2, dim)
    w.message(2, shape)
    w.bytes_(4, np.ascontiguousarray(arr).tobytes())
    return w


class _Attr:
    """Decoded AttrValue."""

    def __init__(self, fields: Dict[int, list]):
        self.f = fields

    @property
    def s(self) -> Optional[str]:
        return _w_str(self.f, 2)

    @property
    def i(self) -> Optional[int]:
        v = _w_int(self.f, 3)
        return v

    @property
    def fl(self) -> Optional[float]:
        if 4 in self.f:
            return struct.unpack("<f", self.f[4][-1][1])[0]
        return None

    @property
    def b(self) -> Optional[bool]:
        v = _w_int(self.f, 5)
        return None if v is None else bool(v)

    @property
    def type(self) -> Optional[int]:
        return _w_int(self.f, 6)

    @property
    def tensor(self) -> Optional[np.ndarray]:
        msgs = _w_msgs(self.f, 8)
        return _decode_tensor(msgs[0]) if msgs else None

    @property
    def ints(self) -> List[int]:
        msgs = _w_msgs(self.f, 1)  # list value
        return _w_ints(msgs[0], 3) if msgs else []

    @property
    def types(self) -> List[int]:
        """list(type) — AttrValue.ListValue.type (field 6, may be packed)."""
        msgs = _w_msgs(self.f, 1)
        if not msgs:
            return []
        out: List[int] = []
        for wt, v in msgs[0].get(6, []):
            if wt == 0:
                out.append(int(v))
            else:  # packed
                mv = memoryview(v)
                pos = 0
                while pos < len(mv):
                    x, pos = _read_varint(mv, pos)
                    out.append(x)
        return out

    @property
    def shapes(self) -> List[List[int]]:
        """list(shape) — AttrValue.ListValue.shape (field 7)."""
        msgs = _w_msgs(self.f, 1)
        if not msgs:
            return []
        out = []
        for sh in _w_msgs(msgs[0], 7):
            out.append([_w_int(d, 1, -1) for d in _w_msgs(sh, 2)])
        return out

    @property
    def shape(self) -> Optional[List[int]]:
        """shape — AttrValue.shape (field 7)."""
        msgs = _w_msgs(self.f, 7)
        if not msgs:
            return None
        return [_w_int(d, 1, -1) for d in _w_msgs(msgs[0], 2)]


class _NodeDef:
    def __init__(self, fields: Dict[int, list]):
        self.name = _w_str(fields, 1, "")
        self.op = _w_str(fields, 2, "")
        self.inputs = _w_strs(fields, 3)
        self.attrs: Dict[str, _Attr] = {}
        for entry in _w_msgs(fields, 5):  # map<string, AttrValue>
            k = _w_str(entry, 1, "")
            vs = _w_msgs(entry, 2)
            if vs:
                self.attrs[k] = _Attr(vs[0])

    def attr(self, key, default=None):
        return self.attrs.get(key, default)


def parse_graphdef(data: bytes) -> List[_NodeDef]:
    g = parse_wire(data)
    return [_NodeDef(n) for n in _w_msgs(g, 1)]


# ==========================================================================
# loader
# ==========================================================================


def _clean(name: str) -> str:
    # drop control-dep marker and output index
    if name.startswith("^"):
        name = name[1:]
    return name.split(":")[0]


class TensorflowLoader:
    """Reference: «bigdl»/utils/tf/TensorflowLoader.scala.

    ``load(inputs=[...], outputs=[...])`` builds a Graph whose Input
    nodes stand for the named placeholders.  NHWC tensors are converted
    to the NCHW convention the layer library uses.
    """

    def __init__(self, path: Optional[str] = None,
                 data: Optional[bytes] = None, device="cuda"):
        self.device = resolve_device(device)
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        self.nodes = {n.name: n for n in parse_graphdef(data)}

    # ------------------------------------------------------------------
    def load(self, inputs: Optional[List[str]] = None,
             outputs: Optional[List[str]] = None,
             loop_max_iterations: int = 32):
        from bigdl_tpu_torch.nn.graph import DynamicGraph, Graph, Input

        if outputs is None:
            consumed = set()
            for n in self.nodes.values():
                consumed.update(_clean(i) for i in n.inputs)
            outputs = [n for n in self.nodes
                       if n not in consumed
                       and self.nodes[n].op not in ("Const", "Placeholder")]
        if inputs is None:
            inputs = [n.name for n in self.nodes.values()
                      if n.op == "Placeholder"]

        self._consts: Dict[str, np.ndarray] = {}
        self._built: Dict[str, object] = {}
        self._img_memo: Dict[str, bool] = {}
        self._input_nodes = []
        # while-loop wiring (frame family Enter/Merge/Switch/
        # NextIteration/Exit): loop Merges become graph NextIteration
        # nodes; the body feedback attaches after the full build
        self._loop_feedbacks: Dict[str, object] = {}  # tf NI name -> node
        self._loop_cond_node = None
        for name in inputs:
            node = Input(name)
            self._built[name] = node
            self._input_nodes.append(node)

        out_nodes = [self._build(_clean(o)) for o in outputs]
        if self._loop_feedbacks:
            # the LoopCond chain gates, it doesn't feed the outputs —
            # build it explicitly, then attach body feedbacks to a
            # fixpoint (building a body may reach further loop Merges)
            loop_conds = [n for n in self.nodes.values()
                          if n.op == "LoopCond"]
            if len(loop_conds) > 1:
                # a single masked scan can gate only one loop; silently
                # merging two frames would stop both on one condition
                raise TFConversionException(
                    "multiple while loops in one graph unsupported "
                    f"({[n.name for n in loop_conds]})")
            for tf_node in loop_conds:
                self._build(tf_node.name)
            attached = set()
            while True:
                pending = [k for k in self._loop_feedbacks
                           if k not in attached]
                if not pending:
                    break
                for ni_name in pending:
                    attached.add(ni_name)
                    src = self._build(
                        self._data_inputs(self.nodes[ni_name])[0])
                    self._loop_feedbacks[ni_name].feedback_from(src)
            # TF while is cond-before-body; the masked-scan DynamicGraph
            # is do-while, identical for any trip count >= 1 (zero-trip
            # loops are out of scope — graph.py docstring)
            return DynamicGraph(self._input_nodes, out_nodes,
                                max_iterations=loop_max_iterations,
                                condition=self._loop_cond_node
                                ).to(self.device)
        return Graph(self._input_nodes, out_nodes).to(self.device)

    # ------------------------------------------------------------------
    def _const(self, name: str) -> np.ndarray:
        raw = name[1:] if name.startswith("^") else name
        base, _, idx = raw.partition(":")
        out_idx = int(idx) if idx else 0
        name = base
        if raw in self._consts:
            return self._consts[raw]
        nd = self.nodes.get(base)
        if nd is None:
            raise TFConversionException(f"unknown node {name}")
        if nd.op == "Identity":
            return self._const(nd.inputs[0])
        if nd.op != "Const":
            folded = self._fold_const(nd, out_idx)
            if folded is not None:
                self._consts[raw] = folded
                return folded
            raise TFConversionException(
                f"node {name} ({nd.op}) is not constant"
            )
        a = nd.attr("value")
        arr = a.tensor if a else None
        if arr is None:
            raise TFConversionException(f"Const {name} has no tensor")
        self._consts[raw] = arr
        return arr

    def _fold_const(self, nd: _NodeDef, out_idx: int = 0):
        """Constant-fold shape-arithmetic subgraphs (TF graphs compute
        Reshape/Slice operands via Fill/Range/Pack/StridedSlice chains
        over Consts; the reference loader folds these the same way).
        Returns None when any operand is genuinely dynamic."""
        op = nd.op
        ins = self._data_inputs(nd)
        try:
            if op == "Fill":
                dims = self._const(ins[0]).reshape(-1).astype(int)
                val = self._const(ins[1]).reshape(-1)[0]
                return np.full(tuple(dims), val)
            if op == "Range":
                s, e, d = (self._const(i).reshape(-1)[0] for i in ins)
                return np.arange(s, e, d)
            if op == "Shape":
                # only a const input has a statically known shape here
                return np.asarray(self._const(ins[0]).shape, np.int32)
            if op == "Pack":
                ax = nd.attr("axis")
                ax = int(ax.i or 0) if ax else 0
                return np.stack([self._const(i) for i in ins], axis=ax)
            if op == "Unpack":
                ax = nd.attr("axis")
                ax = int(ax.i or 0) if ax else 0
                parts = np.split(self._const(ins[0]),
                                 self._const(ins[0]).shape[ax], axis=ax)
                return np.squeeze(parts[out_idx], axis=ax)
            if op == "ConcatV2":
                ax = int(self._const(ins[-1]).reshape(-1)[0])
                return np.concatenate(
                    [self._const(i) for i in ins[:-1]], axis=ax)
            if op == "StridedSlice":
                return _numpy_strided_slice(
                    self._const(ins[0]), self._const(ins[1]),
                    self._const(ins[2]), self._const(ins[3]), nd)
            if op == "Transpose":
                return np.transpose(
                    self._const(ins[0]),
                    self._const(ins[1]).reshape(-1).astype(int))
            if op == "Reshape":
                return np.reshape(
                    self._const(ins[0]),
                    self._const(ins[1]).reshape(-1).astype(int))
            if op == "Cast":
                dst = nd.attr("DstT")
                np_dt = _NP_DTYPES.get(dst.type if dst else _DT_FLOAT)
                if np_dt is None:
                    return None
                return self._const(ins[0]).astype(np_dt)
            if op == "ExpandDims":
                ax = int(self._const(ins[1]).reshape(-1)[0])
                return np.expand_dims(self._const(ins[0]), ax)
            if op in ("GatherV2", "Gather"):
                ax = int(self._const(ins[2]).reshape(-1)[0]) \
                    if len(ins) > 2 else 0
                return np.take(self._const(ins[0]),
                               self._const(ins[1]).astype(int), axis=ax)
            if op == "Prod":
                axes = tuple(self._const(ins[1]).reshape(-1).astype(int))
                return np.prod(self._const(ins[0]), axis=axes or None)
            if op in ("Add", "AddV2", "Sub", "Mul", "RealDiv",
                      "Maximum", "Minimum"):
                a, b = self._const(ins[0]), self._const(ins[1])
                return {"Add": np.add, "AddV2": np.add, "Sub": np.subtract,
                        "Mul": np.multiply, "RealDiv": np.divide,
                        "Maximum": np.maximum,
                        "Minimum": np.minimum}[op](a, b)
            if op == "Neg":
                return -self._const(ins[0])
            if op == "Rank":
                return np.asarray(self._const(ins[0]).ndim, np.int32)
            if op == "Size":
                return np.asarray(self._const(ins[0]).size, np.int32)
            if op in ("Sqrt", "Floor", "Ceil", "Round", "Abs"):
                return {"Sqrt": np.sqrt, "Floor": np.floor,
                        "Ceil": np.ceil, "Round": np.round,
                        "Abs": np.abs}[op](self._const(ins[0]))
            if op == "OneHot":
                idx = self._const(ins[0]).astype(int)
                depth = int(self._const(ins[1]).reshape(-1)[0])
                on = float(self._const(ins[2]).reshape(-1)[0]) \
                    if len(ins) > 2 else 1.0
                off = float(self._const(ins[3]).reshape(-1)[0]) \
                    if len(ins) > 3 else 0.0
                ax = nd.attr("axis")
                ax = int(ax.i) if ax and ax.i is not None else -1
                if ax not in (-1, idx.ndim):
                    return None
                out = np.full(idx.shape + (depth,), off, np.float32)
                ok = (idx >= 0) & (idx < depth)
                np.put_along_axis(
                    out, np.clip(idx, 0, depth - 1)[..., None],
                    np.where(ok, on, off)[..., None], axis=-1)
                return out
            if op == "Dequantize":
                # quantized weights in frozen graphs: MIN_COMBINED maps
                # the integer range linearly onto [min_range, max_range]
                mode = nd.attr("mode")
                mode = mode.s if mode and mode.s else "MIN_COMBINED"
                if mode != "MIN_COMBINED":
                    return None
                q = self._const(ins[0])
                lo = float(self._const(ins[1]).reshape(-1)[0])
                hi = float(self._const(ins[2]).reshape(-1)[0])
                info = np.iinfo(q.dtype)
                span = float(int(info.max) - int(info.min))
                scale = (hi - lo) / span
                if info.min == 0:  # quint8
                    return (q.astype(np.float32) * scale + lo).astype(
                        np.float32)
                # qint8: zero maps to the range midpoint
                return ((q.astype(np.float32) - info.min) * scale
                        + lo).astype(np.float32)
        except TFConversionException:
            return None
        return None

    def _data_inputs(self, nd: _NodeDef) -> List[str]:
        return [i for i in nd.inputs if not i.startswith("^")]

    # NHWC graphs are converted to NCHW modules, so axis-bearing ops
    # (Concat/Squeeze/Pad/Mean/BiasAdd) must remap their axes whenever
    # the tensor flowing through them is an image (4-D conv-path) tensor
    _IMG_PRODUCERS = ("Conv2D", "DepthwiseConv2dNative", "MaxPool",
                      "AvgPool", "FusedBatchNorm", "FusedBatchNormV2",
                      "FusedBatchNormV3", "ResizeBilinear",
                      "ResizeNearestNeighbor", "DepthToSpace",
                      "SpaceToDepth")
    _IMG_PROPAGATORS = ("Identity", "StopGradient", "CheckNumerics",
                        "Relu", "Relu6", "Elu", "Tanh", "Sigmoid",
                        "Softplus", "BiasAdd", "Add", "AddV2", "Sub",
                        "Mul", "Maximum", "Minimum", "RealDiv", "Pad",
                        "ConcatV2", "Concat", "Abs", "Neg", "Sqrt",
                        "Square", "Exp", "Log", "LeakyRelu", "Selu",
                        "Softsign", "Pow", "Cast", "Tile", "Slice")

    def _is_image(self, name: str) -> bool:
        """True when ``name`` carries an NHWC conv-path tensor whose axes
        need remapping.  NCHW-format producers (data_format attr) are
        already in the framework layout and must NOT be remapped."""
        name = _clean(name)
        if name in self._img_memo:
            return self._img_memo[name]
        nd = self.nodes.get(name)
        res = False
        if nd is not None:
            if nd.op in self._IMG_PRODUCERS:
                fmt = nd.attr("data_format")
                res = (fmt.s if fmt and fmt.s else "NHWC") == "NHWC"
            elif nd.op in self._IMG_PROPAGATORS:
                self._img_memo[name] = False  # cycle guard
                res = any(self._is_image(i) for i in self._data_inputs(nd))
        self._img_memo[name] = res
        return res

    def _axis_dim(self, axis: int, image: bool) -> int:
        """TF axis -> the 1-based dim convention of the module layer.
        Image (NHWC->NCHW) axes are remapped (negatives normalised
        against rank 4); non-image negative axes stay negative — the
        core modules (Narrow/Select/SplitTable/SplitChunks/
        GatherIndices) count negatives from the end themselves."""
        if image or axis >= 0:
            return self._map_axis(axis, image) + 1
        return axis

    @staticmethod
    def _map_axis(axis: int, image: bool) -> int:
        """NHWC axis -> NCHW axis for image tensors.  Negative axes are
        normalised against the known rank-4 image layout; for non-image
        tensors they pass through (numpy semantics handle them)."""
        if not image:
            return axis
        if axis < 0:
            axis += 4
        return {0: 0, 1: 2, 2: 3, 3: 1}[axis]

    # ops whose consumers select an output by ":idx" (TF multi-output);
    # the converted module returns a tuple, picked via SelectTable
    _MULTI_OUTPUT_OPS = ("Switch", "Split", "SplitV", "Unpack")

    def _switch_ancestors(self, name: str, _depth: int = 0, _memo=None):
        """All Switch ancestors reachable from ``name``:
        {pred_base_name: {"ports": {0|1,...}, "depth": min, "ref": pred}}
        where a port is the Switch output the path rode (0=false,
        1=true).  Used to find a Merge's *controlling* Switch: for
        nested conds, the controlling predicate is the one common to
        both Merge inputs with a distinct single port on each side.
        Memoized per raw ref so reconvergent (residual/diamond) graphs
        stay linear instead of enumerating every path."""
        if _memo is None:
            _memo = {}
        raw = name[1:] if name.startswith("^") else name
        if raw in _memo:
            return _memo[raw]
        result: Dict[str, dict] = {}
        if _depth > 256:
            return result
        base, _, idx = raw.partition(":")
        port = int(idx) if idx else 0
        nd = self.nodes.get(base)
        if nd is None:
            return result
        _memo[raw] = result  # cycle guard; filled in place below
        if nd.op == "Switch":
            data_in, pred_in = self._data_inputs(nd)[:2]
            key = _clean(pred_in)
            entry = result.setdefault(
                key, {"ports": set(), "depth": _depth, "ref": pred_in})
            entry["ports"].add(port)
            entry["depth"] = min(entry["depth"], _depth)
            ups = [data_in]  # outer switches sit above this one's data
        else:
            ups = self._data_inputs(nd)
        for i in ups:
            for k, v in self._switch_ancestors(i, _depth + 1, _memo).items():
                if k in result:
                    result[k]["ports"] |= v["ports"]
                    result[k]["depth"] = min(result[k]["depth"], v["depth"])
                else:
                    result[k] = v
        return result

    def _merge_wiring(self, ins):
        """Resolve a Merge's (false_input, true_input, pred_ref) under
        select semantics.  The controlling Switch is the common
        ancestor predicate whose port differs between the two inputs
        (disambiguates nested conds and input order)."""
        a0 = self._switch_ancestors(ins[0])
        a1 = self._switch_ancestors(ins[1])
        best = None
        for p in set(a0) & set(a1):
            p0, p1 = a0[p]["ports"], a1[p]["ports"]
            if len(p0) == 1 and len(p1) == 1 and p0 != p1:
                d = a0[p]["depth"] + a1[p]["depth"]
                if best is None or d < best[0]:
                    best = (d, p)
        if best is not None:
            p = best[1]
            if a0[p]["ports"] == {0}:
                return ins[0], ins[1], a0[p]["ref"]
            return ins[1], ins[0], a0[p]["ref"]
        # fallback: any ancestor pred, keep the given (false, true) order
        for side in (a0, a1):
            if side:
                p = min(side, key=lambda q: side[q]["depth"])
                return ins[0], ins[1], side[p]["ref"]
        return None

    def _is_loop_switch(self, nd: _NodeDef) -> bool:
        """True when a Switch's predicate traces to a LoopCond — i.e.
        it is a while-frame Switch, not a cond-branch Switch."""
        pred = _clean(self._data_inputs(nd)[1])
        seen = set()
        while pred in self.nodes and pred not in seen:
            seen.add(pred)
            pnd = self.nodes[pred]
            if pnd.op == "LoopCond":
                return True
            if pnd.op == "Identity":
                pred = _clean(pnd.inputs[0])
                continue
            break
        return False

    def _build(self, name: str):
        """Recursively convert node ``name``; returns a wired graph Node."""
        raw = name[1:] if name.startswith("^") else name
        if raw in self._built:
            # covers explicit "node:k" seam inputs (input-pipeline
            # boundaries) as well as plain seeded names
            return self._built[raw]
        base, _, idx = raw.partition(":")
        out_idx = int(idx) if idx else 0
        src_nd = self.nodes.get(base)
        if src_nd is not None and src_nd.op == "Switch" \
                and self._is_loop_switch(src_nd):
            # while-frame Switch: the masked-scan DynamicGraph owns the
            # stop-iterating semantics, so both ports (0 = Exit side,
            # 1 = body side) pass the merge value straight through
            if base not in self._built:
                self._built[base] = self._build(
                    self._data_inputs(src_nd)[0])
            return self._built[base]
        if src_nd is not None and src_nd.op in self._MULTI_OUTPUT_OPS:
            # TF refs output 0 as "name", output k as "name:k"; the
            # converted module emits a tuple -> SelectTable per consumer
            key = f"{base}:{out_idx}"
            if key in self._built:
                return self._built[key]
            rawkey = base + ":__raw__"
            if rawkey not in self._built:
                self._built[rawkey] = self._convert(src_nd)
            from bigdl_tpu_torch.nn.table_ops import SelectTable

            node = SelectTable(out_idx + 1)(self._built[rawkey])  # 1-based
            self._built[key] = node
            return node
        name = base
        if name in self._built:
            return self._built[name]
        nd = self.nodes.get(name)
        if nd is None:
            raise TFConversionException(f"unknown node {name}")
        node = self._convert(nd)
        self._built[name] = node
        return node

    # ------------------------------------------------------------------
    def _convert(self, nd: _NodeDef):
        from bigdl_tpu_torch.nn import layers as L
        from bigdl_tpu_torch.nn import table_ops as T
        from bigdl_tpu_torch.nn.graph import Input

        op = nd.op
        ins = self._data_inputs(nd)

        if op == "Placeholder":
            node = Input(nd.name)
            self._input_nodes.append(node)
            return node
        if op in ("Identity", "StopGradient", "CheckNumerics", "NoOp",
                  "Enter", "Exit"):
            # Enter/Exit are while-frame markers: identities here — the
            # DynamicGraph's masked scan owns the iteration semantics
            return self._build(ins[0])

        # control flow: select-semantics lowering — see
        # nn/control_ops.py.  Switch(data, pred) -> ((data,pred) x2),
        # consumers pick a branch via the _build multi-output path;
        # Merge selects by the predicate riding alongside each branch.
        if op == "Switch":
            from bigdl_tpu_torch.nn import control_ops as C

            return self._named(C.SwitchOps(), nd)(
                self._build(ins[0]), self._build(ins[1])
            )
        if op == "Merge":
            from bigdl_tpu_torch.nn import control_ops as C

            ni = [i for i in ins
                  if self.nodes.get(_clean(i), _NodeDef({})).op
                  == "NextIteration"]
            if ni:
                # while-frame Merge: a NextIteration graph node whose
                # ordinary predecessor is the Enter value; the body
                # feedback attaches in load()'s fixup pass
                others = [i for i in ins if i not in ni]
                node = self._named(C.NextIteration(), nd)(
                    self._build(others[0]))
                self._loop_feedbacks[_clean(ni[0])] = node
                return node
            wiring = self._merge_wiring(ins)
            if wiring is None:
                raise TFConversionException(
                    f"Merge {nd.name}: no controlling Switch found"
                )
            false_in, true_in, pred_name = wiring
            return self._named(C.MergeOps(), nd)(
                self._build(false_in), self._build(true_in),
                self._build(pred_name),
            )
        if op == "LoopCond":
            from bigdl_tpu_torch.nn import control_ops as C

            node = self._named(C.LoopCondition(), nd)(self._build(ins[0]))
            self._loop_cond_node = node
            return node

        if op in ("Less", "LessEqual", "Greater", "GreaterEqual",
                  "Equal", "NotEqual"):
            from bigdl_tpu_torch.nn.layers_extra import CompareConstant

            cmp = {"Less": "lt", "LessEqual": "le", "Greater": "gt",
                   "GreaterEqual": "ge", "Equal": "eq",
                   "NotEqual": "ne"}[op]
            consts = []
            for i in ins:
                try:
                    consts.append(self._const(i))
                except TFConversionException:
                    consts.append(None)
            if consts[0] is None and consts[1] is None:
                raise TFConversionException(
                    f"{op} with two runtime operands unsupported")
            ci = 0 if consts[0] is not None else 1
            cval = consts[ci]
            if cval.size != 1:
                raise TFConversionException(
                    f"{op} with a non-scalar const unsupported")
            mod = CompareConstant(cmp, float(cval.reshape(-1)[0]),
                                  const_first=(ci == 0))
            return self._named(mod, nd)(self._build(ins[1 - ci]))
        if op == "Const":
            raise TFConversionException(
                f"Const {nd.name} reached graph position — only weight"
                " positions may be constant"
            )

        if op == "MatMul":
            w = self._const(ins[1])
            if nd.attr("transpose_b") and nd.attr("transpose_b").b:
                w = w.T
            mod = L.Linear(w.shape[0], w.shape[1], with_bias=False)
            self._set(mod, "weight", np.ascontiguousarray(w.T))
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "BiasAdd":
            b = self._const(ins[1])
            # BiasAdd always adds along the channel axis.  Two cases need
            # the (C, 1, 1) broadcast on the converted (NCHW) tensor:
            #  - the producer chain was NHWC and got remapped to NCHW, or
            #  - the node itself declares data_format=NCHW (channels are
            #    already axis 1 — a flat (C,) add would ride the W axis).
            fmt = nd.attr("data_format")
            fmt = fmt.s if fmt and fmt.s else "NHWC"
            if self._is_image(ins[0]) or fmt == "NCHW":
                mod = L.CAdd((b.size, 1, 1))
                self._set(mod, "bias", b.reshape(-1, 1, 1))
            else:
                mod = L.CAdd(b.shape)
                self._set(mod, "bias", b)
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("Add", "AddV2", "Sub", "Mul", "Maximum", "Minimum",
                  "RealDiv"):
            # constant operand -> elementwise const op; else table op
            const_idx = None
            for i, inp in enumerate(ins):
                try:
                    self._const(inp)
                    const_idx = i
                    break
                except TFConversionException:
                    continue
            if const_idx is not None:
                c = self._const(ins[const_idx])
                other = ins[1 - const_idx]
                if c.size == 1:
                    from bigdl_tpu_torch.nn.module import Sequential

                    v = float(c.reshape(-1)[0])
                    if op in ("Add", "AddV2"):
                        mod = L.AddConstant(v)
                    elif op == "Sub":
                        if const_idx == 1:  # x - c
                            mod = L.AddConstant(-v)
                        else:  # c - x = -(x) + c
                            mod = Sequential().add(L.Negative()) \
                                .add(L.AddConstant(v))
                    elif op == "Mul":
                        mod = L.MulConstant(v)
                    elif op == "RealDiv":
                        if const_idx == 1:  # x / c
                            mod = L.MulConstant(1.0 / v)
                        else:  # c / x = c * x^-1
                            mod = Sequential().add(L.Power(-1.0)) \
                                .add(L.MulConstant(v))
                    elif op == "Maximum":
                        mod = L.Threshold(v, v)
                    else:  # Minimum: min(x, c) = -max(-x, -c)
                        mod = Sequential().add(L.Negative()) \
                            .add(L.Threshold(-v, -v)).add(L.Negative())
                    return self._named(mod, nd)(self._build(other))
                # broadcast add/mul with a vector -> CAdd/CMul.  TF
                # broadcasts trailing axes: on an NHWC tensor a (C,) const
                # rides the channel axis, so after the NHWC->NCHW remap it
                # must become (C, 1, 1); non-image tensors keep TF layout
                # and the trailing broadcast is already correct.
                if self._is_image(other) and c.ndim == 1:
                    cshape = (c.size, 1, 1)
                    c = c.reshape(cshape)
                else:
                    cshape = c.shape
                if op in ("Add", "AddV2"):
                    mod = L.CAdd(cshape)
                    self._set(mod, "bias", c)
                elif op == "Mul":
                    mod = L.CMul(cshape)
                    self._set(mod, "weight", c)
                else:
                    raise TFConversionException(
                        f"{op} with non-scalar constant unsupported"
                    )
                return self._named(mod, nd)(self._build(other))
            table = {
                "Add": T.CAddTable, "AddV2": T.CAddTable,
                "Sub": T.CSubTable, "Mul": T.CMulTable,
                "Maximum": T.CMaxTable, "Minimum": T.CMinTable,
                "RealDiv": T.CDivTable,
            }[op]()
            return self._named(table, nd)(*[self._build(i) for i in ins])

        if op in ("Conv2D", "DepthwiseConv2dNative"):
            w = self._const(ins[1])  # HWIO (or HWIM for depthwise)
            strides = nd.attr("strides").ints if nd.attr("strides") else [1, 1, 1, 1]
            padding = nd.attr("padding").s if nd.attr("padding") else "SAME"
            data_format = nd.attr("data_format").s if nd.attr("data_format") else "NHWC"
            if data_format == "NHWC":
                sh, sw = strides[1], strides[2]
            else:
                sh, sw = strides[2], strides[3]
            kh, kw, c_in, c_mult = w.shape
            if op == "DepthwiseConv2dNative":
                n_out = c_in * c_mult
                group = c_in
                # HWIM -> (out, in/group=1, kh, kw)
                wt = w.transpose(2, 3, 0, 1).reshape(n_out, 1, kh, kw)
            else:
                n_out = c_mult
                group = 1
                wt = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if padding == "SAME":
                ph, pw = -1, -1  # layer lib: -1 means SAME
            else:
                ph = pw = 0
            mod = L.SpatialConvolution(
                c_in if group == 1 else c_in, n_out, kw, kh, sw, sh,
                pw, ph, group, with_bias=False,
            )
            self._set(mod, "weight", np.ascontiguousarray(wt).reshape(
                tuple(mod.weight.shape)))
            prev = self._build(ins[0])
            return self._named(mod, nd)(prev)

        if op in ("MaxPool", "AvgPool"):
            ks = nd.attr("ksize").ints
            strides = nd.attr("strides").ints
            padding = nd.attr("padding").s
            fmt = nd.attr("data_format")
            if fmt and fmt.s == "NCHW":
                kh, kw = ks[2], ks[3]
                sh, sw = strides[2], strides[3]
            else:
                kh, kw = ks[1], ks[2]
                sh, sw = strides[1], strides[2]
            pad = -1 if padding == "SAME" else 0
            if op == "MaxPool":
                mod = L.SpatialMaxPooling(kw, kh, sw, sh, pad, pad)
            else:
                # TF AvgPool excludes padding from the divisor
                mod = L.SpatialAveragePooling(
                    kw, kh, sw, sh, pad, pad, count_include_pad=False
                )
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "Mean":
            image = self._is_image(ins[0])
            axes = sorted(
                self._map_axis(int(a), image)
                for a in self._const(ins[1]).reshape(-1).tolist()
            )
            keep = nd.attr("keep_dims")
            keep = bool(keep.b) if keep else False
            if axes == [2, 3]:
                # global spatial average pool over the NCHW image
                mod = L.SpatialAveragePooling(0, 0, global_pooling=True)
                if not keep:
                    from bigdl_tpu_torch.nn.module import Sequential

                    mod = Sequential().add(mod).add(L.Squeeze(None))
                return self._named(mod, nd)(self._build(ins[0]))
            if len(axes) != 1 or keep:
                raise TFConversionException(
                    f"Mean over axes {axes} (keep_dims={keep}) unsupported"
                )
            mod = L.Mean(axes[0] + 1)
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("Relu", "Relu6", "Elu", "Tanh", "Sigmoid", "Softplus",
                  "Softmax", "LogSoftmax", "Rsqrt", "Sqrt", "Square",
                  "Exp", "Log", "Abs", "Neg", "Floor", "Ceil", "Round",
                  "Rint", "Sign", "Log1p", "Expm1", "Erf", "Sin", "Cos",
                  "Reciprocal", "Inv"):
            mod = {
                "Relu": L.ReLU, "Relu6": L.ReLU6, "Elu": L.ELU,
                "Tanh": L.Tanh, "Sigmoid": L.Sigmoid,
                "Softplus": L.SoftPlus, "Softmax": L.SoftMax,
                "LogSoftmax": L.LogSoftMax, "Sqrt": L.Sqrt,
                "Square": L.Square, "Exp": L.Exp, "Log": L.Log,
                "Abs": L.Abs, "Neg": L.Negative,
                "Floor": L.Floor, "Ceil": L.Ceil, "Round": L.Round,
                "Rint": L.Round, "Sign": L.Sign, "Log1p": L.Log1p,
                "Expm1": L.Expm1, "Erf": L.Erf, "Sin": L.Sin,
                "Cos": L.Cos,
            }.get(op)
            if mod is None:
                mod = L.Power(-0.5) if op == "Rsqrt" else L.Power(-1.0)
            else:
                mod = mod()
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "ArgMax":
            axis = int(self._const(ins[1]).reshape(-1)[0])
            dim1 = self._axis_dim(axis, self._is_image(ins[0]))
            return self._named(L.ArgMax(dim1), nd)(self._build(ins[0]))

        if op == "FloorDiv":
            from bigdl_tpu_torch.nn.module import Sequential

            consts = []
            for i in ins:
                try:
                    consts.append(self._const(i))
                except TFConversionException:
                    consts.append(None)
            if consts[1] is not None and consts[1].size == 1:
                c = float(consts[1].reshape(-1)[0])
                mod = Sequential().add(L.DivConstant(c)).add(L.Floor())
                return self._named(mod, nd)(self._build(ins[0]))
            mod = Sequential().add(T.CDivTable()).add(L.Floor())
            return self._named(mod, nd)(
                self._build(ins[0]), self._build(ins[1]))

        if op == "Reshape":
            shape = self._const(ins[1]).reshape(-1).astype(int).tolist()
            if shape and shape[0] == -1:
                mod = L.Reshape(shape[1:])  # batch-preserving
            else:
                mod = L.View(*shape)
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "Squeeze":
            dims = nd.attr("squeeze_dims")
            image = self._is_image(ins[0])
            axes = sorted(
                (self._map_axis(int(a), image) for a in dims.ints),
                reverse=True,
            ) if dims else []
            if not axes:
                mod = L.Squeeze(None)
            elif len(axes) == 1:
                mod = L.Squeeze(axes[0] + 1)
            else:
                from bigdl_tpu_torch.nn.module import Sequential

                mod = Sequential()
                for a in axes:  # descending: later indices stay valid
                    mod.add(L.Squeeze(a + 1))
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "Pad":
            pads = self._const(ins[1])  # (ndim, 2) in graph (NHWC) order
            if int(pads[0, 0]) or int(pads[0, 1]):
                raise TFConversionException("Pad on the batch axis unsupported")
            from bigdl_tpu_torch.nn.module import Sequential

            image = self._is_image(ins[0])
            n_input_dim = pads.shape[0] - 1
            seq = Sequential()
            for axis in range(1, pads.shape[0]):
                before, after = int(pads[axis, 0]), int(pads[axis, 1])
                dim = self._map_axis(axis, image)
                if before:
                    seq.add(L.Padding(dim, -before, n_input_dim))
                if after:
                    seq.add(L.Padding(dim, after, n_input_dim))
            return self._named(seq, nd)(self._build(ins[0]))

        if op in ("ConcatV2", "Concat"):
            if op == "ConcatV2":
                axis = int(self._const(ins[-1]).reshape(-1)[0])
                data = ins[:-1]
            else:
                axis = int(self._const(ins[0]).reshape(-1)[0])
                data = ins[1:]
            image = any(self._is_image(i) for i in data)
            axis = self._map_axis(axis, image)
            mod = T.JoinTable(dimension=axis + 1, n_input_dims=-1)
            return self._named(mod, nd)(*[self._build(i) for i in data])

        if op == "LeakyRelu":
            alpha = nd.attr("alpha")
            mod = L.LeakyReLU(alpha.fl if alpha else 0.2)
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("Selu", "Softsign"):
            mod = L.SELU() if op == "Selu" else L.SoftSign()
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "Pow":
            e = self._const(ins[1])
            if e.size != 1:
                raise TFConversionException(
                    "Pow with a non-scalar exponent unsupported")
            mod = L.Power(float(e.reshape(-1)[0]))
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("Sum", "Max", "Min"):
            image = self._is_image(ins[0])
            axes = [self._map_axis(int(a), image)
                    for a in self._const(ins[1]).reshape(-1).tolist()]
            keep = nd.attr("keep_dims")
            keep = bool(keep.b) if keep else False
            if len(axes) != 1 or keep:
                raise TFConversionException(
                    f"{op} over axes {axes} (keep_dims={keep}) unsupported"
                )
            cls = {"Sum": L.Sum, "Max": L.Max, "Min": L.Min}[op]
            mod = cls(axes[0] + 1)
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("All", "Any"):
            # {0,1}-float booleans: All = min-reduce, Any = max-reduce
            image = self._is_image(ins[0])
            axes = [self._map_axis(int(a), image)
                    for a in self._const(ins[1]).reshape(-1).tolist()]
            keep = nd.attr("keep_dims")
            if len(axes) != 1 or (keep and keep.b):
                raise TFConversionException(
                    f"{op} over axes {axes} with keep_dims unsupported")
            mod = (L.Min if op == "All" else L.Max)(axes[0] + 1)
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("ZerosLike", "OnesLike"):
            from bigdl_tpu_torch.nn.layers_extra import FillLike

            mod = FillLike(0.0 if op == "ZerosLike" else 1.0)
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "LogicalNot":
            from bigdl_tpu_torch.nn.module import Sequential

            mod = Sequential().add(L.Negative()).add(L.AddConstant(1.0))
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("LogicalAnd", "LogicalOr"):
            table = T.CMinTable() if op == "LogicalAnd" else T.CMaxTable()
            return self._named(table, nd)(*[self._build(i) for i in ins])

        if op == "InTopK":
            k = nd.attr("k")
            mod = T.InTopK(int(k.i) if k else 1)
            return self._named(mod, nd)(*[self._build(i) for i in ins])

        if op in ("Select", "SelectV2"):
            # v1 Select broadcasts a low-rank cond along LEADING axes
            # (rank-1 cond = row mask); SelectV2 is numpy-style
            table = T.WhereTable(leading_broadcast=(op == "Select"))
            return self._named(table, nd)(
                *[self._build(i) for i in ins])

        if op == "Cumsum":
            from bigdl_tpu_torch.nn.layers_extra import CumSum

            image = self._is_image(ins[0])
            ax = self._map_axis(
                int(self._const(ins[1]).reshape(-1)[0]), image)
            exclusive = nd.attr("exclusive")
            reverse = nd.attr("reverse")
            mod = CumSum(ax + 1,
                         exclusive=bool(exclusive.b) if exclusive else False,
                         reverse=bool(reverse.b) if reverse else False)
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "ReverseV2":
            from bigdl_tpu_torch.nn.layers_extra import Reverse
            from bigdl_tpu_torch.nn.module import Sequential

            image = self._is_image(ins[0])
            axes = [self._map_axis(int(a), image)
                    for a in self._const(ins[1]).reshape(-1).tolist()]
            seq = Sequential()
            for a in axes:
                seq.add(Reverse(a + 1))
            mod = seq if len(seq.modules) != 1 else seq.modules[0]
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "MirrorPad":
            from bigdl_tpu_torch.nn.layers_extra import MirrorPad

            pads = self._const(ins[1]).astype(int)  # (rank, 2) TF layout
            if pads[0].any():
                raise TFConversionException(
                    "MirrorPad on the batch axis unsupported")
            if self._is_image(ins[0]) and pads.shape[0] == 4:
                # NHWC rows -> converted NCHW tensor order
                pads = pads[[0, 3, 1, 2]]
            mode = nd.attr("mode")
            mode = mode.s if mode and mode.s else "REFLECT"
            mod = MirrorPad([list(p) for p in pads.tolist()], mode=mode)
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "Tile":
            image = self._is_image(ins[0])
            mults = self._const(ins[1]).reshape(-1).astype(int).tolist()
            if mults[0] != 1:
                raise TFConversionException(
                    "Tile on the batch axis unsupported")
            from bigdl_tpu_torch.nn.layers_extra import Tile
            from bigdl_tpu_torch.nn.module import Sequential

            seq = Sequential()
            for axis, m in enumerate(mults):
                if axis == 0 or m == 1:
                    continue
                dim = self._map_axis(axis, image)
                seq.add(Tile(dim + 1, m))
            mod = seq if len(seq.modules) != 1 else seq.modules[0]
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "Cast":
            # float->float casts are identity in this f32 runtime (the
            # compute-dtype policy governs precision); an integer target
            # would truncate, which Identity silently would not
            dst = nd.attr("DstT")
            if dst is not None and dst.type not in (
                    _DT_FLOAT, _DT_DOUBLE, _DT_HALF, _DT_BFLOAT16):
                raise TFConversionException(
                    f"Cast to dtype {dst.type} unsupported")
            from bigdl_tpu_torch.nn.module import Identity

            return self._named(Identity(), nd)(self._build(ins[0]))

        if op == "Slice":
            begin = self._const(ins[1]).reshape(-1).astype(int).tolist()
            size = self._const(ins[2]).reshape(-1).astype(int).tolist()
            image = self._is_image(ins[0])
            # a concrete size[0] (the frozen batch extent) with begin 0
            # is the common no-op batch slice real graphs encode;
            # only a nonzero begin actually cuts samples
            if begin[0] != 0:
                raise TFConversionException(
                    "Slice on the batch axis unsupported")
            from bigdl_tpu_torch.nn.module import Sequential

            seq = Sequential()
            for axis in range(1, len(begin)):
                if begin[axis] == 0 and size[axis] == -1:
                    continue
                dim = self._map_axis(axis, image)
                seq.add(L.Narrow(dim + 1, begin[axis] + 1, size[axis]))
            from bigdl_tpu_torch.nn.module import Identity

            mod = (
                Identity() if not seq.modules
                else seq if len(seq.modules) != 1 else seq.modules[0]
            )
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "AddN":
            # n-ary sum of runtime tensors
            mod = T.CAddTable()
            return self._named(mod, nd)(*[self._build(i) for i in ins])

        if op == "SquaredDifference":
            from bigdl_tpu_torch.nn.module import Sequential

            # (a - b)^2; const operands fold into an AddConstant
            consts = []
            for i in ins:
                try:
                    consts.append(self._const(i))
                except TFConversionException:
                    consts.append(None)
            if consts[0] is None and consts[1] is None:
                seq = Sequential().add(T.CSubTable()).add(L.Square())
                return self._named(seq, nd)(
                    self._build(ins[0]), self._build(ins[1]))
            ci = 0 if consts[0] is not None else 1
            cval = consts[ci]
            if cval.size != 1:
                raise TFConversionException(
                    "SquaredDifference with a non-scalar const "
                    "unsupported")
            seq = Sequential().add(
                L.AddConstant(-float(cval.reshape(-1)[0]))).add(L.Square())
            return self._named(seq, nd)(self._build(ins[1 - ci]))

        if op in ("Split", "SplitV"):
            # TF Split(split_dim, value) / SplitV(value, sizes, dim):
            # equal chunks via SplitChunks (runtime-shape chunk length),
            # explicit sizes via a Narrow fan-out; both multi-output
            from bigdl_tpu_torch.nn.layers_extra import SplitChunks
            from bigdl_tpu_torch.nn.table_ops import ConcatTable

            if op == "Split":
                axis = int(self._const(ins[0]).reshape(-1)[0])
                data_in = ins[1]
                num = nd.attr("num_split")
                num = int(num.i or 0) if num else 0
                dim1 = self._axis_dim(axis, self._is_image(data_in))
                mod = SplitChunks(dim1, num)
            else:
                data_in = ins[0]
                sizes = self._const(ins[1]).reshape(-1).astype(int).tolist()
                axis = int(self._const(ins[2]).reshape(-1)[0])
                dim1 = self._axis_dim(axis, self._is_image(data_in))
                mod = ConcatTable()
                off = 1
                for s in sizes:
                    mod.add(L.Narrow(dim1, off, int(s)))
                    off += int(s)
            return self._named(mod, nd)(self._build(data_in))

        if op == "Unpack":
            # table of dim-removed slices == SplitTable semantics
            ax = nd.attr("axis")
            axis = int(ax.i or 0) if ax else 0
            mod = T.SplitTable(self._axis_dim(axis, self._is_image(ins[0])))
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "Pack":
            ax = nd.attr("axis")
            axis = int(ax.i or 0) if ax else 0
            if axis < 0:
                raise TFConversionException(
                    "Pack with negative axis unsupported")
            mod = T.Pack(axis + 1)
            return self._named(mod, nd)(*[self._build(i) for i in ins])

        if op == "StridedSlice":
            begin = self._const(ins[1]).reshape(-1).astype(int).tolist()
            end = self._const(ins[2]).reshape(-1).astype(int).tolist()
            strides = self._const(ins[3]).reshape(-1).astype(int).tolist()
            if any(s != 1 for s in strides):
                raise TFConversionException(
                    "StridedSlice with strides != 1 unsupported")
            bm = int(nd.attr("begin_mask").i or 0) \
                if nd.attr("begin_mask") else 0
            em = int(nd.attr("end_mask").i or 0) if nd.attr("end_mask") else 0
            sm = int(nd.attr("shrink_axis_mask").i or 0) \
                if nd.attr("shrink_axis_mask") else 0
            for k in ("ellipsis_mask", "new_axis_mask"):
                if nd.attr(k) and (nd.attr(k).i or 0):
                    raise TFConversionException(
                        f"StridedSlice {k} unsupported")
            # the batch axis must be left whole: begin free (mask or 0)
            # AND end free (mask set) — a concrete end[0] would cut
            # samples silently at an unknown runtime batch size
            if (not (bm & 1) and begin[0] != 0) or (sm & 1) \
                    or not (em & 1):
                raise TFConversionException(
                    "StridedSlice constraining the batch axis unsupported")
            image = self._is_image(ins[0])
            from bigdl_tpu_torch.nn.module import Sequential
            from bigdl_tpu_torch.nn.recurrent import Select as _Select

            seq = Sequential()
            shrinks = []
            for axis in range(1, len(begin)):
                dim = self._map_axis(axis, image)
                b = 0 if bm & (1 << axis) else begin[axis]
                if b < 0:
                    raise TFConversionException(
                        "StridedSlice negative begin unsupported")
                if sm & (1 << axis):
                    shrinks.append((dim, begin[axis]))
                    continue
                to_end = bool(em & (1 << axis))
                if b == 0 and to_end:
                    continue
                if to_end:
                    seq.add(L.Narrow(dim + 1, b + 1, -1))
                elif end[axis] < 0:
                    # python-style from-the-end: Narrow's negative
                    # length L keeps size - offset + 2 + L elements
                    # (1-based offset b+1), so L = end - 1 keeps
                    # exactly size + end - b
                    seq.add(L.Narrow(dim + 1, b + 1, end[axis] - 1))
                else:
                    seq.add(L.Narrow(dim + 1, b + 1, end[axis] - b))
            # shrink axes AFTER narrows, highest dim first so earlier
            # indices stay valid; Select removes the axis
            for dim, b in sorted(shrinks, reverse=True):
                seq.add(_Select(dim + 1, b + 1))
            from bigdl_tpu_torch.nn.module import Identity

            mod = (
                Identity() if not seq.modules
                else seq if len(seq.modules) != 1 else seq.modules[0]
            )
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("GatherV2", "Gather"):
            idxv = self._const(ins[1])
            axis = int(self._const(ins[2]).reshape(-1)[0]) \
                if len(ins) > 2 else 0
            dim1 = self._axis_dim(axis, self._is_image(ins[0]))
            from bigdl_tpu_torch.nn.layers_extra import GatherIndices
            from bigdl_tpu_torch.nn.recurrent import Select as _Select

            if idxv.ndim == 0:
                mod = _Select(dim1, int(idxv) + 1)
            elif idxv.ndim == 1:
                # one jnp.take — a Select fan-out would scale the module
                # graph with the index count
                mod = GatherIndices(dim1, idxv.astype(int).tolist())
            else:
                raise TFConversionException(
                    "Gather with >1-D indices unsupported")
            return self._named(mod, nd)(self._build(ins[0]))

        if op == "Transpose":
            perm = self._const(ins[1]).reshape(-1).astype(int).tolist()
            if self._is_image(ins[0]):
                raise TFConversionException(
                    "Transpose of an NHWC image tensor unsupported "
                    "(layout already remapped)")
            # decompose the permutation into sequential swaps
            # (L.Transpose applies (a, b) swaps in order)
            cur = list(range(len(perm)))
            swaps = []
            for i, want in enumerate(perm):
                j = cur.index(want)
                if j != i:
                    swaps.append((i + 1, j + 1))
                    cur[i], cur[j] = cur[j], cur[i]
            from bigdl_tpu_torch.nn.module import Identity

            mod = L.Transpose(swaps) if swaps else Identity()
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("BatchMatMul", "BatchMatMulV2"):
            adj_x = nd.attr("adj_x")
            adj_y = nd.attr("adj_y")
            mod = T.MM(trans_a=bool(adj_x.b) if adj_x else False,
                       trans_b=bool(adj_y.b) if adj_y else False)
            return self._named(mod, nd)(
                self._build(ins[0]), self._build(ins[1]))

        if op == "ExpandDims":
            axis = int(self._const(ins[1]).reshape(-1)[0])
            if axis < 0:
                raise TFConversionException(
                    "ExpandDims with negative axis unsupported")
            image = self._is_image(ins[0])
            dim = self._map_axis(axis, image) if axis else axis
            mod = L.Unsqueeze(dim + 1)
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("ResizeBilinear", "ResizeNearestNeighbor"):
            from bigdl_tpu_torch.nn.layers_extra import (
                ResizeBilinear as _RB,
                ResizeNearestNeighbor as _RN,
            )

            size = self._const(ins[1]).reshape(-1).astype(int)
            oh, ow = int(size[0]), int(size[1])
            ac = nd.attr("align_corners")
            ac = bool(ac.b) if ac else False
            hp = nd.attr("half_pixel_centers")
            hp = bool(hp.b) if hp else False
            cls = _RB if op == "ResizeBilinear" else _RN
            mod = cls(oh, ow, align_corners=ac, half_pixel_centers=hp)
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("DepthToSpace", "SpaceToDepth"):
            from bigdl_tpu_torch.nn.layers_extra import (
                DepthToSpace as _D2S,
                SpaceToDepth as _S2D,
            )

            bs = nd.attr("block_size")
            bs = int(bs.i) if bs and bs.i else 2
            fmt = nd.attr("data_format")
            if fmt and fmt.s and fmt.s not in ("NHWC", "NCHW"):
                raise TFConversionException(
                    f"{op} data_format {fmt.s!r} unsupported")
            mod = _D2S(bs) if op == "DepthToSpace" else _S2D(bs)
            return self._named(mod, nd)(self._build(ins[0]))

        if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            scale = self._const(ins[1])
            offset = self._const(ins[2])
            mean = self._const(ins[3])
            var = self._const(ins[4])
            eps = nd.attr("epsilon")
            eps = eps.fl if eps else 1e-3
            c = scale.size
            mod = L.SpatialBatchNormalization(c, eps=eps, affine=True)
            self._set(mod, "weight", scale.reshape(-1))
            self._set(mod, "bias", offset.reshape(-1))
            self._set(mod, "running_mean", mean.reshape(-1))
            self._set(mod, "running_var", var.reshape(-1))
            mod.evaluate()
            return self._named(mod, nd)(self._build(ins[0]))

        raise TFConversionException(f"unsupported TF op {op} ({nd.name})")

    @staticmethod
    def _named(mod, nd: _NodeDef):
        mod.set_name(nd.name)
        return mod

    def _set(self, mod, name: str, value: np.ndarray) -> None:
        """Copy ``value`` into ``mod``'s parameter or buffer ``name``, an
        f32 tensor on the loader's device."""
        _assign(mod.to(self.device), name, value)

    # ------------------------------------------------------------------
    # input-pipeline extraction (the reference BigDLSessionImpl's reason
    # to exist: run TF graphs whose INPUT side is a reader/queue/
    # ParseExample pipeline)
    # ------------------------------------------------------------------

    _QUEUE_OPS = ("FIFOQueueV2", "FIFOQueue", "RandomShuffleQueueV2",
                  "RandomShuffleQueue", "PaddingFIFOQueueV2",
                  "PaddingFIFOQueue")
    _PIPELINE_OPS = _QUEUE_OPS + (
        "TFRecordReaderV2", "TFRecordReader", "ReaderReadV2", "ReaderRead",
        "QueueEnqueueV2", "QueueEnqueue", "QueueEnqueueManyV2",
        "QueueEnqueueMany", "QueueDequeueV2", "QueueDequeue",
        "QueueDequeueManyV2", "QueueDequeueMany", "QueueDequeueUpToV2",
        "QueueCloseV2", "QueueClose", "ParseExample", "DecodeRaw",
    )

    def has_input_pipeline(self) -> bool:
        return any(n.op == "ParseExample" for n in self.nodes.values())

    def extract_input_pipeline(self, filenames=None):
        """Lift the reader -> queue -> ParseExample (-> DecodeRaw)
        subgraph out of the GraphDef into a host-side
        :class:`~bigdl_tpu_torch.utils.tf_records.TFRecordExampleDataset`.

        The queue-dequeue boundary becomes an iterator seam: the parse/
        decode output tensors turn into the converted model's Input
        nodes, and the records themselves are read host-side (CPU
        decode feeding the device, in place of the reference's
        executor-side queue runners).  ``filenames``
        overrides the file list baked into the graph's string Consts.
        """
        from bigdl_tpu_torch.utils.tf_records import (
            FixedLenFeature,
            TFRecordExampleDataset,
        )

        if not hasattr(self, "_consts"):
            self._consts = {}
        parse_nodes = [n for n in self.nodes.values()
                       if n.op == "ParseExample"]
        if not parse_nodes:
            raise TFConversionException("graph has no ParseExample node")
        if len(parse_nodes) > 1:
            raise TFConversionException(
                "multiple ParseExample pipelines unsupported")
        parse = parse_nodes[0]
        ins = self._data_inputs(parse)
        nsparse = int(parse.attr("Nsparse").i or 0) \
            if parse.attr("Nsparse") else 0
        if nsparse:
            raise TFConversionException(
                "ParseExample sparse features unsupported")
        tdense = parse.attr("Tdense").types if parse.attr("Tdense") else []
        nd_attr = parse.attr("Ndense")
        ndense = int(nd_attr.i) if nd_attr and nd_attr.i else len(tdense)
        shapes = parse.attr("dense_shapes").shapes \
            if parse.attr("dense_shapes") else []
        serialized = ins[0]
        key_refs = ins[2:2 + ndense]
        default_refs = ins[2 + ndense:2 + 2 * ndense]
        keys = []
        for r in key_refs:
            kv = self._const(r).reshape(-1)[0]
            keys.append(kv.decode() if isinstance(kv, bytes) else str(kv))

        # upstream walk from the serialized tensor: collect every
        # pipeline-side node, the dequeue batch size, and the filename
        # string Consts feeding the reader chain (enqueue ops CONSUME
        # their queue, so each queue hop restarts the walk from its
        # enqueues' values)
        pipeline_nodes = {parse.name}
        batch_size = None
        graph_files: List[str] = []
        frontier = [_clean(serialized)]
        seen = set()
        while frontier:
            name = frontier.pop()
            if name in seen or name not in self.nodes:
                continue
            seen.add(name)
            nd = self.nodes[name]
            pipeline_nodes.add(name)
            if nd.op in ("QueueDequeueManyV2", "QueueDequeueMany",
                         "QueueDequeueUpToV2") and batch_size is None:
                try:
                    batch_size = int(
                        self._const(
                            self._data_inputs(nd)[1]).reshape(-1)[0])
                except TFConversionException:
                    pass
            if nd.op in self._QUEUE_OPS:
                for other in self.nodes.values():
                    if not other.op.startswith("QueueEnqueue"):
                        continue
                    oins = self._data_inputs(other)
                    if oins and _clean(oins[0]) == name:
                        pipeline_nodes.add(other.name)
                        frontier.extend(_clean(i) for i in oins[1:])
            if nd.op == "Const":
                a = nd.attr("value")
                arr = a.tensor if a else None
                if arr is not None and arr.dtype == object:
                    graph_files.extend(
                        b.decode() if isinstance(b, bytes) else str(b)
                        for b in arr.reshape(-1))
            frontier.extend(_clean(i) for i in self._data_inputs(nd))

        # consumer map (raw "node:k" spelling, as consumers write it)
        consumers: Dict[str, List[str]] = {}
        for n in self.nodes.values():
            for i in n.inputs:
                raw = i[1:] if i.startswith("^") else i
                consumers.setdefault(raw, []).append(n.name)

        spec: Dict[str, FixedLenFeature] = {}
        transforms: Dict[str, object] = {}
        seam_refs: List[str] = []
        seam_keys: List[str] = []
        def _cons_of(*refs):
            out = []
            for r in refs:
                out.extend(consumers.get(r, []))
            return out

        for k, key in enumerate(keys):
            ref = parse.name if k == 0 else f"{parse.name}:{k}"
            dt = tdense[k] if k < len(tdense) else _DT_FLOAT
            shape = tuple(s for s in (shapes[k] if k < len(shapes) else [])
                          if s >= 0)
            default = None
            if k < len(default_refs):
                try:
                    dv = self._const(default_refs[k])
                    if dv.size:
                        default = dv.reshape(-1)[0]
                except TFConversionException:
                    pass
            # output 0 may be spelled "name" or "name:0" by consumers
            refs = (ref, f"{ref}:0") if k == 0 else (ref,)
            cons = [c for c in _cons_of(*refs)
                    if c not in pipeline_nodes]
            decoders = [c for c in cons
                        if self.nodes[c].op == "DecodeRaw"]
            if dt == _DT_STRING or decoders:
                if not decoders:
                    raise TFConversionException(
                        f"string feature {key!r} has no DecodeRaw "
                        "consumer — cannot feed the device")
                dr = self.nodes[decoders[0]]
                out_t = dr.attr("out_type")
                np_dt = _DT_NP.get(out_t.type if out_t else _DT_FLOAT,
                                   np.float32)
                le = dr.attr("little_endian")
                le = bool(le.b) if le and le.b is not None else True
                wire_dt = np.dtype(np_dt).newbyteorder("<" if le else ">")
                spec[key] = FixedLenFeature((), bytes)
                transforms[key] = (
                    lambda b, _w=wire_dt, _n=np_dt: np.frombuffer(
                        b, dtype=_w).astype(_n))
                pipeline_nodes.add(dr.name)
                seam = dr.name
                consumed = any(c not in pipeline_nodes
                               for c in _cons_of(seam, seam + ":0"))
            else:
                np_dt = _DT_NP.get(dt, np.float32)
                spec[key] = FixedLenFeature(shape, np_dt, default)
                seam = ref
                consumed = bool(cons)
            if consumed:
                seam_refs.append(seam)
                seam_keys.append(key)

        dataset = TFRecordExampleDataset(
            list(filenames) if filenames is not None else graph_files,
            spec, batch_size=batch_size or 32, transforms=transforms)
        return TFInputPipeline(dataset, seam_refs, seam_keys,
                               batch_size or 32, pipeline_nodes)

    def model_outputs(self, exclude=()):
        """Auto-detect output nodes, ignoring the pipeline side (queue
        enqueues/closers are sinks but not model outputs)."""
        exclude = set(exclude)
        consumed = set()
        for n in self.nodes.values():
            if n.name in exclude:
                continue
            consumed.update(_clean(i) for i in n.inputs)
        return [name for name, n in self.nodes.items()
                if name not in consumed and name not in exclude
                and n.op not in ("Const", "Placeholder")
                and n.op not in self._PIPELINE_OPS]


class TFInputPipeline:
    """A lifted TF-graph input pipeline: the host-side dataset plus the
    seam tensors where data crosses into the converted model."""

    def __init__(self, dataset, seam_refs, seam_keys, batch_size, nodes):
        self.dataset = dataset
        self.seam_refs = list(seam_refs)  # model Input refs, in order
        self.seam_keys = list(seam_keys)  # Example key per seam
        self.batch_size = batch_size
        self.nodes = set(nodes)  # pipeline-side node names

    def feature_table(self):
        """Materialize the records: ([per-seam array, ...], full table)."""
        table = self.dataset.materialize()
        return [table[k] for k in self.seam_keys], table

    def batches(self, drop_remainder=False):
        for b in self.dataset.batches(drop_remainder=drop_remainder):
            yield [b[k] for k in self.seam_keys], b


def load_tf(path: str, inputs=None, outputs=None, device="cuda"):
    """Reference: ``Module.loadTF(path, inputs, outputs)``."""
    return TensorflowLoader(path, device=device).load(inputs, outputs)


def _on(x, device):
    """A feed (array, tensor or a table of them) as tensors on
    ``device``."""
    if isinstance(x, (tuple, list)):
        return tuple(_on(v, device) for v in x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class TFTrainingSession:
    """Reference: «bigdl»/utils/tf/BigDLSessionImpl.scala (a session
    that runs imported TF graphs for training, not just inference).

    The imported graph's weights are ordinary module parameters, so
    autograd flows gradients through every converted op, and ``train``
    fine-tunes the graph under the port's ``LocalOptimizer`` or
    ``DistriOptimizer`` on ``device`` (the card unless the caller asks
    for the CPU).  A graph that ships its own input side (TFRecord
    reader, queues, ``ParseExample``) has it lifted onto the host
    (``extract_input_pipeline``).
    """

    def __init__(self, path: Optional[str] = None,
                 data: Optional[bytes] = None, inputs=None, outputs=None,
                 filenames=None, device="cuda"):
        self.loader = TensorflowLoader(path=path, data=data, device=device)
        self.device = self.loader.device
        self.pipeline = None
        if inputs is None and self.loader.has_input_pipeline():
            self.pipeline = self.loader.extract_input_pipeline(
                filenames=filenames)
            inputs = self.pipeline.seam_refs
            if outputs is None:
                outputs = self.loader.model_outputs(
                    exclude=self.pipeline.nodes)
        self.model = self.loader.load(inputs=inputs, outputs=outputs)
        self._optimizer = None

    # reference: Session.run(endpoints, feed) — frozen inference
    def run(self, feed):
        self.model.evaluate()
        with torch.no_grad():
            return self.model(_on(feed, self.device))

    def train(self, dataset, criterion, optim_method=None, batch_size=32,
              end_trigger=None, distributed=False):
        """Fine-tune the imported graph.  ``distributed=True`` submits
        to DistriOptimizer (the reference session's ``train(outputs,
        rdd)`` path); otherwise LocalOptimizer."""
        if distributed:
            from bigdl_tpu_torch.optim.distri_optimizer import \
                DistriOptimizer

            opt = DistriOptimizer(self.model, dataset, criterion,
                                  batch_size=batch_size, device=self.device)
        else:
            from bigdl_tpu_torch.optim.optimizer import LocalOptimizer

            opt = LocalOptimizer(self.model, dataset, criterion,
                                 batch_size=batch_size, device=self.device)
        if optim_method is not None:
            opt.set_optim_method(optim_method)
        if end_trigger is not None:
            opt.set_end_when(end_trigger)
        self._optimizer = opt
        return opt.optimize()

    def train_with_pipeline(self, criterion, label_key,
                            label_transform=None, optim_method=None,
                            batch_size=None, end_trigger=None,
                            distributed=False):
        """Fine-tune end-to-end from the graph's OWN input pipeline:
        records are read host-side through the lifted TFRecord/
        ParseExample dataset, features feed the seam Inputs, and
        ``label_key`` names the Example feature used as the target
        (``label_transform`` adapts conventions, e.g. 0-based int64 ->
        1-based float for ClassNLLCriterion)."""
        if self.pipeline is None:
            raise TFConversionException(
                "graph has no input pipeline; use train(dataset, ...)")
        xs, table = self.pipeline.feature_table()
        if label_key not in table:
            raise KeyError(
                f"label key {label_key!r} not among parsed features "
                f"{sorted(table)}")
        y = np.asarray(table[label_key])
        if label_transform is not None:
            y = label_transform(y)
        x = xs[0] if len(xs) == 1 else tuple(xs)
        return self.train(
            (x, y), criterion, optim_method=optim_method,
            batch_size=batch_size or self.pipeline.batch_size,
            end_trigger=end_trigger, distributed=distributed)


# reference spelling
BigDLSessionImpl = TFTrainingSession


# ==========================================================================
# saver (GraphDef writer) + graph-builder helpers
# ==========================================================================


class GraphDefBuilder:
    """Minimal GraphDef writer — builds frozen graphs for export/tests."""

    def __init__(self):
        self.nodes: List[_WireWriter] = []

    def _node(self, name, op, inputs=(), attrs: Optional[dict] = None):
        n = _WireWriter()
        n.string(1, name)
        n.string(2, op)
        for i in inputs:
            n.string(3, i)
        for k, v in (attrs or {}).items():
            entry = _WireWriter()
            entry.string(1, k)
            entry.message(2, v)
            n.message(5, entry)
        self.nodes.append(n)
        return name

    @staticmethod
    def attr_tensor(arr: np.ndarray) -> _WireWriter:
        a = _WireWriter()
        a.message(8, _encode_tensor(arr))
        return a

    @staticmethod
    def attr_type(dt: int) -> _WireWriter:
        a = _WireWriter()
        a.varint(6, dt)
        return a

    @staticmethod
    def attr_s(s: str) -> _WireWriter:
        a = _WireWriter()
        a.string(2, s)
        return a

    @staticmethod
    def attr_b(b: bool) -> _WireWriter:
        a = _WireWriter()
        a.varint(5, 1 if b else 0)
        return a

    @staticmethod
    def attr_i(v: int) -> _WireWriter:
        a = _WireWriter()
        a.varint(3, v)
        return a

    @staticmethod
    def attr_f(x: float) -> _WireWriter:
        a = _WireWriter()
        a._put(_varint(4 << 3 | 5))
        a._put(struct.pack("<f", x))
        return a

    @staticmethod
    def attr_ints(vals: List[int]) -> _WireWriter:
        lst = _WireWriter()
        for v in vals:
            lst.varint(3, v)
        a = _WireWriter()
        a.message(1, lst)
        return a

    @staticmethod
    def attr_types(vals: List[int]) -> _WireWriter:
        """list(type) — ListValue.type (field 6)."""
        lst = _WireWriter()
        for v in vals:
            lst.varint(6, v)
        a = _WireWriter()
        a.message(1, lst)
        return a

    @staticmethod
    def attr_shapes(shapes: List[List[int]]) -> _WireWriter:
        """list(shape) — ListValue.shape (field 7)."""
        lst = _WireWriter()
        for sh in shapes:
            shape = _WireWriter()
            for d in sh:
                dim = _WireWriter()
                dim.varint(1, d)
                shape.message(2, dim)
            lst.message(7, shape)
        a = _WireWriter()
        a.message(1, lst)
        return a

    def placeholder(self, name, dtype=_DT_FLOAT):
        return self._node(name, "Placeholder", attrs={"dtype": self.attr_type(dtype)})

    def const(self, name, arr: np.ndarray):
        return self._node(name, "Const", attrs={
            "value": self.attr_tensor(arr),
            "dtype": self.attr_type(_DT_FLOAT),
        })

    def op(self, name, op, inputs, **attrs):
        return self._node(name, op, inputs, attrs)

    def tobytes(self) -> bytes:
        g = _WireWriter()
        for n in self.nodes:
            g.message(1, n)
        return g.tobytes()


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class TensorflowSaver:
    """Reference: «bigdl»/utils/tf/TensorflowSaver.scala — export a Graph
    of supported layers as a frozen GraphDef."""

    @staticmethod
    def save(graph, path: str):
        data = TensorflowSaver.to_graphdef(graph)
        with open(path, "wb") as f:
            f.write(data)

    @staticmethod
    def to_graphdef(graph) -> bytes:
        from bigdl_tpu_torch.nn import layers as L
        from bigdl_tpu_torch.nn import table_ops as T

        b = GraphDefBuilder()
        names: Dict[int, str] = {}
        counter = [0]

        for node in graph.topo_order():
            m = node.module
            if node in graph.input_nodes:
                nm = m._name or f"input{node.id}"
                b.placeholder(nm)
                names[node.id] = nm
                continue
            counter[0] += 1
            nm = m._name or f"{type(m).__name__.lower()}{counter[0]}"
            prev = [names[p.id] for p in node.prev_nodes]

            if isinstance(m, L.Linear):
                w = _host(m.weight).T  # (in, out)
                b.const(nm + "/w", np.ascontiguousarray(w))
                out = b.op(nm, "MatMul", [prev[0], nm + "/w"],
                           transpose_a=b.attr_b(False),
                           transpose_b=b.attr_b(False))
                if m.bias is not None:
                    b.const(nm + "/b", _host(m.bias))
                    out = b.op(nm + "/bias", "BiasAdd", [nm, nm + "/b"])
                names[node.id] = out
                continue
            simple = {
                L.ReLU: "Relu", L.ReLU6: "Relu6", L.Tanh: "Tanh",
                L.Sigmoid: "Sigmoid", L.SoftMax: "Softmax",
                L.LogSoftMax: "LogSoftmax", L.SoftPlus: "Softplus",
                L.Abs: "Abs", L.Exp: "Exp", L.Log: "Log",
                L.Square: "Square", L.Sqrt: "Sqrt", L.Negative: "Neg",
            }.get(type(m))
            if simple:
                names[node.id] = b.op(nm, simple, prev)
                continue
            if isinstance(m, T.CAddTable):
                out = prev[0]
                for i, p in enumerate(prev[1:]):
                    out = b.op(f"{nm}_{i}" if len(prev) > 2 else nm,
                               "AddV2", [out, p])
                names[node.id] = out
                continue
            if isinstance(m, T.JoinTable):
                b.const(nm + "/axis", np.asarray(m.dimension - 1, np.int32))
                names[node.id] = b.op(nm, "ConcatV2", prev + [nm + "/axis"],
                                      N=b.attr_ints([len(prev)]))
                continue
            if isinstance(m, L.SpatialConvolution) \
                    and type(m) is L.SpatialConvolution:
                # NCHW Conv2D; loader reads HWIO weights.  VALID for
                # pad 0, SAME when the pad is the stride-1 half-kernel
                if m.n_group != 1:
                    raise TFConversionException(
                        "TensorflowSaver: grouped conv unsupported")
                if m.pad_w == m.pad_h == 0:
                    padding = "VALID"
                elif (m.stride_w == m.stride_h == 1
                      and m.pad_w == (m.kernel_w - 1) // 2
                      and m.pad_h == (m.kernel_h - 1) // 2):
                    padding = "SAME"
                else:
                    raise TFConversionException(
                        "TensorflowSaver: conv padding has no TF "
                        "SAME/VALID equivalent")
                w = _host(m.weight)  # (O, I, kh, kw) -> HWIO
                b.const(nm + "/w",
                        np.ascontiguousarray(w.transpose(2, 3, 1, 0)))
                out = b.op(nm, "Conv2D", [prev[0], nm + "/w"],
                           strides=b.attr_ints(
                               [1, 1, m.stride_h, m.stride_w]),
                           padding=b.attr_s(padding),
                           data_format=b.attr_s("NCHW"))
                if m.with_bias and m.bias is not None:
                    b.const(nm + "/b", _host(m.bias))
                    out = b.op(nm + "/bias", "BiasAdd", [out, nm + "/b"],
                               data_format=b.attr_s("NCHW"))
                names[node.id] = out
                continue
            if isinstance(m, (L.SpatialMaxPooling, L.SpatialAveragePooling)):
                if getattr(m, "global_pooling", False):
                    raise TFConversionException(
                        "TensorflowSaver: global pooling unsupported")
                if m.pad_w or m.pad_h:
                    raise TFConversionException(
                        "TensorflowSaver: padded pooling unsupported")
                opn = "MaxPool" if isinstance(m, L.SpatialMaxPooling) \
                    else "AvgPool"
                names[node.id] = b.op(
                    nm, opn, prev,
                    ksize=b.attr_ints([1, 1, m.kh, m.kw]),
                    strides=b.attr_ints([1, 1, m.dh, m.dw]),
                    padding=b.attr_s("VALID"),
                    data_format=b.attr_s("NCHW"))
                continue
            if isinstance(m, L.SpatialBatchNormalization) \
                    and type(m) is L.SpatialBatchNormalization:
                c = m.n_output
                ones = np.ones(c, np.float32)
                zeros = np.zeros(c, np.float32)
                b.const(nm + "/scale",
                        _host(m.weight) if m.affine else ones)
                b.const(nm + "/offset",
                        _host(m.bias) if m.affine else zeros)
                b.const(nm + "/mean", _host(m.running_mean))
                b.const(nm + "/var", _host(m.running_var))
                names[node.id] = b.op(
                    nm, "FusedBatchNorm",
                    [prev[0], nm + "/scale", nm + "/offset",
                     nm + "/mean", nm + "/var"],
                    epsilon=b.attr_f(m.eps),
                    data_format=b.attr_s("NCHW"))
                continue
            if isinstance(m, L.Reshape):
                b.const(nm + "/shape",
                        np.asarray([-1] + list(m.size), np.int32))
                names[node.id] = b.op(nm, "Reshape",
                                      [prev[0], nm + "/shape"])
                continue
            if isinstance(m, L.Squeeze):
                attrs = {}
                if m.dim is not None:
                    attrs["squeeze_dims"] = b.attr_ints([m.dim - 1])
                names[node.id] = b.op(nm, "Squeeze", prev, **attrs)
                continue
            if isinstance(m, L.Dropout) or type(m).__name__ == "Identity":
                # frozen-inference semantics: dropout exports as identity
                names[node.id] = b.op(nm, "Identity", prev)
                continue
            raise TFConversionException(
                f"TensorflowSaver: unsupported layer {type(m).__name__}"
            )
        return b.tobytes()
