"""The reference's ``bigdl.proto`` module interchange: ``ModulePersister``
and ``ModuleLoader``.

Counterpart of ``bigdl_tpu/utils/bigdl_proto.py`` (the whole module).
A module tree is one ``BigDLModule`` protobuf message: ``moduleType``
is the Scala class name, the constructor arguments ride in the ``attr``
map under the reference's camelCase spellings (``n_input_plane`` <->
``nInputPlane``), containers recurse through ``subModules``, parameters
ride as ``BigDLTensor``s (``weight``, ``bias``, then the others in
``param_names`` order under ``parameters``), and a ``Graph``'s wiring
uses ``preModules``/``nextModules`` name lists with the input and output
node names as attributes.  A value with no typed slot is a STRING attr
with ``subType="json"``, as the JAX module writes it.  The codec is the
port's own wire reader and writer (``utils/caffe.py``); no protoc.

What the port adds, as the reference's BatchNormalization serializer
does: a leaf module's state tensors (``state_names``, BN's running
mean and variance) ride as tensor attrs (``runningMean``,
``runningVar``), so a trained model's running statistics survive the
file.  The JAX loader keeps only the attrs its constructors take, so
it reads the port's files as it reads its own (with fresh running
statistics); a JAX file loads here with the module's initial state.

A module is rebuilt on the CPU (a class that takes ``device=`` is
given ``"cpu"``, as ``serializer.spec_to_module`` does); the caller
moves it.  The field numbers are the JAX module's reconstruction of the
upstream 0.x layout.
"""

from __future__ import annotations

import inspect
import json
import struct
from typing import Dict, List, Optional

import numpy as np

import torch

from bigdl_tpu_torch.utils.caffe import (_WT_FIX64, _WireWriter, _w_bool,
                                         _w_float, _w_floats, _w_int,
                                         _w_ints, _w_msgs, _w_str, _w_strs,
                                         parse_wire)

# ---------------------------------------------------------------- schema
# DataType enum (bigdl.proto)
DT_INT32 = 0
DT_INT64 = 1
DT_FLOAT = 2
DT_DOUBLE = 3
DT_STRING = 4
DT_BOOL = 5
DT_TENSOR = 10
DT_MODULE = 13
DT_ARRAY_VALUE = 15

# BigDLModule fields
_M_NAME = 1
_M_SUBMODULES = 2
_M_WEIGHT = 3
_M_BIAS = 4
_M_PREMODULES = 5
_M_NEXTMODULES = 6
_M_MODULETYPE = 7
_M_ATTR = 8            # map<string, AttrValue>
_M_VERSION = 9
_M_TRAIN = 10
_M_NAMEPOSTFIX = 11
_M_ID = 12
_M_HASPARAMETERS = 15
_M_PARAMETERS = 16

# BigDLTensor fields
_T_DATATYPE = 1
_T_SIZE = 2
_T_STRIDE = 3
_T_OFFSET = 4
_T_DIMENSION = 5
_T_NELEMENTS = 6
_T_ISSCALAR = 7
_T_STORAGE = 8
_T_ID = 9
_T_TENSORTYPE = 10

# TensorStorage fields
_S_DATATYPE = 1
_S_FLOAT_DATA = 2
_S_DOUBLE_DATA = 3
_S_INT32_DATA = 4
_S_INT64_DATA = 5
_S_ID = 9

# AttrValue fields
_A_DATATYPE = 1
_A_SUBTYPE = 2
_A_INT32 = 3
_A_INT64 = 4
_A_FLOAT = 5
_A_DOUBLE = 6
_A_STRING = 7
_A_BOOL = 8
_A_TENSOR = 10
_A_MODULE = 13
_A_ARRAY = 15

# ArrayValue fields
_AR_SIZE = 1
_AR_DATATYPE = 2
_AR_I32 = 3
_AR_I64 = 4
_AR_FLT = 5
_AR_DBL = 6
_AR_STR = 7
_AR_BOOL = 8

_SCALA_PKG = "com.intel.analytics.bigdl.nn."
_VERSION = "0.13.0"


# ---------------------------------------------------------- name bridge
def snake_to_camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def camel_to_snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


# reference attr spellings that are not mechanical camelCase of ours
_TO_SCALA = {
    "n_input_plane": "nInputPlane",
    "n_output_plane": "nOutputPlane",
    "n_group": "nGroup",
    "n_output": "nOutput",
    "input_size": "inputSize",
    "hidden_size": "hiddenSize",
    "output_size": "outputSize",
    "init_p": "initP",
    # Python keyword collision: SoftShrink/HardShrink's Scala arg
    "lambda_": "lambda",
}
_FROM_SCALA = {v: k for k, v in _TO_SCALA.items()}


def _attr_to_scala(name: str) -> str:
    return _TO_SCALA.get(name, snake_to_camel(name))


def _attr_from_scala(name: str) -> str:
    return _FROM_SCALA.get(name, camel_to_snake(name))


def _put_double(w: _WireWriter, fno: int, value: float) -> None:
    """A fixed64 double field (the JAX writer's ``_varint`` + pack)."""
    w._key(fno, _WT_FIX64)
    w._put(struct.pack("<d", float(value)))


def _host(v) -> np.ndarray:
    return v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


# ------------------------------------------------------------- tensors
def _write_tensor(arr: np.ndarray) -> _WireWriter:
    arr = np.asarray(arr)
    t = _WireWriter()
    t.varint(_T_DATATYPE, DT_FLOAT)
    for s in arr.shape:
        t.varint(_T_SIZE, int(s))
    # torch-style contiguous strides
    stride = []
    acc = 1
    for s in reversed(arr.shape):
        stride.insert(0, acc)
        acc *= int(s)
    for s in stride:
        t.varint(_T_STRIDE, int(s))
    t.varint(_T_OFFSET, 1)  # reference tensors are 1-based offset
    t.varint(_T_DIMENSION, arr.ndim)
    t.varint(_T_NELEMENTS, int(arr.size))
    if arr.ndim == 0:
        t.varint(_T_ISSCALAR, 1)
    st = _WireWriter()
    st.varint(_S_DATATYPE, DT_FLOAT)
    st.packed_floats(_S_FLOAT_DATA, np.asarray(arr, "<f4").reshape(-1))
    t.message(_T_STORAGE, st)
    t.varint(_T_TENSORTYPE, 0)  # DENSE
    return t


def _read_tensor(msg: Dict[int, list]) -> Optional[np.ndarray]:
    storage = _w_msgs(msg, _T_STORAGE)
    if not storage:
        return None
    data = _w_floats(storage[0], _S_FLOAT_DATA)
    if data.size == 0:
        dd = storage[0].get(_S_DOUBLE_DATA)
        if dd:
            data = np.concatenate(
                [np.frombuffer(v, "<f8") for _, v in dd]).astype(np.float32)
    size = _w_ints(msg, _T_SIZE)
    if size and int(np.prod(size)) == data.size:
        data = data.reshape(size)
    return data


# ---------------------------------------------------------- attr values
def _write_attr(value) -> _WireWriter:
    a = _WireWriter()
    if isinstance(value, bool):
        a.varint(_A_DATATYPE, DT_BOOL)
        a.varint(_A_BOOL, int(value))
    elif isinstance(value, (int, np.integer)):
        a.varint(_A_DATATYPE, DT_INT32)
        a.varint(_A_INT32, int(value))
    elif isinstance(value, (float, np.floating)):
        a.varint(_A_DATATYPE, DT_DOUBLE)
        _put_double(a, _A_DOUBLE, value)
    elif isinstance(value, str):
        a.varint(_A_DATATYPE, DT_STRING)
        a.string(_A_STRING, value)
    elif isinstance(value, (np.ndarray, torch.Tensor)):
        value = _host(value)
        a.varint(_A_DATATYPE, DT_TENSOR)
        a.message(_A_TENSOR, _write_tensor(value))
    elif isinstance(value, (list, tuple)) and _is_flat_numeric(value):
        a.varint(_A_DATATYPE, DT_ARRAY_VALUE)
        arr = _WireWriter()
        arr.varint(_AR_SIZE, len(value))
        if all(isinstance(v, (int, np.integer))
               and not isinstance(v, bool) for v in value):
            arr.varint(_AR_DATATYPE, DT_INT32)
            for v in value:
                arr.varint(_AR_I32, int(v))
        else:
            arr.varint(_AR_DATATYPE, DT_DOUBLE)
            for v in value:
                _put_double(arr, _AR_DBL, v)
        a.message(_A_ARRAY, arr)
    else:
        # documented extension: JSON spill for configs with no typed slot
        a.varint(_A_DATATYPE, DT_STRING)
        a.string(_A_SUBTYPE, "json")
        a.string(_A_STRING, json.dumps(value))
    return a


def _is_flat_numeric(value) -> bool:
    return all(
        isinstance(v, (int, float, np.integer, np.floating))
        for v in value
    ) and len(value) > 0


def _read_attr(msg: Dict[int, list]):
    dt = _w_int(msg, _A_DATATYPE, DT_STRING)
    if dt == DT_BOOL:
        return bool(_w_int(msg, _A_BOOL, 0))
    if dt == DT_INT32:
        return _w_int(msg, _A_INT32, 0)
    if dt == DT_INT64:
        return _w_int(msg, _A_INT64, 0)
    if dt == DT_FLOAT:
        return _w_float(msg, _A_FLOAT, 0.0)
    if dt == DT_DOUBLE:
        raws = msg.get(_A_DOUBLE)
        if raws:
            return struct.unpack("<d", bytes(raws[-1][1]))[0]
        return 0.0
    if dt == DT_STRING:
        s = _w_str(msg, _A_STRING, "")
        if _w_str(msg, _A_SUBTYPE) == "json":
            return json.loads(s)
        return s
    if dt == DT_TENSOR:
        tensors = _w_msgs(msg, _A_TENSOR)
        return _read_tensor(tensors[0]) if tensors else None
    if dt == DT_ARRAY_VALUE:
        arrays = _w_msgs(msg, _A_ARRAY)
        if not arrays:
            return []
        arr = arrays[0]
        adt = _w_int(arr, _AR_DATATYPE, DT_INT32)
        if adt == DT_INT32:
            return _w_ints(arr, _AR_I32)
        if adt == DT_DOUBLE:
            out = []
            for wt, v in arr.get(_AR_DBL, []):
                if wt == 1:  # fixed64
                    out.append(struct.unpack("<d", bytes(v))[0])
                else:  # packed
                    out.extend(np.frombuffer(v, "<f8").tolist())
            return out
        if adt == DT_FLOAT:
            return _w_floats(arr, _AR_FLT).tolist()
        if adt == DT_STRING:
            return _w_strs(arr, _AR_STR)
    return None


# ------------------------------------------------------------ persister
class ModulePersister:
    """Reference: ModulePersister.saveToFile — serialize a module tree to
    the bigdl.proto wire format."""

    @staticmethod
    def save(module, path: str) -> str:
        data = ModulePersister.to_bytes(module)
        with open(path, "wb") as f:
            f.write(data)
        return path

    @staticmethod
    def to_bytes(module) -> bytes:
        return _module_to_writer(module).tobytes()


def _name_of(module) -> str:
    """The module's name, or the JAX ``get_name`` default
    (``Class@id``), which the loader does not restore."""
    return module._name or f"{type(module).__name__}@{id(module):x}"


def _attr_entry(w: _WireWriter, key: str, value) -> None:
    entry = _WireWriter()
    entry.string(1, key)
    entry.message(2, _write_attr(value))
    w.message(_M_ATTR, entry)


def _module_to_writer(module) -> _WireWriter:
    from bigdl_tpu_torch.nn.graph import Graph
    from bigdl_tpu_torch.nn.module import Composite, Container

    w = _WireWriter()
    w.string(_M_NAME, _name_of(module))
    w.string(_M_MODULETYPE, _SCALA_PKG + type(module).__name__)
    w.string(_M_VERSION, _VERSION)
    w.varint(_M_TRAIN, int(module.training))

    # constructor attrs
    for key, value in module.get_config().items():
        _attr_entry(w, _attr_to_scala(key), value)

    if isinstance(module, Graph):
        _write_graph(w, module)
        return w

    if isinstance(module, Container):
        for child in module.modules:
            w.message(_M_SUBMODULES, _module_to_writer(child))
        return w

    if isinstance(module, Composite):
        # named children (TransformerBlock, TransformerLM): each rides
        # as a subModule tagged with its slot name in namePostfix
        for key, child in module._modules.items():
            sub = _module_to_writer(child)
            sub.string(_M_NAMEPOSTFIX, key)
            w.message(_M_SUBMODULES, sub)
        return w

    # state tensors as attrs (the port's addition, module docstring)
    for sname, value in module.state().items():
        _attr_entry(w, _attr_to_scala(sname), _host(value))
    # leaf parameters: weight/bias ride the dedicated fields when the
    # module uses the classic pair; everything else via `parameters`
    params = list(module.params().items())
    if params:
        w.varint(_M_HASPARAMETERS, 1)
    for pname, arr in params:
        if pname == "weight":
            w.message(_M_WEIGHT, _write_tensor(_host(arr)))
        elif pname == "bias":
            w.message(_M_BIAS, _write_tensor(_host(arr)))
        else:
            w.message(_M_PARAMETERS, _write_tensor(_host(arr)))
    return w


def _write_graph(w: _WireWriter, graph) -> None:
    """Graph wiring via preModules/nextModules name lists (reference:
    StaticGraph serialization), each node named ``<name>#<topological
    index>``.  A ``DynamicGraph``'s feedback edges and condition node
    ride as named attrs (``feedbackFrom``, ``dynamicCondition``), as
    JAX writes them, and ``maxIterations`` with its config."""
    names = {}
    for i, node in enumerate(graph.topo_order()):
        names[node.id] = f"{_name_of(node.module)}#{i}"
    for node in graph.topo_order():
        sub = _module_to_writer(node.module)
        sub.string(_M_NAMEPOSTFIX, names[node.id])
        for p in node.prev_nodes:
            sub.string(_M_PREMODULES, names[p.id])
        if node.feedback_node is not None:
            entry = _WireWriter()
            entry.string(1, "feedbackFrom")
            entry.message(2, _write_attr(names[node.feedback_node.id]))
            sub.message(_M_ATTR, entry)
        w.message(_M_SUBMODULES, sub)
    # record input/output node names as attrs
    for key, nodes in (("graphInputs", graph.input_nodes),
                       ("graphOutputs", graph.output_nodes)):
        entry = _WireWriter()
        entry.string(1, key)
        val = _WireWriter()
        val.varint(_A_DATATYPE, DT_ARRAY_VALUE)
        arr = _WireWriter()
        arr.varint(_AR_SIZE, len(nodes))
        arr.varint(_AR_DATATYPE, DT_STRING)
        for n in nodes:
            arr.string(_AR_STR, names[n.id])
        val.message(_A_ARRAY, arr)
        entry.message(2, val)
        w.message(_M_ATTR, entry)
    cond = getattr(graph, "_condition_node", None)
    if cond is not None:
        entry = _WireWriter()
        entry.string(1, "dynamicCondition")
        entry.message(2, _write_attr(names[cond.id]))
        w.message(_M_ATTR, entry)


# -------------------------------------------------------------- loader
class ModuleLoader:
    """Reference: ModuleLoader.loadFromFile — parse the bigdl.proto wire
    format back into a live module tree."""

    @staticmethod
    def load(path: str):
        with open(path, "rb") as f:
            data = f.read()
        return ModuleLoader.from_bytes(data)

    @staticmethod
    def from_bytes(data: bytes):
        return _module_from_fields(parse_wire(data))


def _class_for(module_type: str):
    from bigdl_tpu_torch.utils.serializer import lookup_module_class

    cls_name = module_type.rsplit(".", 1)[-1]
    try:
        return lookup_module_class(cls_name)
    except KeyError:
        raise KeyError(
            f"unknown module type {module_type!r}; register_module() "
            "custom layers before loading"
        ) from None


def _construct(cls, attrs: dict):
    """Build cls from the attr map, keeping only args the constructor
    knows (the reference's reflection does the same per converter) and
    never a state tensor; a class that places itself (``device=``) is
    built on the CPU."""
    sig = inspect.signature(cls.__init__)
    accepted = {
        k for k in sig.parameters if k not in ("self", "args", "kwargs")
    }
    var_kw = any(
        p.kind == inspect.Parameter.VAR_KEYWORD
        for p in sig.parameters.values()
    )
    state = set(getattr(cls, "state_names", ()))
    kwargs = {}
    for k, v in attrs.items():
        if (k in accepted or var_kw) and k not in state:
            kwargs[k] = v
    if "device" in sig.parameters:
        kwargs.setdefault("device", "cpu")
    return cls(**kwargs)


def _set_tensor(module, name: str, arr, state: bool = False) -> None:
    """Copy ``arr`` into the module's parameter (or buffer) ``name``."""
    cur = getattr(module, name)
    value = torch.from_numpy(np.array(arr, np.float32).reshape(
        tuple(cur.shape)))
    if state:
        module.set_state({name: value})
    else:
        module.set_params({name: value})


def _module_from_fields(f: Dict[int, list]):
    from bigdl_tpu_torch.nn.graph import Graph
    from bigdl_tpu_torch.nn.module import Composite, Container

    module_type = _w_str(f, _M_MODULETYPE, "")
    cls = _class_for(module_type)
    attrs = {}
    raw_attrs = {}
    for entry in _w_msgs(f, _M_ATTR):
        key = _w_str(entry, 1, "")
        vals = _w_msgs(entry, 2)
        if not vals:
            continue
        raw_attrs[key] = _read_attr(vals[0])
        attrs[_attr_from_scala(key)] = raw_attrs[key]

    attrs.pop("feedback_from", None)       # a graph node's back-edge
    subs = _w_msgs(f, _M_SUBMODULES)
    if issubclass(cls, Graph):
        module = _graph_from_fields(f, subs, raw_attrs, cls)
    else:
        module = _construct(cls, attrs)
        if issubclass(cls, Container) and subs:
            module.modules = [_module_from_fields(sub) for sub in subs]
        elif isinstance(module, Composite) and subs:
            # restore named children by slot name (written in namePostfix)
            for sub in subs:
                key = _w_str(sub, _M_NAMEPOSTFIX, "")
                if key and key in module._modules:
                    module.add_module(key, _module_from_fields(sub))

    name = _w_str(f, _M_NAME)
    if name and "@" not in name:
        module.set_name(name)
    if not _w_bool(f, _M_TRAIN, True):
        module.evaluate()

    # parameters back in declaration order, then the state attrs
    if not issubclass(cls, (Container, Composite)):
        present = [n for n in getattr(module, "param_names", ())
                   if getattr(module, n, None) is not None]
        for pname, fno in (("weight", _M_WEIGHT), ("bias", _M_BIAS)):
            msgs = _w_msgs(f, fno) if pname in present else None
            if msgs:
                arr = _read_tensor(msgs[0])
                if arr is not None:
                    _set_tensor(module, pname, arr)
        others = [n for n in present if n not in ("weight", "bias")]
        for pname, msg in zip(others, _w_msgs(f, _M_PARAMETERS)):
            arr = _read_tensor(msg)
            if arr is not None:
                _set_tensor(module, pname, arr)
        for sname in getattr(module, "state_names", ()):
            arr = attrs.get(sname)
            if isinstance(arr, np.ndarray) \
                    and getattr(module, sname, None) is not None:
                _set_tensor(module, sname, arr, state=True)
    return module


def _sub_attr(sub, key: str):
    """Read one named attr from a subModule message."""
    for entry in _w_msgs(sub, _M_ATTR):
        if _w_str(entry, 1, "") == key:
            vals = _w_msgs(entry, 2)
            return _read_attr(vals[0]) if vals else None
    return None


def _graph_from_fields(f, subs, raw_attrs, cls=None):
    from bigdl_tpu_torch.nn.graph import DynamicGraph, Graph, Node

    nodes = {}
    wiring = []
    for sub in subs:
        post = _w_str(sub, _M_NAMEPOSTFIX, "")
        nodes[post] = Node(_module_from_fields(sub), [])
        wiring.append((post, _w_strs(sub, _M_PREMODULES)))
    for post, prevs in wiring:
        nodes[post].prev_nodes.extend(nodes[p] for p in prevs)
    for sub in subs:
        fb = _sub_attr(sub, "feedbackFrom")
        if fb:
            nodes[_w_str(sub, _M_NAMEPOSTFIX, "")].feedback_from(nodes[fb])
    inputs = [nodes[n] for n in raw_attrs.get("graphInputs", [])]
    outputs = [nodes[n] for n in raw_attrs.get("graphOutputs", [])]
    if cls is not None and issubclass(cls, DynamicGraph):
        cond_name = raw_attrs.get("dynamicCondition")
        return cls(inputs, outputs,
                   max_iterations=int(raw_attrs.get("maxIterations", 32)),
                   condition=nodes.get(cond_name) if cond_name else None)
    return Graph(inputs, outputs)


# -------------------------------------------------------- parity names
def save_module_proto(module, path: str) -> str:
    """Reference spelling: Module.saveModule(path) (protobuf format)."""
    return ModulePersister.save(module, path)


def load_module_proto(path: str):
    """Reference spelling: Module.loadModule(path)."""
    return ModuleLoader.load(path)


__all__ = ["ModuleLoader", "ModulePersister", "camel_to_snake",
           "load_module_proto", "save_module_proto", "snake_to_camel"]
