"""Caffe interop: read and write ``.prototxt`` + ``.caffemodel``.

Counterpart of ``bigdl_tpu/utils/caffe.py``: the protobuf text parser
and printer (:28-140), the wire reader and writer (:143-300), the blob
codecs (:306-337), ``load_caffemodel`` with the V1 layer types (:339),
``CaffeLoader`` (:433-851: the layer mapping, BatchNorm + Scale merged
into one ``SpatialBatchNormalization``, Caffe's ceil-mode pooling
sizes and the ``(C, H, W)`` inference that sizes ``InnerProduct``'s
``Linear``), ``CaffePersister`` (:870-1066; Caffe has no LogSoftmax, so
``LogSoftMax`` is written as ``Softmax``), ``load_caffe_model`` and
``load_caffe_weights``.  The port keeps its own copy of the parsers
(the JAX module's are numpy only, but the port imports nothing of that
package); a file written by either package loads in the other.  The wire
helpers also carry the ``.bigdl`` format (``utils/bigdl_proto.py``).

No protobuf runtime: the schema slices upstream Caffe fixes are field
numbers here.  The reader walks ``memoryview`` slices of the file, so
a blob's floats are copied once, into their array; the writer keeps
every field as a list of parts (a blob's floats are a view of its host
array) and joins them once, so ``CaffePersister`` copies each weight to
the host and once into the file's bytes, and writes the file in one
``write``.

``CaffeLoader(..., device=...)`` builds the graph on the device (the
card unless the caller asks for the CPU): each layer is made, moved
there and given its blobs as f32 tensors on that device.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.common import resolve_device

# ==========================================================================
# protobuf text format (prototxt)
# ==========================================================================


def _tokenize_text(text: str):
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c.isspace():
            i += 1
        elif c in "{}:":
            out.append(c)
            i += 1
        elif c in "\"'":
            j = i + 1
            buf = []
            while j < n and text[j] != c:
                if text[j] == "\\":
                    j += 1
                buf.append(text[j])
                j += 1
            out.append(("STR", "".join(buf)))
            i = j + 1
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in "{}:#":
                j += 1
            out.append(("TOK", text[i:j]))
            i = j
    return out


def _coerce_scalar(raw: str):
    if raw in ("true", "True"):
        return True
    if raw in ("false", "False"):
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        return raw  # an enum identifier


def parse_prototxt(text: str) -> dict:
    """Protobuf text format as nested dicts; every field maps to a list
    of values (any field may repeat)."""
    toks = _tokenize_text(text)
    pos = 0

    def parse_block():
        nonlocal pos
        msg: dict = {}
        while pos < len(toks) and toks[pos] != "}":
            name = toks[pos][1]
            pos += 1
            if pos < len(toks) and toks[pos] == ":":
                pos += 1
                kind, raw = toks[pos]
                pos += 1
                val = raw if kind == "STR" else _coerce_scalar(raw)
                msg.setdefault(name, []).append(val)
            elif pos < len(toks) and toks[pos] == "{":
                pos += 1
                sub = parse_block()
                if pos >= len(toks) or toks[pos] != "}":
                    raise ValueError("bad prototxt: unbalanced block")
                pos += 1
                msg.setdefault(name, []).append(sub)
            else:
                raise ValueError(
                    f"bad prototxt near token {pos}: {toks[pos - 1]}")
        return msg

    return parse_block()


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        # enums (UPPERCASE) stay bare, everything else is quoted
        if v.isupper() or v.replace("_", "").isupper():
            return v
        return f'"{v}"'
    if isinstance(v, float):
        return repr(v)
    return str(v)


def format_prototxt(msg: dict, indent: int = 0) -> str:
    pad = "  " * indent
    lines = []
    for name, values in msg.items():
        for v in values:
            if isinstance(v, dict):
                lines.append(f"{pad}{name} {{")
                lines.append(format_prototxt(v, indent + 1))
                lines.append(f"{pad}}}")
            else:
                lines.append(f"{pad}{name}: {_fmt_value(v)}")
    return "\n".join(line for line in lines if line != "")


# ==========================================================================
# protobuf wire format (caffemodel)
# ==========================================================================

_WT_VARINT, _WT_FIX64, _WT_BYTES, _WT_FIX32 = 0, 1, 2, 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed(v: int) -> int:
    """A decoded varint as a protobuf int32/int64 (a negative value
    rides as 64-bit two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_wire(buf) -> Dict[int, list]:
    """One message as {field: [(wire type, value), ...]}; a bytes value
    is a ``memoryview`` slice of ``buf`` (no copy)."""
    mv = memoryview(buf)
    fields: Dict[int, list] = {}
    pos = 0
    end = len(mv)
    while pos < end:
        key, pos = _read_varint(mv, pos)
        fno, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(mv, pos)
        elif wt == _WT_FIX64:
            val = mv[pos:pos + 8]
            pos += 8
        elif wt == _WT_BYTES:
            ln, pos = _read_varint(mv, pos)
            val = mv[pos:pos + ln]
            pos += ln
        elif wt == _WT_FIX32:
            val = mv[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fno})")
        fields.setdefault(fno, []).append((wt, val))
    return fields


def _w_str(f: Dict[int, list], fno: int, default=None):
    if fno in f:
        return bytes(f[fno][-1][1]).decode("utf-8", "replace")
    return default


def _w_strs(f, fno) -> List[str]:
    """A repeated string field."""
    return [bytes(v).decode("utf-8", "replace") for _, v in f.get(fno, [])]


def _w_int(f, fno, default=None):
    if fno in f:
        return _signed(int(f[fno][-1][1]))
    return default


def _w_bool(f, fno, default=None):
    v = _w_int(f, fno, None)
    return default if v is None else bool(v)


def _w_float(f, fno, default=None):
    """A fixed32 float field (its last value)."""
    if fno in f:
        wt, v = f[fno][-1]
        if wt == _WT_FIX32:
            return struct.unpack("<f", v)[0]
    return default


def _w_ints(f, fno) -> List[int]:
    out = []
    for wt, v in f.get(fno, []):
        if wt == _WT_VARINT:
            out.append(_signed(int(v)))
        else:  # packed
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(_signed(x))
    return out


def _w_floats(f, fno) -> np.ndarray:
    """A repeated float field (fixed32 or packed) as a new f32 array."""
    chunks = [np.frombuffer(v, dtype="<f4") for wt, v in f.get(fno, [])
              if wt in (_WT_FIX32, _WT_BYTES)]
    if not chunks:
        return np.zeros((0,), np.float32)
    return np.concatenate(chunks).astype(np.float32, copy=False)


def _w_msgs(f, fno) -> List[Dict[int, list]]:
    return [parse_wire(v) for wt, v in f.get(fno, []) if wt == _WT_BYTES]


def _varint(x: int) -> bytes:
    if x < 0:  # protobuf int32/int64: 64-bit two's complement
        x += 1 << 64
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _WireWriter:
    """A message as a list of byte parts and their total size; a nested
    message's parts are spliced in, not joined, so ``tobytes`` is the
    only copy of the payload."""

    def __init__(self):
        self.parts: list = []
        self.size = 0

    def _put(self, b) -> None:
        self.parts.append(b)
        self.size += len(b)

    def _key(self, fno: int, wt: int) -> None:
        self._put(_varint(fno << 3 | wt))

    def varint(self, fno: int, val: int):
        self._key(fno, _WT_VARINT)
        self._put(_varint(int(val)))

    def string(self, fno: int, s: str):
        self.bytes_(fno, s.encode("utf-8"))

    def bytes_(self, fno: int, b):
        self._key(fno, _WT_BYTES)
        self._put(_varint(len(b)))
        self._put(b)

    def packed_floats(self, fno: int, arr: np.ndarray):
        """The floats as a view of ``arr`` (copied only if it is not
        C-contiguous little-endian f32): keep ``arr`` unchanged until
        ``tobytes``."""
        a = np.ascontiguousarray(arr, dtype="<f4").reshape(-1)
        self.bytes_(fno, memoryview(a).cast("B"))

    def message(self, fno: int, sub: "_WireWriter"):
        self._key(fno, _WT_BYTES)
        self._put(_varint(sub.size))
        self.parts.extend(sub.parts)
        self.size += sub.size

    def tobytes(self) -> bytes:
        return b"".join(self.parts)


# ==========================================================================
# caffemodel schema slices (field numbers of upstream caffe.proto)
# ==========================================================================

# V1LayerParameter.LayerType enum value -> V2 type string
_V1_TYPES = {
    1: "Accuracy", 2: "BNLL", 3: "Concat", 4: "Convolution", 5: "Data",
    6: "Dropout", 7: "EuclideanLoss", 8: "Flatten", 14: "InnerProduct",
    15: "LRN", 17: "Pooling", 18: "ReLU", 19: "Sigmoid", 20: "Softmax",
    21: "SoftmaxWithLoss", 22: "Split", 23: "TanH", 25: "Eltwise",
    26: "Power", 30: "ArgMax", 33: "Slice", 35: "AbsVal", 36: "Silence",
    39: "Deconvolution",
}


def _blob_to_array(blob: Dict[int, list]) -> np.ndarray:
    data = _w_floats(blob, 5)
    if data.size == 0:
        dd = blob.get(8)
        if dd:  # double_data
            data = np.concatenate(
                [np.frombuffer(v, dtype="<f8") for _, v in dd]
            ).astype(np.float32)
    shape_msgs = _w_msgs(blob, 7)
    if shape_msgs:
        dims = _w_ints(shape_msgs[0], 1)
    else:  # legacy num/channels/height/width
        dims = [_w_int(blob, 1, 1), _w_int(blob, 2, 1),
                _w_int(blob, 3, 1), _w_int(blob, 4, 1)]
        while len(dims) > 1 and dims[0] == 1:
            dims = dims[1:]
    if int(np.prod(dims)) != data.size:
        dims = [data.size]
    return data.reshape(dims)


def _array_to_blob(arr: np.ndarray) -> _WireWriter:
    w = _WireWriter()
    shape = _WireWriter()
    for d in arr.shape:
        shape.varint(1, d)
    w.message(7, shape)
    w.packed_floats(5, arr)
    return w


def load_caffemodel(path: str) -> Dict[str, dict]:
    """A ``.caffemodel`` as {layer name: {"type": str, "blobs": [f32
    arrays]}}, from V2 (``layer``, field 100) and legacy V1 (``layers``,
    field 2) nets."""
    with open(path, "rb") as f:
        net = parse_wire(f.read())
    out: Dict[str, dict] = {}
    for lp in _w_msgs(net, 100):  # V2 LayerParameter
        out[_w_str(lp, 1, "")] = {
            "type": _w_str(lp, 2, ""),
            "blobs": [_blob_to_array(b) for b in _w_msgs(lp, 7)],
        }
    for lp in _w_msgs(net, 2):  # V1LayerParameter
        name = _w_str(lp, 4, "")
        if name in out:
            continue
        out[name] = {
            "type": _V1_TYPES.get(_w_int(lp, 5, 0), str(_w_int(lp, 5, 0))),
            "blobs": [_blob_to_array(b) for b in _w_msgs(lp, 6)],
        }
    return out


# ==========================================================================
# prototxt -> layer descriptions (V1 and V2 text spellings)
# ==========================================================================


def _first(d: dict, key: str, default=None):
    v = d.get(key)
    return v[0] if v else default


def _net_layers(net: dict) -> List[dict]:
    layers = list(net.get("layer", [])) + list(net.get("layers", []))
    # legacy spellings use underscores (INNER_PRODUCT, EUCLIDEAN_LOSS):
    # strip them on both sides of the lookup
    v1 = {v.upper().replace("WITHLOSS", "_LOSS").replace("_", ""): v
          for v in _V1_TYPES.values()}
    out = []
    for lyr in layers:
        t = _first(lyr, "type", "")
        # a V1 enum (CONVOLUTION); V2's "ELU" is upper case too and is
        # kept (the JAX loader reads it as an enum, "Elu", and raises)
        if isinstance(t, str) and t.isupper() and t != "ELU":
            t = v1.get(t.replace("_", ""), t.title())
        out.append({**lyr, "type": [t]})
    return out


def _train_only(lyr: dict) -> bool:
    return any(_first(inc, "phase") in ("TRAIN", 0)
               for inc in lyr.get("include", []))


# ==========================================================================
# shape arithmetic (Caffe's: pooling rounds up, convolution down)
# ==========================================================================


def _conv_out(size, k, pad, stride, dil=1):
    eff = dil * (k - 1) + 1
    return (size + 2 * pad - eff) // stride + 1


def _pool_out(size, k, pad, stride):
    out = -(-(size + 2 * pad - k) // stride) + 1  # ceil
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def _kern2(p: dict, base: str, hk="_h", wk="_w"):
    """kernel/stride/pad: one repeated value or an _h/_w pair."""
    h = _first(p, base + hk)
    w = _first(p, base + wk)
    if h is None or w is None:
        vals = p.get(base + "_size" if base == "kernel" else base, [])
        v = vals[0] if vals else None
        h = h if h is not None else v
        w = w if w is not None else v
    return h, w


_INPUT_TYPES = ("Input", "Data", "DummyData", "MemoryData", "ImageData",
                "HDF5Data")
_SKIPPED_TYPES = ("Accuracy", "Silence", "ArgMax")


# ==========================================================================
# the loader
# ==========================================================================


class CaffeConversionException(Exception):
    pass


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A blob as a new f32 tensor on ``device``."""
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                        device=device)


def _assign(module, name: str, a: np.ndarray) -> None:
    """Copy blob ``a`` (reshaped to the tensor's shape) into the module's
    parameter or buffer ``name``, on its device."""
    cur = getattr(module, name)
    with torch.no_grad():
        cur.copy_(_to_tensor(a, cur.device).reshape(cur.shape))


class CaffeLoader:
    """``load()`` builds a ``Graph`` from the prototxt (the inference
    phase) on ``device`` and copies the caffemodel's blobs into it by
    layer name."""

    def __init__(self, prototxt_path: Optional[str] = None,
                 model_path: Optional[str] = None,
                 prototxt_text: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        if prototxt_text is None:
            with open(prototxt_path) as f:
                prototxt_text = f.read()
        self.net = parse_prototxt(prototxt_text)
        self.model_path = model_path
        self._blobs: Dict[str, dict] = (
            load_caffemodel(model_path) if model_path else {})

    def load(self):
        from bigdl_tpu_torch.nn.graph import Graph, Input

        net = self.net
        blob_node: Dict[str, object] = {}
        blob_shape: Dict[str, tuple] = {}
        input_nodes = []

        # net-level inputs: input + input_dim, or input + input_shape
        dims = net.get("input_dim", [])
        shapes = net.get("input_shape", [])
        for i, nm in enumerate(net.get("input", [])):
            node = Input(nm)
            input_nodes.append(node)
            blob_node[nm] = node
            d = shapes[i].get("dim", []) if shapes else dims[i * 4:i * 4 + 4]
            if len(d) >= 2:
                blob_shape[nm] = tuple(int(x) for x in d[1:])

        layers = [lyr for lyr in _net_layers(net) if not _train_only(lyr)]
        merged_scales = self._find_bn_scale_merges(layers)

        for lyr in layers:
            ltype = _first(lyr, "type", "")
            name = _first(lyr, "name", "")
            bottoms = list(lyr.get("bottom", []))
            tops = list(lyr.get("top", []))
            if ltype in _INPUT_TYPES:
                for t in tops:
                    if t in blob_node:
                        continue
                    node = Input(t)
                    input_nodes.append(node)
                    blob_node[t] = node
                    shp = _first(_first(lyr, "input_param", {}), "shape")
                    dd = shp.get("dim", []) if shp else []
                    if len(dd) >= 2:
                        blob_shape[t] = tuple(int(x) for x in dd[1:])
                continue
            if ltype in _SKIPPED_TYPES:
                continue
            if ltype in ("SoftmaxWithLoss", "EuclideanLoss",
                         "SigmoidCrossEntropyLoss", "HingeLoss"):
                # the inference graph: a loss becomes its activation
                bottoms = bottoms[:1]
                ltype = {"SoftmaxWithLoss": "Softmax"}.get(ltype)
                if ltype is None:
                    continue
            if name in merged_scales or ltype == "Split":
                # a Scale folded into its BatchNorm, or a fan-out copy
                for t in tops:
                    blob_node[t] = blob_node[bottoms[0]]
                    blob_shape[t] = blob_shape.get(bottoms[0])
                continue

            in_shapes = [blob_shape.get(b) for b in bottoms]
            module, out_shape = self._convert_layer(lyr, ltype, name,
                                                    in_shapes, merged_scales)
            try:
                prev = [blob_node[b] for b in bottoms]
            except KeyError as e:
                raise CaffeConversionException(
                    f"layer {name}: unknown bottom blob {e}") from None
            node = module(*prev)
            for t in tops:
                blob_node[t] = node
                blob_shape[t] = out_shape

        # outputs: blobs a converted layer produces and none consumes
        # (skipped layers do not count as consumers, and an in-place
        # layer does not consume its own top)
        produced, consumed = set(), set()
        for lyr in layers:
            if _first(lyr, "type", "") in _SKIPPED_TYPES + _INPUT_TYPES:
                continue
            tops = lyr.get("top", [])
            produced.update(tops)
            consumed.update(b for b in lyr.get("bottom", [])
                            if b not in tops)
        outputs = [blob_node[t] for t in blob_node
                   if t in produced and t not in consumed]
        if not outputs:
            raise CaffeConversionException("no output blobs found")
        graph = Graph(input_nodes, outputs).to(self.device)
        if _first(self.net, "name"):
            graph.set_name(_first(self.net, "name"))
        return graph

    @staticmethod
    def _find_bn_scale_merges(layers) -> Dict[str, str]:
        """{Scale layer: BatchNorm layer} for each Scale that reads a
        BatchNorm's top alone (Caffe's BN + Scale idiom)."""
        bn_tops = {}
        for lyr in layers:
            if _first(lyr, "type") == "BatchNorm":
                for t in lyr.get("top", []):
                    bn_tops[t] = _first(lyr, "name")
        merges = {}
        for lyr in layers:
            if _first(lyr, "type") == "Scale":
                b = lyr.get("bottom", [])
                if len(b) == 1 and b[0] in bn_tops:
                    merges[_first(lyr, "name")] = bn_tops[b[0]]
        return merges

    def _layer_blobs(self, name: str) -> List[np.ndarray]:
        entry = self._blobs.get(name)
        return entry["blobs"] if entry else []

    def _convert_layer(self, lyr, ltype, name, in_shapes, merged_scales):
        """(module on the loader's device holding the layer's blobs,
        output (C, H, W) or None where unknown)."""
        mod, out = self._make_layer(lyr, ltype, name, in_shapes,
                                    merged_scales)
        mod.to(self.device)
        for owner, attr, blob in self._blob_targets(mod, lyr, ltype, name,
                                                    merged_scales):
            _assign(owner, attr, blob)
        return mod, out

    def _blob_targets(self, mod, lyr, ltype, name, merged_scales):
        """(module, attribute, blob) for each blob the layer takes, as
        the JAX loader assigns them."""
        from bigdl_tpu_torch.nn.module import Sequential

        blobs = self._layer_blobs(name)
        if ltype == "BatchNorm":
            out = []
            if blobs:
                sf = float(blobs[2].reshape(-1)[0]) if len(blobs) > 2 else 1.0
                sf = 1.0 / sf if sf != 0 else 0.0
                out += [(mod, "running_mean", blobs[0].reshape(-1) * sf),
                        (mod, "running_var", blobs[1].reshape(-1) * sf)]
            scale = [s for s, bn in merged_scales.items() if bn == name]
            if scale:
                out += [(mod, a, b) for a, b in zip(
                    ("weight", "bias"), self._layer_blobs(scale[-1]))]
            return out
        if not blobs or ltype not in ("Convolution", "Deconvolution",
                                      "InnerProduct", "PReLU", "Scale"):
            return []
        if isinstance(mod, Sequential):  # InnerProduct's Reshape + Linear
            mod = mod.modules[1]
        w = blobs[0]
        if ltype == "Deconvolution":
            # Caffe's deconvolution blob is (in, out/group, kh, kw)
            w = w.reshape(mod.n_input_plane, mod.n_output_plane,
                          mod.kernel_h, mod.kernel_w).transpose(1, 0, 2, 3)
        if ltype == "PReLU":
            return [(mod, "weight", w)] if w.size == mod.weight.numel() \
                else []
        out = [(mod, "weight", w)]
        bias_term = ltype != "Scale" or bool(_first(
            _first(lyr, "scale_param", {}), "bias_term", True))
        if len(blobs) > 1 and mod.bias is not None and bias_term:
            out.append((mod, "bias", blobs[1]))
        return out

    def _make_layer(self, lyr, ltype, name, in_shapes, merged_scales):
        from bigdl_tpu_torch.nn import layers as L
        from bigdl_tpu_torch.nn import table_ops as T
        from bigdl_tpu_torch.nn.module import Sequential

        shape = in_shapes[0] if in_shapes else None
        blobs = self._layer_blobs(name)

        if ltype in ("Convolution", "Deconvolution"):
            p = _first(lyr, "convolution_param", {})
            n_out = _first(p, "num_output")
            kh, kw = _kern2(p, "kernel")
            sh, sw = _kern2(p, "stride")
            sh, sw = sh or 1, sw or 1
            ph, pw = _kern2(p, "pad")
            ph, pw = ph or 0, pw or 0
            group = _first(p, "group", 1)
            dil = _first(p, "dilation", 1)
            bias = bool(_first(p, "bias_term", True))
            if blobs:
                w = blobs[0]
                c_in = w.shape[1] * group if ltype == "Convolution" \
                    else w.shape[0]
            elif shape:
                c_in = shape[0]
            else:
                raise CaffeConversionException(
                    f"{name}: cannot infer input channels (no blobs, no "
                    "shape)")
            if ltype == "Deconvolution":
                mod = L.SpatialFullConvolution(c_in, n_out, kw, kh, sw, sh,
                                               pw, ph)
                out = None if not shape else (
                    n_out, (shape[1] - 1) * sh - 2 * ph + kh,
                    (shape[2] - 1) * sw - 2 * pw + kw)
                return mod, out
            if dil and dil > 1:
                mod = L.SpatialDilatedConvolution(
                    c_in, n_out, kw, kh, sw, sh, pw, ph,
                    dilation_w=dil, dilation_h=dil)
            else:
                mod = L.SpatialConvolution(c_in, n_out, kw, kh, sw, sh, pw,
                                           ph, group, with_bias=bias)
            out = None if not shape else (
                n_out, _conv_out(shape[1], kh, ph, sh, dil or 1),
                _conv_out(shape[2], kw, pw, sw, dil or 1))
            return mod, out

        if ltype == "InnerProduct":
            p = _first(lyr, "inner_product_param", {})
            n_out = _first(p, "num_output")
            bias = bool(_first(p, "bias_term", True))
            if blobs:
                in_features = blobs[0].shape[-1] if blobs[0].ndim > 1 \
                    else blobs[0].size // n_out
            elif shape:
                in_features = int(np.prod(shape))
            else:
                raise CaffeConversionException(
                    f"{name}: cannot size InnerProduct (no blobs, no shape)")
            mod = L.Linear(in_features, n_out, with_bias=bias)
            # Caffe's InnerProduct flattens from axis 1
            if shape and len(shape) > 1:
                mod = Sequential().add(L.Reshape([in_features])).add(mod)
            return mod, (n_out,)

        if ltype == "Pooling":
            p = _first(lyr, "pooling_param", {})
            pool = _first(p, "pool", "MAX")
            kh, kw = _kern2(p, "kernel")
            sh, sw = _kern2(p, "stride")
            sh, sw = sh or 1, sw or 1
            ph, pw = _kern2(p, "pad")
            ph, pw = ph or 0, pw or 0
            glob = bool(_first(p, "global_pooling", False))
            if glob:
                if shape is None:
                    raise CaffeConversionException(
                        "global pooling needs a known input shape")
                kh, kw = shape[1], shape[2]
                sh = sw = 1
                ph = pw = 0
            cls = L.SpatialMaxPooling if pool in ("MAX", 0) \
                else L.SpatialAveragePooling
            mod = cls(kw, kh, sw, sh, pw, ph, ceil_mode=True)
            out = None if not shape else (
                shape[0], 1 if glob else _pool_out(shape[1], kh, ph, sh),
                1 if glob else _pool_out(shape[2], kw, pw, sw))
            return mod, out

        if ltype == "ReLU":
            slope = _first(_first(lyr, "relu_param", {}), "negative_slope",
                           0.0)
            return (L.LeakyReLU(slope) if slope else L.ReLU()), shape
        simple = {"TanH": L.Tanh, "Sigmoid": L.Sigmoid, "AbsVal": L.Abs,
                  "BNLL": L.SoftPlus, "Exp": L.Exp, "Log": L.Log,
                  "Softmax": L.SoftMax}
        if ltype in simple:
            return simple[ltype](), shape
        if ltype == "ELU":
            return L.ELU(_first(_first(lyr, "elu_param", {}), "alpha",
                                1.0)), shape
        if ltype == "PReLU":
            return L.PReLU(n_output_plane=shape[0] if shape else 1), shape
        if ltype == "Power":
            p = _first(lyr, "power_param", {})
            return L.Power(_first(p, "power", 1.0), _first(p, "scale", 1.0),
                           _first(p, "shift", 0.0)), shape
        if ltype == "Dropout":
            p = _first(lyr, "dropout_param", {})
            return L.Dropout(_first(p, "dropout_ratio", 0.5)), shape
        if ltype == "LRN":
            p = _first(lyr, "lrn_param", {})
            return L.SpatialCrossMapLRN(
                _first(p, "local_size", 5), _first(p, "alpha", 1.0),
                _first(p, "beta", 0.75), _first(p, "k", 1.0)), shape
        if ltype == "Flatten":
            if shape:
                n = int(np.prod(shape))
                return L.Reshape([n]), (n,)
            return L.Reshape([-1]), None
        if ltype == "Reshape":
            sh = _first(_first(lyr, "reshape_param", {}), "shape", {})
            # a leading 0 keeps the batch dim: Reshape detects it
            body = [int(d) for d in sh.get("dim", []) if int(d) != 0]
            out = tuple(body) if body and -1 not in body else None
            return L.Reshape(body or [-1]), out
        if ltype == "Concat":
            p = _first(lyr, "concat_param", {})
            axis = int(_first(p, "axis", _first(p, "concat_dim", 1)))
            # Caffe's axis counts the batch dim (axis 1: channels);
            # JoinTable's dimension is 1-based over the whole tensor
            mod = T.JoinTable(dimension=axis + 1, n_input_dims=-1)
            out = None
            if in_shapes and all(s is not None for s in in_shapes):
                dims = list(in_shapes[0])
                dims[axis - 1] = sum(s[axis - 1] for s in in_shapes)
                out = tuple(dims)
            return mod, out
        if ltype == "Eltwise":
            op = _first(_first(lyr, "eltwise_param", {}), "operation", "SUM")
            if op in ("SUM", 1):
                return T.CAddTable(), shape
            if op in ("PROD", 0):
                return T.CMulTable(), shape
            if op in ("MAX", 2):
                return T.CMaxTable(), shape
            raise CaffeConversionException(f"Eltwise op {op} unsupported")
        if ltype == "BatchNorm":
            eps = _first(_first(lyr, "batch_norm_param", {}), "eps", 1e-5)
            c = shape[0] if shape else (blobs[0].size if blobs else None)
            if c is None:
                raise CaffeConversionException(
                    f"{name}: BatchNorm needs shape")
            affine = name in merged_scales.values()
            mod = L.SpatialBatchNormalization(int(c), eps=eps, affine=affine)
            # a loaded Caffe BN runs on its global statistics
            mod.evaluate()
            return mod, shape
        if ltype == "Scale":
            c = shape[0] if shape else (blobs[0].size if blobs else 1)
            size = (int(c),) + (1,) * (len(shape) - 1 if shape else 2)
            return L.Scale(size), shape
        if ltype == "Slice":
            raise CaffeConversionException(
                "Slice layers are not supported (multi-output modules)")
        raise CaffeConversionException(f"unsupported caffe layer type {ltype}")


# ==========================================================================
# the persister
# ==========================================================================


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class CaffePersister:
    """Writes a prototxt and a caffemodel for a net of convertible
    layers."""

    @staticmethod
    def save(graph, prototxt_path: str, model_path: str,
             input_shape: Optional[tuple] = None):
        net_txt, net_bin = _export(graph, input_shape)
        with open(prototxt_path, "w") as f:
            f.write(net_txt)
        with open(model_path, "wb") as f:
            f.write(net_bin)


def _layer_entry(m, lname, bottoms, top):
    """(prototxt entry, blobs) of one module; raises for a module Caffe
    has no layer for."""
    from bigdl_tpu_torch.nn import layers as L
    from bigdl_tpu_torch.nn import table_ops as T

    entry = {"name": [lname], "bottom": bottoms, "top": [top]}
    blobs: List[np.ndarray] = []
    if isinstance(m, L.SpatialConvolution):
        entry["type"] = ["Convolution"]
        cp = {"num_output": [m.n_output_plane],
              "kernel_h": [m.kernel_h], "kernel_w": [m.kernel_w],
              "stride_h": [m.stride_h], "stride_w": [m.stride_w],
              "pad_h": [m.pad_h], "pad_w": [m.pad_w],
              "group": [m.n_group], "bias_term": [m.bias is not None]}
        if isinstance(m, L.SpatialDilatedConvolution):
            if m.dilation_h != m.dilation_w:
                raise CaffeConversionException(
                    "caffe dilation is isotropic; dilation_h != dilation_w")
            cp["dilation"] = [m.dilation_h]
        entry["convolution_param"] = [cp]
        blobs += [_host(m.weight)] + (
            [_host(m.bias)] if m.bias is not None else [])
    elif isinstance(m, L.Linear):
        entry["type"] = ["InnerProduct"]
        entry["inner_product_param"] = [{"num_output": [m.output_size],
                                         "bias_term": [m.bias is not None]}]
        blobs += [_host(m.weight)] + (
            [_host(m.bias)] if m.bias is not None else [])
    elif isinstance(m, (L.SpatialMaxPooling, L.SpatialAveragePooling)):
        entry["type"] = ["Pooling"]
        entry["pooling_param"] = [{
            "pool": ["MAX" if isinstance(m, L.SpatialMaxPooling)
                     else "AVE"],
            "kernel_h": [m.kh], "kernel_w": [m.kw],
            "stride_h": [m.dh], "stride_w": [m.dw],
            "pad_h": [m.pad_h], "pad_w": [m.pad_w]}]
    elif isinstance(m, L.ReLU):
        entry["type"] = ["ReLU"]
    elif isinstance(m, L.LeakyReLU):
        entry["type"] = ["ReLU"]
        entry["relu_param"] = [{"negative_slope": [m.negval]}]
    elif isinstance(m, L.Tanh):
        entry["type"] = ["TanH"]
    elif isinstance(m, L.Sigmoid):
        entry["type"] = ["Sigmoid"]
    elif isinstance(m, (L.SoftMax, L.LogSoftMax)):
        entry["type"] = ["Softmax"]
    elif isinstance(m, L.Dropout):
        entry["type"] = ["Dropout"]
        entry["dropout_param"] = [{"dropout_ratio": [m.p]}]
    elif isinstance(m, L.SpatialCrossMapLRN):
        entry["type"] = ["LRN"]
        entry["lrn_param"] = [{"local_size": [m.size], "alpha": [m.alpha],
                               "beta": [m.beta], "k": [m.k]}]
    elif isinstance(m, L.SpatialBatchNormalization):
        # the affine part is written as a Scale layer after this one
        entry["type"] = ["BatchNorm"]
        entry["batch_norm_param"] = [{"eps": [m.eps]}]
        blobs += [_host(m.running_mean), _host(m.running_var),
                  np.asarray([1.0], dtype=np.float32)]
    elif isinstance(m, L.Reshape):
        entry["type"] = ["Flatten"] if len(m.size) == 1 else ["Reshape"]
        if entry["type"] == ["Reshape"]:
            entry["reshape_param"] = [
                {"shape": [{"dim": [0] + [int(d) for d in m.size]}]}]
    elif isinstance(m, T.JoinTable):
        entry["type"] = ["Concat"]
        entry["concat_param"] = [{"axis": [m.dimension - 1]}]
    elif isinstance(m, (T.CAddTable, T.CMulTable, T.CMaxTable)):
        entry["type"] = ["Eltwise"]
        op = {T.CAddTable: "SUM", T.CMulTable: "PROD",
              T.CMaxTable: "MAX"}[type(m)]
        entry["eltwise_param"] = [{"operation": [op]}]
    else:
        raise CaffeConversionException(
            f"CaffePersister: unsupported layer {type(m).__name__}")
    return entry, blobs


def _layer_message(lname, ltype, bottoms, top, blobs) -> _WireWriter:
    lp = _WireWriter()
    lp.string(1, lname)
    lp.string(2, ltype)
    for b in bottoms:
        lp.string(3, b)
    lp.string(4, top)
    for arr in blobs:
        lp.message(7, _array_to_blob(arr))
    return lp


def _export(graph, input_shape) -> Tuple[str, bytes]:
    from bigdl_tpu_torch.nn import layers as L
    from bigdl_tpu_torch.nn.graph import Graph, _InputModule

    if not isinstance(graph, Graph):
        if not hasattr(graph, "to_graph"):
            raise CaffeConversionException("CaffePersister needs a Graph")
        graph = graph.to_graph()

    name = graph._name or "bigdl_tpu_net"
    txt: dict = {"name": [name]}
    txt_layers = []
    net = _WireWriter()
    net.string(1, name)

    def blob_of(node):
        return f"blob{node.id}"

    # input_shape: one (C, H, W) for every input, or a list of them
    shapes = None
    if input_shape is not None:
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape] * len(graph.input_nodes)
    for i, node in enumerate(graph.input_nodes):
        txt.setdefault("input", []).append(blob_of(node))
        if shapes is not None:
            txt.setdefault("input_shape", []).append(
                {"dim": [1] + list(shapes[i])})

    counter = 0
    for node in graph.topo_order():
        m = node.module
        if node in graph.input_nodes or isinstance(m, _InputModule):
            continue
        counter += 1
        lname = m._name or f"layer{counter}"
        bottoms = [blob_of(p) for p in node.prev_nodes]
        top = blob_of(node)
        entry, blobs = _layer_entry(m, lname, bottoms, top)
        txt_layers.append(entry)
        net.message(100, _layer_message(lname, entry["type"][0], bottoms,
                                        top, blobs))
        # BN's affine part as a separate Scale layer (Caffe's idiom)
        if isinstance(m, L.SpatialBatchNormalization) and \
                m.weight is not None:
            counter += 1
            sname = lname + "_scale"
            txt_layers.append({
                "name": [sname], "type": ["Scale"], "bottom": [top],
                "top": [top],
                "scale_param": [{"bias_term": [m.bias is not None]}]})
            sblobs = [_host(m.weight)] + (
                [_host(m.bias)] if m.bias is not None else [])
            net.message(100, _layer_message(sname, "Scale", [top], top,
                                            sblobs))

    txt["layer"] = txt_layers
    return format_prototxt(txt), net.tobytes()


# --------------------------------------------------------------------------
# module-level conveniences (the reference's Module.loadCaffeModel and
# Module.loadCaffe)
# --------------------------------------------------------------------------


def load_caffe_model(prototxt_path: str, model_path: str, device="cuda"):
    """A ``Graph`` from a prototxt and its caffemodel, on ``device``."""
    return CaffeLoader(prototxt_path, model_path, device=device).load()


def load_caffe_weights(model, model_path: str, match_all: bool = True):
    """Copy a caffemodel's weights into an existing model by layer name
    (first blob into ``weight``, second into ``bias``), on the model's
    device."""
    blobs = load_caffemodel(model_path)
    matched = 0
    for m in _iter_modules(model):
        arrs = blobs.get(m._name, {}).get("blobs") if m._name else None
        if not arrs:
            continue
        for attr, arr in zip(("weight", "bias"), arrs):
            if getattr(m, attr, None) is not None:
                _assign(m, attr, arr)
        matched += 1
    if match_all and not matched:
        raise CaffeConversionException("no layers matched by name")
    return model


def _iter_modules(m):
    yield m
    for child in getattr(m, "_modules", {}).values():
        yield from _iter_modules(child)


__all__ = ["parse_prototxt", "format_prototxt", "parse_wire",
           "load_caffemodel", "CaffeConversionException", "CaffeLoader",
           "CaffePersister", "load_caffe_model", "load_caffe_weights"]
