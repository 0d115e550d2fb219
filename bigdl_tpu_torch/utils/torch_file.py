"""Torch7 ``.t7`` serialization: load and save tensors, tables and
``nn`` modules.

Counterpart of ``bigdl_tpu/utils/torch_file.py`` (:67-391), the
reference's ``TorchFile.scala``.  The binary format (little-endian),
as Torch7's default serializer writes it: every value is an ``int32``
type tag and its payload --

  NIL=0; NUMBER=1 (f64); STRING=2 (i32 len + bytes); TABLE=3
  (i32 ref-index, i32 count, count x (key, value)); TORCH=4
  (i32 ref-index, version string "V <n>", class-name string, payload);
  BOOLEAN=5 (i32).

A tensor's payload is i32 ndim, i64 x ndim size, i64 x ndim stride,
the i64 storage offset (1-based) and its Storage object (i64 count and
the raw elements).  An object seen before is written as its index
alone.  Loaded tensors are numpy arrays and class instances
``TorchObject``s; the writer writes the JAX package's bytes for the
same values (a torch tensor is written as its numpy array).
``load_torch_module(obj, device=)`` maps the common ``nn.*`` classes
onto the port's layers on ``device`` (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import resolve_device

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_TENSOR_DTYPES = {
    "torch.FloatTensor": np.float32,
    "torch.DoubleTensor": np.float64,
    "torch.IntTensor": np.int32,
    "torch.LongTensor": np.int64,
    "torch.ByteTensor": np.uint8,
    "torch.CharTensor": np.int8,
    "torch.ShortTensor": np.int16,
}
_STORAGE_DTYPES = {
    "torch.FloatStorage": np.float32,
    "torch.DoubleStorage": np.float64,
    "torch.IntStorage": np.int32,
    "torch.LongStorage": np.int64,
    "torch.ByteStorage": np.uint8,
    "torch.CharStorage": np.int8,
    "torch.ShortStorage": np.int16,
}
_NP_TENSOR = {np.dtype(np.float32): "torch.FloatTensor",
              np.dtype(np.float64): "torch.DoubleTensor",
              np.dtype(np.int32): "torch.IntTensor",
              np.dtype(np.int64): "torch.LongTensor",
              np.dtype(np.uint8): "torch.ByteTensor"}
_NP_STORAGE = {np.dtype(np.float32): "torch.FloatStorage",
               np.dtype(np.float64): "torch.DoubleStorage",
               np.dtype(np.int32): "torch.IntStorage",
               np.dtype(np.int64): "torch.LongStorage",
               np.dtype(np.uint8): "torch.ByteStorage"}


class TorchObject(dict):
    """A deserialized torch class instance: its table payload plus
    ``torch_type`` (e.g. ``"nn.Linear"``)."""

    def __init__(self, torch_type: str, payload: Optional[dict] = None):
        super().__init__(payload or {})
        self.torch_type = torch_type

    def __repr__(self):
        return f"TorchObject({self.torch_type}, {dict.__repr__(self)})"


# ==========================================================================
# reader
# ==========================================================================


class _Reader:
    def __init__(self, f):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def i32(self) -> int:
        return struct.unpack("<i", self.f.read(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.f.read(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.f.read(8))[0]

    def string(self) -> str:
        n = self.i32()
        return self.f.read(n).decode("utf-8", "replace")

    # ------------------------------------------------------------------
    def value(self):
        t = self.i32()
        if t == TYPE_NIL:
            return None
        if t == TYPE_NUMBER:
            v = self.f64()
            return int(v) if v == int(v) and abs(v) < 2**53 else v
        if t == TYPE_STRING:
            return self.string()
        if t == TYPE_BOOLEAN:
            return bool(self.i32())
        if t == TYPE_TABLE:
            idx = self.i32()
            if idx in self.memo:
                return self.memo[idx]
            out: dict = {}
            self.memo[idx] = out
            n = self.i32()
            for _ in range(n):
                k = self.value()
                v = self.value()
                out[k] = v
            # 1..n integer keys -> list
            if out and all(isinstance(k, int) for k in out) and \
                    sorted(out) == list(range(1, len(out) + 1)):
                lst = [out[i] for i in range(1, len(out) + 1)]
                self.memo[idx] = lst
                return lst
            return out
        if t == TYPE_TORCH:
            idx = self.i32()
            if idx in self.memo:
                return self.memo[idx]
            version = self.string()
            if version.startswith("V "):
                cls = self.string()
            else:
                cls = version  # legacy: no version header
            obj = self._torch_payload(cls, idx)
            return obj
        raise ValueError(f"bad .t7 type tag {t}")

    def _torch_payload(self, cls: str, idx: int):
        if cls in _TENSOR_DTYPES:
            ndim = self.i32()
            size = [self.i64() for _ in range(ndim)]
            stride = [self.i64() for _ in range(ndim)]
            offset = self.i64() - 1
            storage = self.value()  # Storage -> np array (flat)
            if storage is None or ndim == 0:
                arr = np.zeros(size, _TENSOR_DTYPES[cls])
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=size,
                    strides=[s * storage.itemsize for s in stride],
                ).copy()
            self.memo[idx] = arr
            return arr
        if cls in _STORAGE_DTYPES:
            n = self.i64()
            dt = np.dtype(_STORAGE_DTYPES[cls])
            arr = np.frombuffer(self.f.read(n * dt.itemsize), dtype=dt).copy()
            self.memo[idx] = arr
            return arr
        # generic class: payload is a table
        obj = TorchObject(cls)
        self.memo[idx] = obj
        payload = self.value()
        if isinstance(payload, dict):
            obj.update(payload)
        return obj


def load_t7(path: str):
    """Reference: ``File.loadTorch`` — read one value from a .t7 file."""
    with open(path, "rb") as f:
        return _Reader(f).value()


# ==========================================================================
# writer
# ==========================================================================


class _Writer:
    def __init__(self, f):
        self.f = f
        self.next_idx = 1
        self.memo: Dict[int, int] = {}  # id(obj) -> index
        # the arrays made here for tensors: kept alive, so that no later
        # object reuses the id the memo holds
        self.made: list = []

    def i32(self, v: int):
        self.f.write(struct.pack("<i", v))

    def i64(self, v: int):
        self.f.write(struct.pack("<q", v))

    def f64(self, v: float):
        self.f.write(struct.pack("<d", v))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.i32(len(b))
        self.f.write(b)

    def value(self, v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
            self.made.append(v)
        if isinstance(v, np.generic):
            # numpy scalars serialize as Lua numbers/booleans, not tensors
            v = v.item()
        if v is None:
            self.i32(TYPE_NIL)
        elif isinstance(v, bool):
            self.i32(TYPE_BOOLEAN)
            self.i32(1 if v else 0)
        elif isinstance(v, (int, float)):
            self.i32(TYPE_NUMBER)
            self.f64(float(v))
        elif isinstance(v, str):
            self.i32(TYPE_STRING)
            self.string(v)
        elif isinstance(v, np.ndarray):
            self._tensor(v)
        elif isinstance(v, TorchObject):
            self.i32(TYPE_TORCH)
            idx = self._ref(v)
            if idx is None:
                return
            self.string("V 1")
            self.string(v.torch_type)
            self.value(dict(v))
        elif isinstance(v, (list, tuple)):
            self.value({i + 1: x for i, x in enumerate(v)})
        elif isinstance(v, dict):
            self.i32(TYPE_TABLE)
            idx = self._ref(v)
            if idx is None:
                return
            self.i32(len(v))
            for k, val in v.items():
                self.value(k)
                self.value(val)
        else:
            try:
                self.value(np.asarray(v))
            except Exception:
                raise TypeError(f"cannot serialize {type(v).__name__} to .t7")

    def _ref(self, obj) -> Optional[int]:
        """Write the ref index; returns None if already written."""
        key = id(obj)
        if key in self.memo:
            self.i32(self.memo[key])
            return None
        idx = self.next_idx
        self.next_idx += 1
        self.memo[key] = idx
        self.i32(idx)
        return idx

    def _tensor(self, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        tt = _NP_TENSOR.get(arr.dtype)
        if tt is None:
            arr = arr.astype(np.float32)
            tt = "torch.FloatTensor"
        self.i32(TYPE_TORCH)
        idx = self._ref(arr)
        if idx is None:
            return
        self.string("V 1")
        self.string(tt)
        self.i32(arr.ndim)
        for s in arr.shape:
            self.i64(s)
        stride = [st // arr.itemsize for st in arr.strides]
        for s in stride:
            self.i64(s)
        self.i64(1)  # storage offset (1-based)
        # storage
        self.i32(TYPE_TORCH)
        self.i32(self.next_idx)
        self.next_idx += 1
        self.string("V 1")
        self.string(_NP_STORAGE[arr.dtype])
        self.i64(arr.size)
        self.f.write(arr.tobytes())


def save_t7(path: str, obj):
    """Reference: ``File.saveTorch`` — write one value as .t7."""
    with open(path, "wb") as f:
        _Writer(f).value(obj)


# ==========================================================================
# nn.* module mapping
# ==========================================================================


def _set_weights(mod, obj, device):
    """``obj``'s weight and bias (reshaped to the layer's) copied into
    ``mod`` on ``device``."""
    from bigdl_tpu_torch.utils.caffe import _assign

    mod.to(device)
    for name in ("weight", "bias"):
        if obj.get(name) is not None and getattr(mod, name, None) is not None:
            _assign(mod, name, obj[name])
    return mod


def load_torch_module(obj_or_path, device="cuda"):
    """Map a deserialized ``nn.*`` object tree (or a ``.t7`` path) onto
    the port's layers, built on ``device`` (reference: TorchFile
    loading Torch models)."""
    dev = resolve_device(device)
    return _module_of(obj_or_path, dev).to(dev)


def _module_of(obj, dev):
    from bigdl_tpu_torch.nn import layers as L
    from bigdl_tpu_torch.nn.module import Identity, Sequential
    from bigdl_tpu_torch.utils.caffe import _assign

    if isinstance(obj, str):
        obj = load_t7(obj)
    t = getattr(obj, "torch_type", None)    # a TorchObject of either package
    if t is None:
        raise TypeError("not a torch nn module")

    if t in ("nn.Sequential",):
        seq = Sequential()
        for child in obj.get("modules", []):
            seq.add(_module_of(child, dev))
        return seq
    if t == "nn.Linear":
        w = np.asarray(obj["weight"])
        mod = L.Linear(w.shape[1], w.shape[0],
                       with_bias=obj.get("bias") is not None)
        return _set_weights(mod, obj, dev)
    if t in ("nn.SpatialConvolution", "nn.SpatialConvolutionMM"):
        mod = L.SpatialConvolution(
            int(obj["nInputPlane"]), int(obj["nOutputPlane"]),
            int(obj["kW"]), int(obj["kH"]),
            int(obj.get("dW", 1)), int(obj.get("dH", 1)),
            int(obj.get("padW", 0)), int(obj.get("padH", 0)),
        )
        return _set_weights(mod, obj, dev)
    if t == "nn.SpatialMaxPooling":
        mod = L.SpatialMaxPooling(
            int(obj["kW"]), int(obj["kH"]),
            int(obj.get("dW", 1)), int(obj.get("dH", 1)),
            int(obj.get("padW", 0)), int(obj.get("padH", 0)),
        )
        if obj.get("ceil_mode"):
            mod.ceil_mode = True
        return mod
    if t == "nn.SpatialAveragePooling":
        return L.SpatialAveragePooling(
            int(obj["kW"]), int(obj["kH"]),
            int(obj.get("dW", 1)), int(obj.get("dH", 1)),
            int(obj.get("padW", 0)), int(obj.get("padH", 0)),
        )
    if t == "nn.SpatialBatchNormalization" or t == "nn.BatchNormalization":
        n = int(np.asarray(obj["running_mean"]).size)
        cls = (L.SpatialBatchNormalization
               if t == "nn.SpatialBatchNormalization" else L.BatchNormalization)
        mod = cls(n, eps=float(obj.get("eps", 1e-5)),
                  affine=obj.get("weight") is not None)
        _set_weights(mod, obj, dev)
        for name in ("running_mean", "running_var"):
            _assign(mod, name, obj[name])
        return mod
    if t == "nn.View":
        return L.View(*[int(s) for s in np.atleast_1d(obj.get("size"))])
    if t == "nn.Reshape":
        return L.Reshape([int(s) for s in np.atleast_1d(obj.get("size"))])
    if t == "nn.Dropout":
        return L.Dropout(float(obj.get("p", 0.5)))
    simple = {
        "nn.ReLU": L.ReLU, "nn.Tanh": L.Tanh, "nn.Sigmoid": L.Sigmoid,
        "nn.SoftMax": L.SoftMax, "nn.LogSoftMax": L.LogSoftMax,
        "nn.SoftPlus": L.SoftPlus, "nn.Abs": L.Abs, "nn.ELU": L.ELU,
        "nn.LeakyReLU": L.LeakyReLU, "nn.Identity": Identity,
    }
    if t in simple:
        return simple[t]()
    raise ValueError(f"unsupported torch module class {t}")
