"""TFRecord files and the ``tf.train.Example`` codec, on the host.

Counterpart of ``bigdl_tpu/utils/tf_records.py`` (:46-308):
``TFRecordWriter`` frames records as ``uint64 len | uint32
masked_crc(len) | data | uint32 masked_crc(data)``, ``tfrecord_iterator``
reads them back and checks both CRCs, ``encode_example``/
``decode_example``/``parse_example`` carry ``tf.train.Example`` protos,
``FixedLenFeature`` is the dense half of TF's ``ParseExample``, and
``TFRecordExampleDataset`` is the reader -> queue -> ``ParseExample``
chain of a TF1 input pipeline as the iterator it always was.

No TF and no protobuf runtime: the CRC is the event files' masked
crc32c (``visualization/summary.py``) and the protos go through the
port's wire reader and writer (``utils/caffe.py``).  For the same
features the writer's bytes are the JAX package's, so each package
reads the other's files.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.utils.caffe import (_WireWriter, _read_varint, _varint,
                                         _w_msgs, parse_wire)
from bigdl_tpu_torch.visualization.summary import _masked_crc

__all__ = [
    "TFRecordWriter",
    "tfrecord_iterator",
    "FixedLenFeature",
    "encode_example",
    "parse_example",
    "TFRecordExampleDataset",
]


# ------------------------------------------------------------------ framing


class TFRecordWriter:
    """Write TFRecord-framed records:
    ``uint64 len | uint32 masked_crc(len) | data | uint32 masked_crc(data)``.
    """

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def tfrecord_iterator(path: str, verify_crc: bool = True):
    """Yield the raw record payloads of one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            crc_len = f.read(4)
            if len(crc_len) < 4:
                raise ValueError(f"{path}: truncated record")
            (n,) = struct.unpack("<Q", header)
            if verify_crc and struct.unpack("<I", crc_len)[0] != _masked_crc(
                header
            ):
                raise ValueError(f"{path}: corrupt length crc")
            data = f.read(n)
            if len(data) < n:
                raise ValueError(f"{path}: truncated record")
            crc_data = f.read(4)
            if len(crc_data) < 4:
                raise ValueError(f"{path}: truncated record")
            if verify_crc and struct.unpack("<I", crc_data)[0] != _masked_crc(
                data
            ):
                raise ValueError(f"{path}: corrupt data crc")
            yield data


# ----------------------------------------------------------------- Example
#
# tf.train.Example wire schema:
#   Example        { Features features = 1; }
#   Features       { map<string, Feature> feature = 1; }
#   map entry      { string key = 1; Feature value = 2; }
#   Feature        { oneof: BytesList bytes_list = 1;
#                            FloatList float_list = 2;
#                            Int64List int64_list = 3; }
#   BytesList      { repeated bytes value = 1; }
#   FloatList      { repeated float value = 1 [packed]; }
#   Int64List      { repeated int64 value = 1 [packed]; }


def encode_example(features: Dict[str, object]) -> bytes:
    """Encode a dict into a serialized ``tf.train.Example``.

    Value types: ``bytes``/``str`` or lists of them -> bytes_list;
    float arrays/lists -> float_list; int arrays/lists -> int64_list.
    """
    feats = _WireWriter()
    for key, val in features.items():
        feature = _WireWriter()
        if isinstance(val, (bytes, str)):
            val = [val]
        if isinstance(val, np.ndarray) and val.dtype.kind in "SUO":
            # string/bytes ndarray (the shape _decode_tensor produces
            # for string consts) -> bytes_list, not int64
            val = [s for s in val.reshape(-1)]
        arr = None
        if isinstance(val, np.ndarray):
            arr = val.reshape(-1)
        elif isinstance(val, (list, tuple)) and val and isinstance(
            val[0], (bytes, str)
        ):
            blist = _WireWriter()
            for b in val:
                blist.bytes_(1, b.encode() if isinstance(b, str) else b)
            feature.message(1, blist)
        else:
            arr = np.asarray(val).reshape(-1)
        if arr is not None:
            if np.issubdtype(arr.dtype, np.floating):
                flist = _WireWriter()
                flist.bytes_(1, arr.astype("<f4").tobytes())  # packed
                feature.message(2, flist)
            else:
                ilist = _WireWriter()
                packed = b"".join(
                    _varint(int(v)) for v in arr
                )
                ilist.bytes_(1, packed)
                feature.message(3, ilist)
        entry = _WireWriter()
        entry.bytes_(1, key.encode())
        entry.message(2, feature)
        feats.message(1, entry)
    ex = _WireWriter()
    ex.message(1, feats)
    return ex.tobytes()


def _read_varints(buf: bytes) -> List[int]:
    out, pos, n = [], 0, len(buf)
    mv = memoryview(buf)
    while pos < n:
        x, pos = _read_varint(mv, pos)
        if x & (1 << 63):  # two's-complement int64
            x -= 1 << 64
        out.append(x)
    return out


def _decode_feature(fields: Dict[int, list]):
    """Decoded Feature -> (kind, values) where kind in {bytes,float,int}."""
    for fno, kind in ((1, "bytes"), (2, "float"), (3, "int")):
        msgs = _w_msgs(fields, fno)
        if not msgs:
            continue
        vals: List = []
        for wt, v in msgs[0].get(1, []):
            if kind == "bytes":
                vals.append(bytes(v))
            elif kind == "float":
                if wt == 2:  # packed
                    vals.extend(np.frombuffer(v, "<f4").tolist())
                else:
                    vals.append(struct.unpack("<f", v)[0])
            else:
                if wt == 0:
                    x = int(v)
                    if x & (1 << 63):
                        x -= 1 << 64
                    vals.append(x)
                else:  # packed varints
                    vals.extend(_read_varints(bytes(v)))
        return kind, vals
    return None, []


def decode_example(data: bytes) -> Dict[str, tuple]:
    """Serialized Example -> {key: (kind, values)}."""
    ex = parse_wire(data)
    feats_msgs = _w_msgs(ex, 1)
    out: Dict[str, tuple] = {}
    if not feats_msgs:
        return out
    for entry in _w_msgs(feats_msgs[0], 1):
        key_field = entry.get(1)
        if not key_field:
            continue
        key = bytes(key_field[-1][1]).decode()
        vmsgs = _w_msgs(entry, 2)
        if vmsgs:
            out[key] = _decode_feature(vmsgs[0])
    return out


class FixedLenFeature:
    """Dense-feature spec (the reference ParseExample's dense half).

    ``dtype`` may be any numpy dtype, or ``bytes``/``"string"`` for raw
    byte features (to be post-processed by a DecodeRaw transform).
    """

    def __init__(self, shape: Sequence[int] = (), dtype="float32",
                 default_value=None):
        self.shape = tuple(int(s) for s in shape)
        self.is_bytes = dtype in (bytes, "string", "bytes")
        self.dtype = None if self.is_bytes else np.dtype(dtype)
        self.default_value = default_value


def parse_example(data: bytes, spec: Dict[str, FixedLenFeature]):
    """One serialized Example -> {key: np.ndarray | bytes} per spec."""
    decoded = decode_example(data)
    out: Dict[str, object] = {}
    for key, feat in spec.items():
        if key not in decoded:
            if feat.default_value is None:
                raise KeyError(f"Example missing dense key {key!r}")
            if feat.is_bytes:
                out[key] = feat.default_value
            else:
                out[key] = np.full(
                    feat.shape, feat.default_value, dtype=feat.dtype
                )
            continue
        kind, vals = decoded[key]
        if feat.is_bytes:
            out[key] = vals[0] if len(vals) == 1 else vals
        else:
            arr = np.asarray(vals, dtype=feat.dtype)
            out[key] = arr.reshape(feat.shape) if feat.shape else arr
    return out


class TFRecordExampleDataset:
    """Host-side input pipeline over TFRecord files of Examples.

    The reference's filename-queue -> TFRecordReader -> example-queue ->
    QueueDequeueMany -> ParseExample chain, collapsed into the iterator
    it always was.  Optional per-key ``transforms`` (e.g. a DecodeRaw +
    reshape lifted out of the graph) run on each parsed feature.
    """

    def __init__(self, filenames: Sequence[str],
                 spec: Dict[str, FixedLenFeature],
                 batch_size: int = 32,
                 transforms: Optional[Dict[str, object]] = None):
        self.filenames = [os.fspath(f) for f in filenames]
        self.spec = dict(spec)
        self.batch_size = int(batch_size)
        self.transforms = dict(transforms or {})

    def records(self) -> Iterable[Dict[str, object]]:
        for path in self.filenames:
            for raw in tfrecord_iterator(path):
                ex = parse_example(raw, self.spec)
                for key, fn in self.transforms.items():
                    if key in ex:
                        ex[key] = fn(ex[key])
                yield ex

    def batches(self, drop_remainder: bool = False):
        """Yield {key: stacked array} batches — the dequeue-many seam."""
        buf: List[Dict[str, object]] = []
        for ex in self.records():
            buf.append(ex)
            if len(buf) == self.batch_size:
                yield self._stack(buf)
                buf = []
        if buf and not drop_remainder:
            yield self._stack(buf)

    @staticmethod
    def _stack(rows: List[Dict[str, object]]):
        return {
            k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]
        }

    def materialize(self):
        """All records stacked into one {key: array} table (the form
        Local/DistriOptimizer datasets take)."""
        rows = list(self.records())
        if not rows:
            raise ValueError("empty TFRecord dataset")
        return self._stack(rows)
