"""TensorBoard event files: ``FileWriter``, ``TrainSummary`` and
``ValidationSummary``, and their readers.

Counterpart of ``bigdl_tpu/visualization/summary.py`` (the whole
module; the reference's FileWriter.scala, TrainSummary.scala and
ValidationSummary.scala).  Each record is the TFRecord framing
TensorBoard reads,

    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)

with ``data`` an Event protobuf, encoded by hand (scalars and
histograms are all a summary writes):

    Event:   1: double wall_time   2: int64 step   5: Summary summary
    Summary: 1: repeated Value value
    Value:   1: string tag         2: float simple_value  5: HistogramProto histo
    HistogramProto: 1: double min  2: double max  3: double num
                    4: double sum  5: double sum_squares
                    6: repeated double bucket_limit  7: repeated double bucket

Numpy and the standard library only, so either package reads the
other's files.
"""

from __future__ import annotations

import itertools
import os
import struct
import time
from typing import Optional

import numpy as np

# ------------------------------------------------------------------ crc32c
_CRC_TABLE = []


def _build_crc_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _pb_bytes(field, payload)


def _encode_scalar_event(tag: str, value: float, step: int,
                         wall_time: Optional[float] = None) -> bytes:
    value_msg = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    summary = _pb_bytes(1, value_msg)
    event = (
        _pb_double(1, wall_time if wall_time is not None else time.time())
        + _pb_int64(2, int(step))
        + _pb_bytes(5, summary)
    )
    return event


def _encode_histogram_event(tag: str, values: np.ndarray, step: int,
                            wall_time: Optional[float] = None) -> bytes:
    v = np.asarray(values, np.float64).reshape(-1)
    counts, edges = np.histogram(v, bins=30)
    histo = (
        _pb_double(1, float(v.min()) if v.size else 0.0)
        + _pb_double(2, float(v.max()) if v.size else 0.0)
        + _pb_double(3, float(v.size))
        + _pb_double(4, float(v.sum()))
        + _pb_double(5, float((v * v).sum()))
        + _pb_packed_doubles(6, edges[1:])
        + _pb_packed_doubles(7, counts)
    )
    value_msg = _pb_bytes(1, tag.encode()) + _pb_bytes(5, histo)
    summary = _pb_bytes(1, value_msg)
    return (
        _pb_double(1, wall_time if wall_time is not None else time.time())
        + _pb_int64(2, int(step))
        + _pb_bytes(5, summary)
    )


class FileWriter:
    """Appends framed events to an ``events.out.tfevents.*`` file.

    The file name carries the pid and a process-wide counter after the
    timestamp: two writers made in the same second in one directory get
    distinct files, never one stream appended to twice."""

    _SEQ = itertools.count()

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}"
                 f".{os.getpid()}.{next(FileWriter._SEQ)}.bigdl_tpu_torch")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        # file-version header event
        version = _pb_double(1, time.time()) + _pb_bytes(3, b"brain.Event:2")
        self._write_record(version)

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_encode_scalar_event(tag, value, step))
        return self

    def add_histogram(self, tag: str, values, step: int):
        self._write_record(_encode_histogram_event(tag, values, step))
        return self

    def close(self):
        """Idempotent: a double close (user + context manager, or an
        exception path re-running cleanup) is a no-op."""
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _Summary:
    def __init__(self, log_dir: str, app_name: str, kind: str):
        self.log_dir = os.path.join(log_dir, app_name, kind)
        self.writer = FileWriter(self.log_dir)
        self._triggers = {}

    def add_scalar(self, tag: str, value: float, step: int):
        self.writer.add_scalar(tag, value, step)
        return self

    def add_histogram(self, tag: str, values, step: int):
        self.writer.add_histogram(tag, values, step)
        return self

    def read_scalar(self, tag: str):
        """The (step, value) pairs of a tag, read back from the event
        files (the reference's ``readScalar``)."""
        return _read_dir(self.log_dir, tag, _read_scalars)

    def read_histogram(self, tag: str):
        """The (step, histogram dict) pairs of a tag, read back from the
        event files."""
        return _read_dir(self.log_dir, tag, _read_histograms)

    def close(self):
        self.writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# the resilience counters the trainers write (cumulative values):
# non-finite skipped steps, retry attempts and background checkpoint
# write failures; read back with read_scalar(tag)
RESILIENCE_TAGS = ("NonFiniteSkips", "RetryCount",
                   "CheckpointWriteFailures")

# per-layer numerics (the health monitor, obs/health.py): each layer
# gets one scalar stream a prefix, tagged "<prefix><layer-path>" (e.g.
# "GradNorm/0/weight"); read back with read_scalar(tag)
HEALTH_TAG_PREFIXES = ("GradNorm/", "ParamNorm/", "UpdateRatio/")


class TrainSummary(_Summary):
    """Loss and throughput a step; ``set_summary_trigger("Parameters",
    trigger)`` adds parameter histograms; the trainers add the
    ``RESILIENCE_TAGS`` streams."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")

    def add_resilience(self, step: int, nonfinite_skips=None, retries=None,
                       checkpoint_write_failures=None):
        """Record the resilience counters that changed at ``step``."""
        for tag, value in zip(RESILIENCE_TAGS,
                              (nonfinite_skips, retries,
                               checkpoint_write_failures)):
            if value is not None:
                self.add_scalar(tag, float(value), step)
        return self

    def add_health(self, step: int, layers: dict):
        """Per-layer numerics scalars from one health sample
        (``{layer: {grad_norm, param_norm, update_ratio, ...}}``): one
        stream per (prefix, layer) of :data:`HEALTH_TAG_PREFIXES`.  The
        trainers' health monitor (``obs/health.py``,
        ``BIGDL_TORCH_HEALTH_EVERY``) calls it with each sample."""
        keys = ("grad_norm", "param_norm", "update_ratio")
        for layer, row in layers.items():
            for prefix, key in zip(HEALTH_TAG_PREFIXES, keys):
                v = row.get(key)
                if v is not None and np.isfinite(v):
                    self.add_scalar(prefix + layer, float(v), step)
        return self

    def set_summary_trigger(self, name: str, trigger):
        """name in {"Parameters", "Loss", "Throughput", "LearningRate"}"""
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(_Summary):
    """Each validation method's value at the ``neval`` of its run."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


# ------------------------------------------------------------ event reader
def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_summary_values(path: str):
    """(step, Value message bytes) of every Summary.Value in a framed
    event file: the one decoder under both readers."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        pos += 12  # len + len-crc
        event = data[pos : pos + length]
        pos += length + 4  # data + data-crc
        step, summary = 0, None
        epos = 0
        while epos < len(event):
            key, epos = _read_varint(event, epos)
            field, wire = key >> 3, key & 7
            if wire == 0:
                val, epos = _read_varint(event, epos)
                if field == 2:
                    step = val
            elif wire == 1:
                epos += 8
            elif wire == 5:
                epos += 4
            elif wire == 2:
                ln, epos = _read_varint(event, epos)
                if field == 5:
                    summary = event[epos : epos + ln]
                epos += ln
        if summary is None:
            continue
        spos = 0
        while spos < len(summary):
            key, spos = _read_varint(summary, spos)
            if key >> 3 == 1 and key & 7 == 2:
                ln, spos = _read_varint(summary, spos)
                yield step, summary[spos : spos + ln]
                spos += ln
            else:
                break


def _read_scalars(path: str, want_tag: str):
    out = []
    for step, value_msg in _iter_summary_values(path):
        tag, simple = None, None
        vpos = 0
        while vpos < len(value_msg):
            k2, vpos = _read_varint(value_msg, vpos)
            f2, w2 = k2 >> 3, k2 & 7
            if w2 == 2:
                ln2, vpos = _read_varint(value_msg, vpos)
                if f2 == 1:
                    tag = value_msg[vpos : vpos + ln2].decode()
                vpos += ln2
            elif w2 == 5:
                if f2 == 2:
                    (simple,) = struct.unpack_from("<f", value_msg, vpos)
                vpos += 4
            elif w2 == 1:
                vpos += 8
            elif w2 == 0:
                _, vpos = _read_varint(value_msg, vpos)
        if tag == want_tag and simple is not None:
            out.append((step, simple))
    return out


def _parse_histo(histo: bytes) -> dict:
    """Decode a HistogramProto (fields as in the module docstring)."""
    out = {"min": 0.0, "max": 0.0, "num": 0.0, "sum": 0.0,
           "sum_squares": 0.0, "bucket_limit": [], "bucket": []}
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    pos = 0
    while pos < len(histo):
        key, pos = _read_varint(histo, pos)
        field, wire = key >> 3, key & 7
        if wire == 1:
            (v,) = struct.unpack_from("<d", histo, pos)
            pos += 8
            if field in names:
                out[names[field]] = v
            elif field == 6:
                out["bucket_limit"].append(v)  # unpacked repeated form
            elif field == 7:
                out["bucket"].append(v)
        elif wire == 2:
            ln, pos = _read_varint(histo, pos)
            payload = histo[pos : pos + ln]
            pos += ln
            if field in (6, 7):  # packed repeated doubles
                vals = [struct.unpack_from("<d", payload, i)[0]
                        for i in range(0, len(payload) - 7, 8)]
                out["bucket_limit" if field == 6 else "bucket"].extend(vals)
        elif wire == 0:
            _, pos = _read_varint(histo, pos)
        elif wire == 5:
            pos += 4
    return out


def _read_histograms(path: str, want_tag: str):
    out = []
    for step, value_msg in _iter_summary_values(path):
        tag, histo = None, None
        vpos = 0
        while vpos < len(value_msg):
            k2, vpos = _read_varint(value_msg, vpos)
            f2, w2 = k2 >> 3, k2 & 7
            if w2 == 2:
                ln2, vpos = _read_varint(value_msg, vpos)
                if f2 == 1:
                    tag = value_msg[vpos : vpos + ln2].decode()
                elif f2 == 5:
                    histo = value_msg[vpos : vpos + ln2]
                vpos += ln2
            elif w2 == 5:
                vpos += 4
            elif w2 == 1:
                vpos += 8
            elif w2 == 0:
                _, vpos = _read_varint(value_msg, vpos)
        if tag == want_tag and histo is not None:
            out.append((step, _parse_histo(histo)))
    return out


def _read_dir(log_dir: str, tag: str, reader):
    """``reader``'s pairs of ``tag`` over every event file of
    ``log_dir``, files in name order."""
    out = []
    for fname in sorted(os.listdir(log_dir)):
        if "tfevents" in fname:
            out.extend(reader(os.path.join(log_dir, fname), tag))
    return out


__all__ = ["FileWriter", "TrainSummary", "ValidationSummary",
           "RESILIENCE_TAGS", "HEALTH_TAG_PREFIXES", "crc32c"]
