"""The port's TFRecord files and ``tf.train.Example`` codec against the
JAX package's, on the CPU.

- ``encode_example`` and ``TFRecordWriter`` write the JAX package's
  bytes for the same features (floats, ints with negatives, bytes,
  strings, string arrays).
- Each package reads the other's files: ``tfrecord_iterator``,
  ``decode_example``/``parse_example`` with ``FixedLenFeature``
  defaults, and ``TFRecordExampleDataset`` batches and tables.
- A flipped byte in a length, a payload or a CRC is caught by both
  readers; a truncated file too.
"""

import numpy as np
import pytest

from bigdl_tpu.utils import tf_records as JR
from bigdl_tpu_torch.utils import tf_records as TR


def _features(i, rs):
    return {"x": rs.randn(4).astype(np.float32),
            "ids": np.asarray([i, -3, 2 ** 40], np.int64),
            "label": np.asarray([float(i % 3)], np.float32),
            "raw": rs.randn(3).astype(np.float32).tobytes(),
            "tags": ["a", "bc"], "name": f"rec{i}",
            "strs": np.asarray([b"p", b"q"], dtype=object)}


def _write(R, path, n=7):
    rs = np.random.RandomState(0)
    with R.TFRecordWriter(str(path)) as w:
        for i in range(n):
            w.write(R.encode_example(_features(i, rs)))


def test_writers_write_equal_bytes(tmp_path):
    rs1, rs2 = np.random.RandomState(1), np.random.RandomState(1)
    for i in range(3):
        assert TR.encode_example(_features(i, rs1)) == \
            JR.encode_example(_features(i, rs2))
    _write(JR, tmp_path / "j.tfrecord")
    _write(TR, tmp_path / "t.tfrecord")
    assert (tmp_path / "j.tfrecord").read_bytes() == \
        (tmp_path / "t.tfrecord").read_bytes()


SPEC = {"x": ((4,), "float32", None), "ids": ((3,), "int64", None),
        "label": ((1,), "float32", None), "raw": ((), bytes, None),
        "missing": ((2,), "float32", 7.0)}


def _spec(R):
    return {k: R.FixedLenFeature(*v) for k, v in SPEC.items()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_files(writer, tmp_path):
    path = tmp_path / "d.tfrecord"
    _write(JR if writer == "jax" else TR, path)
    tj = list(JR.tfrecord_iterator(str(path)))
    tt = list(TR.tfrecord_iterator(str(path)))
    assert tt == tj and len(tt) == 7
    for raw in tt:
        dj, dt = JR.decode_example(raw), TR.decode_example(raw)
        assert dt.keys() == dj.keys()
        for k in dj:
            assert dt[k][0] == dj[k][0]
            np.testing.assert_array_equal(np.asarray(dt[k][1], object),
                                          np.asarray(dj[k][1], object))
        pj, pt = JR.parse_example(raw, _spec(JR)), \
            TR.parse_example(raw, _spec(TR))
        for k in SPEC:
            np.testing.assert_array_equal(pt[k], pj[k])
    with pytest.raises(KeyError):
        TR.parse_example(tt[0], {"nope": TR.FixedLenFeature((1,))})
    tf = {"raw": lambda b: np.frombuffer(b, "<f4")}
    dj = JR.TFRecordExampleDataset([str(path)] * 2, _spec(JR), 4, tf)
    dt = TR.TFRecordExampleDataset([str(path)] * 2, _spec(TR), 4, tf)
    bj, bt = list(dj.batches()), list(dt.batches())
    assert [len(b["x"]) for b in bt] == [4, 4, 4, 2]
    for a, b in zip(bt, bj):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert len(list(dt.batches(drop_remainder=True))) == 3
    tab_t, tab_j = dt.materialize(), dj.materialize()
    for k in tab_j:
        np.testing.assert_array_equal(tab_t[k], tab_j[k])


@pytest.mark.parametrize("where", ["length", "length_crc", "payload",
                                   "payload_crc", "truncated"])
def test_corruption_is_caught_by_both(where, tmp_path):
    path = tmp_path / "c.tfrecord"
    _write(TR, path, n=2)
    data = bytearray(path.read_bytes())
    first = int.from_bytes(data[:8], "little")
    at = {"length": 0, "length_crc": 8, "payload": 12 + first // 2,
          "payload_crc": 12 + first}.get(where)
    if at is None:
        data = data[:-3]
    else:
        data[at] ^= 0x40
    path.write_bytes(bytes(data))
    for R in (JR, TR):
        with pytest.raises((ValueError, MemoryError, OverflowError)):
            list(R.tfrecord_iterator(str(path)))
    if where in ("payload", "payload_crc"):     # unchecked, both read it
        assert len(list(TR.tfrecord_iterator(str(path), verify_crc=False))) \
            == len(list(JR.tfrecord_iterator(str(path), verify_crc=False)))
