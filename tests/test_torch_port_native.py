"""The port's host library (``bigdl_tpu_torch.native``) against its own
numpy fallbacks and against ``bigdl_tpu.native``, on the CPU.

The library is built with this machine's ``g++`` from
``bigdl_tpu_torch/csrc/host/bigdl_native.cpp`` into the build directory.
Each function runs on the same seeded inputs three ways: the port's
library, the port's fallback (``BIGDL_TORCH_NO_NATIVE=1``) and the JAX
package's binding.  The fp16 codec, the row gather, crop and hflip must
be bit-equal; resize, normalize and ``gather_normalize_u8`` within
``TOL`` relative to the largest magnitude (the library multiplies by
1/std where a fallback divides, and JAX's resize fallback is
``jax.image.resize``).  ``ArrayDataSet``'s batches are bit-equal with
and without the library; the vision resize takes the library only
without Pillow; a compiler that is missing is a readable fallback, and
one that fails is an error.
"""

import os

import numpy as np
import pytest

from bigdl_tpu import native as J
from bigdl_tpu_torch import native as T

TOL = 1e-6


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for k in ("BIGDL_TORCH_NO_NATIVE", "BIGDL_TPU_NO_NATIVE", "CXX"):
        monkeypatch.delenv(k, raising=False)
    yield


def _fallback(monkeypatch, fn, *args):
    monkeypatch.setenv("BIGDL_TORCH_NO_NATIVE", "1")
    try:
        assert not T.available()
        return fn(*args)
    finally:
        monkeypatch.delenv("BIGDL_TORCH_NO_NATIVE")


def _three(monkeypatch, name, *args):
    assert T.available(), T.unavailable_reason()
    lib = getattr(T, name)(*args)
    plain = _fallback(monkeypatch, getattr(T, name), *args)
    jax_ = getattr(J, name)(*args)
    assert T.available()
    return lib, plain, jax_


def _close(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a.astype(np.float64) - b).max()) <= TOL * scale


def test_the_library_is_built_from_the_port_source():
    assert T.available() and T.unavailable_reason() is None
    path = T.lib_path(T._compiler())
    assert os.path.exists(path)
    from bigdl_tpu_torch.config import build_dir

    assert os.path.dirname(path) == build_dir()
    assert T.SOURCE.endswith(os.path.join("bigdl_tpu_torch", "csrc", "host",
                                          "bigdl_native.cpp"))


def test_fp16_codec_is_bit_equal(monkeypatch):
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(997).astype(np.float32) * 300,
                        np.array([0.0, -0.0, 65504.0, 1e-8, -7e-5, 1e6,
                                  np.inf, -np.inf], np.float32)])
    for a in _three(monkeypatch, "fp16_compress", x):
        np.testing.assert_array_equal(a, J.fp16_compress(x))
    bits = rs.randint(0, 0x7c00, 1000).astype(np.uint16)
    lib, plain, jax_ = _three(monkeypatch, "fp16_decompress", bits)
    np.testing.assert_array_equal(lib, plain)
    np.testing.assert_array_equal(lib, jax_)


def test_gather_rows_is_bit_equal(monkeypatch):
    rs = np.random.RandomState(1)
    src = rs.randn(50, 3, 7, 5).astype(np.float32)
    idx = rs.permutation(50)[:33]
    lib, plain, jax_ = _three(monkeypatch, "gather_rows", src, idx)
    np.testing.assert_array_equal(lib, src[idx])
    np.testing.assert_array_equal(lib, plain)
    np.testing.assert_array_equal(lib, jax_)
    one = T.gather_rows(src, idx, n_threads=1)
    np.testing.assert_array_equal(one, lib)


def test_gather_normalize_u8_within_tol(monkeypatch):
    rs = np.random.RandomState(2)
    src = rs.randint(0, 256, (40, 3, 6, 6)).astype(np.uint8)
    idx = rs.permutation(40)[:17]
    mean = np.array([125.3, 122.9, 113.8], np.float32)
    std = np.array([63.0, 62.1, 66.7], np.float32)
    lib, plain, jax_ = _three(monkeypatch, "gather_normalize_u8", src, idx,
                              mean, std)
    _close(lib, plain)
    np.testing.assert_array_equal(lib, jax_)     # the same C code
    ref = (src[idx].astype(np.float64) - mean[None, :, None, None]) \
        / std[None, :, None, None]
    _close(lib, ref.astype(np.float32))


@pytest.mark.parametrize("shape,out", [((3, 37, 53), (64, 20)),
                                       ((1, 8, 8), (3, 13)),
                                       ((3, 224, 224), (112, 112))])
def test_resize_within_tol(monkeypatch, shape, out):
    rs = np.random.RandomState(3)
    img = (rs.rand(*shape) * 255).astype(np.float32)
    lib, plain, jax_ = _three(monkeypatch, "resize_bilinear", img, *out)
    _close(lib, plain)
    if J.available():
        np.testing.assert_array_equal(lib, jax_)
    else:
        _close(lib, jax_)


def test_crop_and_hflip_are_bit_equal(monkeypatch):
    rs = np.random.RandomState(4)
    img = rs.randn(3, 20, 30).astype(np.float32)
    for args in ((img, 3, 5, 10, 12), (img, 0, 0, 20, 30)):
        lib, plain, jax_ = _three(monkeypatch, "crop", *args)
        np.testing.assert_array_equal(lib, plain)
        np.testing.assert_array_equal(lib, jax_)
    lib, plain, jax_ = _three(monkeypatch, "hflip", img)
    np.testing.assert_array_equal(lib, img[:, :, ::-1])
    np.testing.assert_array_equal(lib, plain)
    np.testing.assert_array_equal(lib, jax_)


def test_normalize_within_tol(monkeypatch):
    rs = np.random.RandomState(5)
    img = (rs.rand(3, 9, 11) * 255).astype(np.float32)
    before = img.copy()
    lib, plain, jax_ = _three(monkeypatch, "normalize", img,
                              [0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
    np.testing.assert_array_equal(img, before)          # a copy
    _close(lib, plain)
    np.testing.assert_array_equal(lib, jax_)


def test_no_native_takes_every_fallback(monkeypatch):
    calls = []
    monkeypatch.setenv("BIGDL_TORCH_NO_NATIVE", "1")
    monkeypatch.setattr(T, "_bind", lambda *a: calls.append(a))
    assert not T.available()
    assert "BIGDL_TORCH_NO_NATIVE" in T.unavailable_reason()
    x = np.ones((4, 3), np.float32)
    T.gather_rows(x, np.array([1, 0]))
    T.fp16_decompress(T.fp16_compress(x))
    T.resize_bilinear(np.ones((1, 4, 4), np.float32), 2, 2)
    assert calls == []
    monkeypatch.delenv("BIGDL_TORCH_NO_NATIVE")
    monkeypatch.undo()
    assert T.available()


def test_prefetch_iterator_is_the_feeds_class():
    from bigdl_tpu_torch.dataset.prefetch import PrefetchIterator

    assert T.PrefetchIterator is PrefetchIterator
    assert list(T.PrefetchIterator(iter(range(5)))) == list(range(5))


def test_array_dataset_batches_equal_with_and_without(monkeypatch):
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet

    rs = np.random.RandomState(6)
    x = rs.randn(70, 3, 8, 8).astype(np.float32)
    y = rs.randint(1, 5, 70).astype(np.float32)
    gathered = []
    real = T.gather_rows
    monkeypatch.setattr(T, "gather_rows",
                        lambda *a, **k: gathered.append(1) or real(*a, **k))
    runs = []
    for off in ("", "1"):
        monkeypatch.setenv("BIGDL_TORCH_NO_NATIVE", off)
        assert T.available() == (off == "")
        batches = []
        for train in (True, False):
            RandomGenerator.RNG.set_seed(11)
            batches += list(ArrayDataSet(x, y, 16).data(train=train))
        runs.append(batches)
    assert len(runs[0]) == 4 + 5 and gathered
    for (a, ya), (b, yb) in zip(*runs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ya, yb)


def test_vision_resize_takes_the_library_without_pillow(monkeypatch):
    import builtins

    from bigdl_tpu_torch.transform import vision

    img = (np.random.RandomState(7).rand(12, 10, 3) * 255).astype(np.uint8)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = vision._resize_bilinear(img, 6, 5)
    want = T.resize_bilinear(np.ascontiguousarray(
        img.astype(np.float32).transpose(2, 0, 1)), 6, 5).transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("BIGDL_TORCH_NO_NATIVE", "1")
    plain = vision._resize_bilinear(img, 6, 5)
    assert plain.shape == (6, 5, 3) and not np.array_equal(plain, got)


def test_no_compiler_is_a_readable_fallback(monkeypatch, caplog, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with caplog.at_level("WARNING", logger="bigdl_tpu_torch.native"):
        assert not T.available()
    assert "no C++ compiler" in T.unavailable_reason()
    assert "numpy fallbacks" in caplog.text
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(T.gather_rows(x, np.array([2, 0])),
                                  x[[2, 0]])


def test_a_failing_compiler_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad-c++"
    bad.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    monkeypatch.setenv("BIGDL_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="broken"):
        T.available()
