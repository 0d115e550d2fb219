"""The host library: ctypes bindings over ``csrc/host/bigdl_native.cpp``,
each function with its numpy fallback.

Counterpart of ``bigdl_tpu/native/__init__.py``.  The card runs the
model; the input feed around it runs here, on the host: the fp16 wire
codec, the minibatch row gather (``ArrayDataSet``'s f32 batches), the
one-pass uint8 gather + normalize, and the OpenCV-style image ops on
CHW float32 (``transform.vision``'s resize, after Pillow).

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC
-shared -pthread`` into ``config.build_dir()`` (``build/bigdl_tpu_torch``
or ``BIGDL_TORCH_BUILD_DIR``), named by a hash of the source and the
flags, so a changed source builds anew and a built one is reused.  The
numpy fallbacks are taken in two cases only:

- ``BIGDL_TORCH_NO_NATIVE`` is set;
- no C++ compiler exists (``CXX``, else ``g++``): a warning is logged
  once and :func:`unavailable_reason` says why.

A compiler that fails on the source, a built library that does not
load, or one with another ABI version raises: nothing falls back
silently from a library that should be there.  The fallbacks compute
the same function; those of fp16, gather, crop and hflip are
bit-equal to the library, normalize's and the uint8 gather's within
an f32 rounding (the library multiplies by 1/std where they divide),
and resize's does the library's f32 arithmetic in the same order
(bit-equal unless the compiler fuses a multiply-add).

``PrefetchIterator`` is the feed's producer thread of
``dataset/prefetch.py``, re-exported here as JAX exports its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from bigdl_tpu_torch.dataset.prefetch import PrefetchIterator

log = logging.getLogger("bigdl_tpu_torch.native")

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "host", "bigdl_native.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# (the no-native knob, the compiler) the last _load decided for; None: not yet
_key = None
_reason: Optional[str] = None

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX") or "g++")


def lib_path(cxx: str) -> str:
    """Where the library built by ``cxx`` lives: the build directory, a
    file named by a hash of the source, the compiler and the flags."""
    from bigdl_tpu_torch.config import build_dir

    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join((os.path.basename(cxx),) + CXX_FLAGS).encode())
    return os.path.join(build_dir(),
                        f"libbigdl_native_{h.hexdigest()[:16]}.so")


def _build(cxx: str, path: str) -> None:
    """Compile the source to ``path`` (atomically: a concurrent build
    or reader never sees half a file).  Raises with the compiler's
    output when it fails."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-Wall", "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {SOURCE} with {cxx} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)           # an OSError here is not a fallback
    lib.fp16_compress.argtypes = [_f32p, _u16p, _i64]
    lib.fp16_decompress.argtypes = [_u16p, _f32p, _i64]
    lib.gather_rows.argtypes = [_f32p, _i64p, _f32p, _i64, _i64]
    lib.gather_rows_mt.argtypes = [_f32p, _i64p, _f32p, _i64, _i64,
                                   ctypes.c_int]
    lib.gather_normalize_u8.argtypes = [_u8p, _i64p, _f32p, _i64, _i64,
                                        _i64, _f32p, _f32p]
    lib.resize_bilinear_chw.argtypes = [_f32p, _f32p] + [_i64] * 5
    lib.crop_chw.argtypes = [_f32p, _f32p] + [_i64] * 7
    lib.hflip_chw.argtypes = [_f32p, _f32p] + [_i64] * 3
    lib.normalize_chw.argtypes = [_f32p, _i64, _i64, _f32p, _f32p]
    lib.native_abi_version.restype = ctypes.c_int
    got = lib.native_abi_version()
    if got != ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {got}, this binding "
                           f"speaks {ABI_VERSION}")
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on first use; None when a fallback
    is due (the knob, or no compiler).  Re-decided when the knob or the
    compiler changes."""
    global _lib, _key, _reason
    from bigdl_tpu_torch.config import HostConfig

    no_native = HostConfig.from_env().no_native
    cxx = None if no_native else _compiler()
    key = (no_native, cxx)
    if key == _key:
        return _lib
    with _lock:
        if key == _key:
            return _lib
        lib, reason = None, None
        if no_native:
            reason = "BIGDL_TORCH_NO_NATIVE is set"
        elif cxx is None:
            reason = (f"no C++ compiler ({os.environ.get('CXX') or 'g++'} "
                      "is not on PATH)")
            log.warning("native: %s; the host library's functions take "
                        "their numpy fallbacks", reason)
        else:
            path = lib_path(cxx)
            if not os.path.exists(path):
                _build(cxx, path)
            lib = _bind(path)
        _lib, _reason, _key = lib, reason, key
        return _lib


def available() -> bool:
    """Whether the functions below run the library (else their numpy
    fallbacks)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why :func:`available` is False, or None when it is True."""
    _load()
    return _reason


# ---- fp16 codec ---------------------------------------------------------------
def fp16_compress(arr: np.ndarray) -> np.ndarray:
    """f32 -> IEEE half bits (uint16), round to nearest even."""
    a = np.ascontiguousarray(arr, np.float32)
    lib = _load()
    if lib is None:
        return a.astype(np.float16).view(np.uint16).reshape(a.shape)
    out = np.empty(a.shape, np.uint16)
    lib.fp16_compress(a.reshape(-1), out.reshape(-1), a.size)
    return out


def fp16_decompress(arr: np.ndarray) -> np.ndarray:
    """IEEE half bits (uint16) -> f32."""
    a = np.ascontiguousarray(arr, np.uint16)
    lib = _load()
    if lib is None:
        return a.view(np.float16).astype(np.float32).reshape(a.shape)
    out = np.empty(a.shape, np.float32)
    lib.fp16_decompress(a.reshape(-1), out.reshape(-1), a.size)
    return out


# ---- minibatch assembly -------------------------------------------------------
def gather_rows(src: np.ndarray, idx: np.ndarray,
                n_threads: int = 0) -> np.ndarray:
    """``src[idx]`` for float32 ``src``: one memcpy a row, the rows
    split over ``n_threads`` threads (0: up to 4)."""
    s = np.ascontiguousarray(src, np.float32)
    flat = s.reshape(s.shape[0], -1)
    ix = np.ascontiguousarray(idx, np.int64)
    lib = _load()
    if lib is None:
        return flat[ix].reshape((len(ix),) + s.shape[1:])
    out = np.empty((len(ix), flat.shape[1]), np.float32)
    if n_threads <= 0:
        n_threads = min(4, os.cpu_count() or 1)
    lib.gather_rows_mt(flat, ix, out, len(ix), flat.shape[1], n_threads)
    return out.reshape((len(ix),) + s.shape[1:])


def gather_normalize_u8(src: np.ndarray, idx: np.ndarray,
                        mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """One pass over (N, C, ...) uint8 ``src``: ``(src[idx] - mean[c]) /
    std[c]`` as float32."""
    s = np.ascontiguousarray(src, np.uint8)
    n, c = s.shape[0], s.shape[1]
    hw = int(np.prod(s.shape[2:]))
    ix = np.ascontiguousarray(idx, np.int64)
    m = np.ascontiguousarray(mean, np.float32).reshape(-1)
    sd = np.ascontiguousarray(std, np.float32).reshape(-1)
    if m.size == 1:
        m = np.repeat(m, c)
    if sd.size == 1:
        sd = np.repeat(sd, c)
    lib = _load()
    if lib is None:
        shape = (1, c) + (1,) * (s.ndim - 2)
        return (s[ix].astype(np.float32) - m.reshape(shape)) / \
            sd.reshape(shape)
    out = np.empty((len(ix), c * hw), np.float32)
    lib.gather_normalize_u8(s.reshape(-1), ix, out.reshape(-1), len(ix),
                            c, hw, m, sd)
    return out.reshape((len(ix),) + s.shape[1:])


# ---- image ops (CHW float32) ---------------------------------------------------
def _resize_plain(a: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear with half-pixel centres and clamped edges, in f32: the
    library's arithmetic in numpy (JAX's fallback is
    ``jax.image.resize``, which the port does not have)."""
    c, h, w = a.shape

    def axis(n_in, n_out):
        f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
             * (np.float32(n_in) / np.float32(n_out)) - np.float32(0.5))
        i0 = np.floor(f).astype(np.int64)
        wgt = (f - i0.astype(np.float32)).astype(np.float32)
        return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1),
                wgt)

    y0, y1, wy = axis(h, out_h)
    x0, x1, wx = axis(w, out_w)
    wx, wy = wx[None, None, :], wy[None, :, None]
    top = a[:, y0][:, :, x0] + (a[:, y0][:, :, x1] - a[:, y0][:, :, x0]) * wx
    bot = a[:, y1][:, :, x0] + (a[:, y1][:, :, x1] - a[:, y1][:, :, x0]) * wx
    return (top + (bot - top) * wy).astype(np.float32)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(C, H, W) float32 -> (C, out_h, out_w), bilinear, half-pixel
    centres (OpenCV's ``INTER_LINEAR``)."""
    a = np.ascontiguousarray(img, np.float32)
    c, h, w = a.shape
    lib = _load()
    if lib is None:
        return _resize_plain(a, out_h, out_w)
    out = np.empty((c, out_h, out_w), np.float32)
    lib.resize_bilinear_chw(a, out, c, h, w, out_h, out_w)
    return out


def crop(img: np.ndarray, y: int, x: int, out_h: int,
         out_w: int) -> np.ndarray:
    """The (C, out_h, out_w) window of a CHW image at (y, x)."""
    a = np.ascontiguousarray(img, np.float32)
    c, h, w = a.shape
    lib = _load()
    if lib is None:
        return a[:, y:y + out_h, x:x + out_w].copy()
    out = np.empty((c, out_h, out_w), np.float32)
    lib.crop_chw(a, out, c, h, w, y, x, out_h, out_w)
    return out


def hflip(img: np.ndarray) -> np.ndarray:
    """A CHW image mirrored left to right."""
    a = np.ascontiguousarray(img, np.float32)
    lib = _load()
    if lib is None:
        return a[:, :, ::-1].copy()
    out = np.empty_like(a)
    lib.hflip_chw(a, out, *a.shape)
    return out


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """``(img - mean[c]) / std[c]`` over a (C, ...) image, into a copy."""
    a = np.ascontiguousarray(img, np.float32).copy()
    c = a.shape[0]
    hw = int(np.prod(a.shape[1:]))
    m = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32),
                                             (c,)))
    sd = np.ascontiguousarray(np.broadcast_to(np.asarray(std, np.float32),
                                              (c,)))
    lib = _load()
    if lib is None:
        shape = (c,) + (1,) * (a.ndim - 1)
        return (a - m.reshape(shape)) / sd.reshape(shape)
    lib.normalize_chw(a.reshape(-1), c, hw, m, sd)
    return a


__all__ = ["available", "unavailable_reason", "lib_path", "fp16_compress",
           "fp16_decompress", "gather_rows", "gather_normalize_u8",
           "resize_bilinear", "crop", "hflip", "normalize",
           "PrefetchIterator"]
