"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart: Pallas compiled its kernels inside ``jit``.  Here
each source under ``bigdl_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C
interface, at first use, and loaded with ``ctypes``.  All sources that
need building are compiled at once, one ``nvcc`` process each.  A
library's file name carries a hash of its source and flags, so an
edited source is never served from a stale build.

Each launch function here checks the CUDA error state right after the
launch (the C function returns ``cudaGetLastError()``) and raises if it
is not 0, then adds one to its entry in ``launches``.  The callers in
``ops.attention`` and ``ops.decode_attention`` check devices, dtypes,
shapes and contiguity before they get here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

import torch

from bigdl_tpu_torch import config

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCES = {"flash_fwd": "flash_fwd.cu", "paged_decode": "paged_decode.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# dtype codes shared with the C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launches(), by kernel name
launches: Dict[str, int] = {name: 0 for name in SOURCES}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, bh, tq, tk, d, causal, scale, dtype, stream
    "flash_fwd": ("bigdl_flash_fwd",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    # q, kp, vp, tables, lengths, out, b, h, d, page_size, maxp, scale,
    # q_dtype, kv_dtype, stream
    "paged_decode": ("bigdl_paged_decode",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                      _I, _P]),
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(config.build_dir(),
                        f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile (where no build of the current source exists) and load
    the named kernels, all ``nvcc`` runs in parallel.  Returns the wall
    seconds spent compiling (0.0 when every kernel was already
    built)."""
    names = list(SOURCES if names is None else names)
    t0 = time.perf_counter()
    with _lock:
        os.makedirs(config.build_dir(), exist_ok=True)
        procs = {}
        for name in names:
            path = _lib_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [config.nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        seconds = time.perf_counter() - t0 if procs else 0.0
        for name in names:
            lib = ctypes.CDLL(_lib_path(name))
            sym, argtypes = _SIGNATURES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.bigdl_error_string.argtypes = [ctypes.c_int]
            lib.bigdl_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return seconds


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name]
    return lib


def _check(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.bigdl_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_flash_fwd(q, k, v, o, lse, *, causal: bool, scale: float) -> None:
    """q (BH, Tq, D), k/v (BH, Tk, D), o like q, lse (BH, Tq) f32 or
    None; all contiguous on one card, checked by the caller."""
    lib = _lib("flash_fwd")
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        code = lib.bigdl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            bh, tq, k.shape[1], d, int(bool(causal)), float(scale),
            DTYPE_CODES[q.dtype], _stream(q))
    _check(lib, "flash_fwd", code)
    launches["flash_fwd"] += 1


def launch_paged_decode(q, kp, vp, tables, lengths, out, *, page_size: int,
                        scale: float) -> None:
    """q/out (B, H, Dh), kp/vp (pages, H, P, Dh), tables (B, maxp) i32,
    lengths (B,) i32; all contiguous on one card, checked by the
    caller."""
    lib = _lib("paged_decode")
    b, h, d = q.shape
    with torch.cuda.device(q.device):
        code = lib.bigdl_paged_decode(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, h, d, int(page_size),
            tables.shape[1], float(scale), DTYPE_CODES[q.dtype],
            DTYPE_CODES[kp.dtype], _stream(q))
    _check(lib, "paged_decode", code)
    launches["paged_decode"] += 1


__all__ = ["build", "launches", "reset_launches", "launch_flash_fwd",
           "launch_paged_decode", "SOURCES", "CSRC"]
