"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart: Pallas compiled its kernels inside ``jit``.  Here
each source under ``bigdl_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C
interface, at first use, and loaded with ``ctypes``.  All sources that
need building are compiled at once, one ``nvcc`` process each.  A
library's file name carries a hash of its source, every header it
reaches from ``csrc/`` (followed through headers that include others)
and the flags, so an edited source or header is never served from a
stale build.  A build is traced as ``nvcc.compile`` and charged to the
goodput ledger as ``compile`` badput.  ``ptxas`` reports each kernel's registers and spills
(``-Xptxas=-v``); the compiler's output of the last build of each
source is kept in ``build_logs``.

Each launch function here checks the CUDA error state right after the
launch (the C function returns ``cudaGetLastError()``) and raises if it
is not 0, then adds one to its entry in ``launches``.  The callers in
``ops.attention``, ``ops.decode_attention`` and ``ops.conv_bn`` check
devices, dtypes, shapes and contiguity before they get here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

import torch

from bigdl_tpu_torch.config import build_dir, nvcc_path

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCES = {"flash_fwd": "flash_fwd.cu", "paged_decode": "paged_decode.cu",
           "conv_bn_1x1": "conv_bn_1x1.cu", "conv_bn_kxk": "conv_bn_kxk.cu",
           "flash_bwd_dq": "flash_bwd_dq.cu",
           "flash_bwd_dkv": "flash_bwd_dkv.cu",
           "fused_adam": "fused_adam.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes shared with the C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# output pixels per CTA of the f32 conv_bn kernels, 1x1 and kxk (BN in
# conv_bn_common.cuh), per sample
CONV_BN_TILE_P = 64
# flattened output pixels (across samples) per CTA of the bf16 conv_bn
# kernels on the tensor cores, 1x1 and kxk (TN in conv_bn_mma.cuh)
CONV_MMA_TILE_P = 128
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

# kernel launches since the last reset_launches(), by kernel name
launches: Dict[str, int] = {name: 0 for name in SOURCES}

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (with ptxas's resource report) by kernel name, for the
# sources compiled in this process
build_logs: Dict[str, str] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, o, lse, bh, tq, tk, d, dv, causal, seq_offset, scale,
    # dtype, stream
    "flash_fwd": ("bigdl_flash_fwd",
                  [_P] * 5 + [_I] * 7 + [_F, _I, _P]),
    # q, k, v, g, lse, delta, dq, bh, tq, tk, d, dv, causal, seq_offset,
    # scale, dtype, stream
    "flash_bwd_dq": ("bigdl_flash_bwd_dq",
                     [_P] * 7 + [_I] * 7 + [_F, _I, _P]),
    # q, k, v, g, lse, delta, dk, dv, bh, tq, tk, d, dv, causal,
    # seq_offset, scale, dtype, stream
    "flash_bwd_dkv": ("bigdl_flash_bwd_dkv",
                      [_P] * 8 + [_I] * 7 + [_F, _I, _P]),
    # q, kp, vp, tables, lengths, out, part, b, h, d, page_size, maxp,
    # splits, scale, q_dtype, kv_dtype, stream
    "paged_decode": ("bigdl_paged_decode",
                     [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P]),
    # x, w, shift, y, part, s1, s2, n, c, h, w, o, stride, dtype, stream
    "conv_bn_1x1": ("bigdl_conv_bn_1x1",
                    [_P] * 7 + [_I] * 7 + [_P]),
    # x, w, shift, y, part, s1, s2, xh, wh, n, c, h, w, o, k, stride, pad,
    # ho, wo, dtype, stream
    "conv_bn_kxk": ("bigdl_conv_bn_kxk",
                    [_P] * 9 + [_I] * 11 + [_P]),
    # pass, buf, n_tensors, n_chunks, grid, loss, lr, bc1, bc2, b1, c1,
    # b2, c2, eps, clip, lo, hi, flags, stream
    "fused_adam": ("bigdl_fused_adam",
                   [_I, _P, _I, _L, _I] + [_P] * 4 + [_F] * 8 + [_I, _P]),
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _headers(text: bytes) -> list:
    """The ``csrc/`` headers that ``text`` reaches through its quoted
    includes, transitively, each once, in the order first met."""
    seen, todo = [], list(_INCLUDE.findall(text))
    while todo:
        header = todo.pop(0).decode()
        if header in seen:
            continue
        seen.append(header)
        with open(os.path.join(CSRC, header), "rb") as f:
            todo += _INCLUDE.findall(f.read())
    return seen


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        text = f.read()
    digest = hashlib.sha256(text)
    for header in _headers(text):
        with open(os.path.join(CSRC, header), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(),
                        f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile (where no build of the current source exists) and load
    the named kernels, all ``nvcc`` runs in parallel.  Returns the wall
    seconds spent compiling (0.0 when every kernel was already
    built)."""
    names = list(SOURCES if names is None else names)
    t0 = time.perf_counter()
    with _lock:
        os.makedirs(build_dir(), exist_ok=True)
        procs = {}
        for name in names:
            path = _lib_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        seconds = time.perf_counter() - t0 if procs else 0.0
        if procs:
            # the port's only compile: the goodput ledger charges it as
            # `compile` badput, the run report lists the span
            from bigdl_tpu_torch import obs

            built = sorted(procs)
            obs.get_tracer().complete("nvcc.compile", t0, seconds,
                                      kernels=built)
            obs.get_ledger().record("compile", t0, seconds, kernels=built)
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


def launch_flash_fwd(q, k, v, o, lse, *, causal: bool, scale: float,
                     seq_offset: int = 0) -> None:
    """q (BH, Tq, Dqk), k (BH, Tk, Dqk), v (BH, Tk, Dv), o (BH, Tq, Dv),
    lse (BH, Tq) f32 or None; all contiguous on one card, checked by the
    caller.  Under ``causal`` query row i sits at absolute position
    ``seq_offset + i``."""
    lib = _lib("flash_fwd")
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        code = lib.bigdl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            bh, tq, k.shape[1], d, v.shape[2], int(bool(causal)),
            int(seq_offset),
            float(scale), DTYPE_CODES[q.dtype], _stream(q))
    _check(lib, "flash_fwd", code)
    launches["flash_fwd"] += 1


def launch_flash_bwd_dq(q, k, v, g, lse, delta, dq, *, causal: bool,
                        scale: float, seq_offset: int = 0) -> None:
    """q/dq (BH, Tq, Dqk), k (BH, Tk, Dqk), v (BH, Tk, Dv), g (BH, Tq,
    Dv), lse/delta (BH, Tq) f32; all contiguous on one card, q, k, v, g
    and dq of one dtype, checked by the caller; ``seq_offset`` as in
    :func:`launch_flash_fwd`."""
    lib = _lib("flash_bwd_dq")
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        code = lib.bigdl_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, tq,
            k.shape[1], d, v.shape[2], int(bool(causal)), int(seq_offset),
            float(scale),
            DTYPE_CODES[q.dtype], _stream(q))
    _check(lib, "flash_bwd_dq", code)
    launches["flash_bwd_dq"] += 1


def launch_flash_bwd_dkv(q, k, v, g, lse, delta, dk, dv, *, causal: bool,
                         scale: float, seq_offset: int = 0) -> None:
    """q (BH, Tq, Dqk), g (BH, Tq, Dv), k/dk (BH, Tk, Dqk), v/dv (BH, Tk,
    Dv), lse/delta (BH, Tq) f32; all contiguous on one card, the
    (BH, T, D) tensors of one dtype, checked by the caller;
    ``seq_offset`` as in :func:`launch_flash_fwd`."""
    lib = _lib("flash_bwd_dkv")
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        code = lib.bigdl_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, tq, k.shape[1], d, v.shape[2], int(bool(causal)),
            int(seq_offset),
            float(scale), DTYPE_CODES[q.dtype], _stream(q))
    _check(lib, "flash_bwd_dkv", code)
    launches["flash_bwd_dkv"] += 1


def launch_paged_decode(q, kp, vp, tables, lengths, out, part, *,
                        page_size: int, scale: float) -> None:
    """q/out (B, H, Dh), kp/vp (pages, H, P, Dh) 16-byte aligned, tables
    (B, maxp) i32, lengths (B,) i32, part (B, H, S, Dh + 2) f32 scratch
    for the S splits of each slot's KV (None when S is 1); all
    contiguous on one card, checked by the caller."""
    lib = _lib("paged_decode")
    b, h, d = q.shape
    splits = 1 if part is None else part.shape[2]
    with torch.cuda.device(q.device):
        code = lib.bigdl_paged_decode(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), b, h, d,
            int(page_size), tables.shape[1], splits, float(scale),
            DTYPE_CODES[q.dtype], DTYPE_CODES[kp.dtype], _stream(q))
    _check(lib, "paged_decode", code)
    launches["paged_decode"] += 1


def conv_bn_tiles(pixels: int) -> int:
    """CTAs per sample along the output pixels of the f32 conv_bn
    kernels (1x1 and kxk): per sample, the columns of the per-CTA
    statistics partials."""
    return -(-pixels // CONV_BN_TILE_P)


def conv_mma_tiles(pixels: int) -> int:
    """CTAs along the ``pixels = N·Ho·Wo`` output pixels of the bf16
    conv_bn kernels (1x1 and kxk), flattened across samples: the columns
    of their statistics partials."""
    return -(-pixels // CONV_MMA_TILE_P)


def launch_conv_bn_1x1(x, w, shift, y, part, s1, s2, *,
                       stride: int) -> None:
    """x (N, C, H, W), w (O, C, 1, 1) of x's dtype, shift (O,) f32,
    y (N, O, Ho, Wo) with Ho = (H − 1) // stride + 1, s1/s2 (O,) f32;
    all contiguous on one card, checked by the caller.  f32: part
    (2, O, N·conv_bn_tiles(Ho·Wo)).  bf16: C a multiple of 8, w 16-byte
    aligned, part (2, O, conv_mma_tiles(N·Ho·Wo))."""
    lib = _lib("conv_bn_1x1")
    n, c, h, wd = x.shape
    with torch.cuda.device(x.device):
        code = lib.bigdl_conv_bn_1x1(
            x.data_ptr(), w.data_ptr(), shift.data_ptr(), y.data_ptr(),
            part.data_ptr(), s1.data_ptr(), s2.data_ptr(), n, c, h, wd,
            w.shape[0], int(stride), DTYPE_CODES[x.dtype], _stream(x))
    _check(lib, "conv_bn_1x1", code)
    launches["conv_bn_1x1"] += 1


def launch_conv_bn_kxk(x, w, shift, y, part, s1, s2, *, stride: int,
                       pad: int, scratch=None) -> None:
    """x (N, C, H, W), w (O, C, k, k) of x's dtype, shift (O,) f32,
    y (N, O, Ho, Wo), s1/s2 (O,) f32; all contiguous on one card,
    checked by the caller.  f32: part (2, O, N·conv_bn_tiles(Ho·Wo)),
    no scratch.  bf16: part (2, O, conv_mma_tiles(N·Ho·Wo)) and
    ``scratch`` = (xh (N, H, W, Cp), wh (O, k, k, Cp)) bf16, Cp = C
    rounded up to a multiple of 8, 16-byte aligned: the kernel's layout
    pass writes x and w there as ``ops.conv_bn.kxk_operands`` does."""
    lib = _lib("conv_bn_kxk")
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    xh, wh = (None, None) if scratch is None else (
        t.data_ptr() for t in scratch)
    with torch.cuda.device(x.device):
        code = lib.bigdl_conv_bn_kxk(
            x.data_ptr(), w.data_ptr(), shift.data_ptr(), y.data_ptr(),
            part.data_ptr(), s1.data_ptr(), s2.data_ptr(), xh, wh, n, c, h,
            wd, o, k, int(stride), int(pad), y.shape[2], y.shape[3],
            DTYPE_CODES[x.dtype], _stream(x))
    _check(lib, "conv_bn_kxk", code)
    launches["conv_bn_kxk"] += 1


def launch_fused_adam(pass_: int, buf, n_tensors: int, n_chunks: int,
                      grid: int, loss, lr, bc1, bc2, b1: float, c1: float,
                      b2: float, c2: float, eps: float, clip: float,
                      lo: float, hi: float, flags: int) -> None:
    """Pass 1 (``loss``) or 2 (``lr``, ``bc1``, ``bc2``: 0-d f32) of the
    fused Adam update over ``buf`` (int64, on one card: the header, the
    table of ``n_tensors`` entries and ``grid`` partials, laid out by
    ``ops.fused_update.KernelAdamUpdate``, which checks the tensors)."""
    lib = _lib("fused_adam")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(buf.device):
        code = lib.bigdl_fused_adam(
            int(pass_), buf.data_ptr(), int(n_tensors), int(n_chunks),
            int(grid), ptr(loss), ptr(lr), ptr(bc1), ptr(bc2), float(b1),
            float(c1), float(b2), float(c2), float(eps), float(clip),
            float(lo), float(hi), int(flags), _stream(buf))
    _check(lib, "fused_adam", code)
    launches["fused_adam"] += 1


__all__ = ["build", "build_logs", "launches", "reset_launches",
           "launch_flash_fwd", "launch_fused_adam",
           "launch_flash_bwd_dq", "launch_flash_bwd_dkv",
           "launch_paged_decode", "launch_conv_bn_1x1", "launch_conv_bn_kxk",
           "conv_bn_tiles", "conv_mma_tiles", "SOURCES", "CSRC"]
