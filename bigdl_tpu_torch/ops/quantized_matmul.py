"""Int8 matmul with per-channel weight scales.

Counterpart of ``bigdl_tpu/ops/quantized_matmul.py``.  The JAX package
computes the int8 product with ``lax.dot_general`` and an int32
accumulator, outside any Pallas kernel; here it is ``torch._int_mm``
(cuBLASLt's int8 GEMM on the card, an exact int32 product on the CPU),
so this module adds no kernel of its own.

cuBLASLt's int8 path takes only some shapes: more than 16 rows, and a
reduction and output width that are multiples of 8.  ``int8_mm`` pads
rows, K and N with zeros to such a shape and slices the result: zero
codes leave every int32 sum exact.  A shape the library still refuses
raises; nothing falls back to a float product.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.common import resolve_device

# cuBLASLt's int8 GEMM: rows must exceed 16, K and N be multiples of 8
_MIN_ROWS, _ALIGN = 17, 8


def quantize_per_channel(w: torch.Tensor, axis: int = 0):
    """Symmetric per-channel int8 codes of a float weight:
    ``(w_int8, scale)`` with ``w ≈ w_int8 * scale``, the scale kept
    with size 1 on every axis but ``axis`` (JAX :15-27, the same
    operations in the same order, so codes and scales agree bit for
    bit)."""
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    absmax = torch.amax(torch.abs(w), dim=reduce_axes, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if tuple(t.shape) == (rows, cols):
        return t.contiguous()
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ w.T`` of int8 ``a`` (M, K) and ``w`` (N, K).
    On the card, ``torch._int_mm`` on zero-padded operands; on the CPU,
    ``torch._int_mm`` as it is."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8 operands, got {a.dtype} and "
                        f"{w.dtype}")
    m, k = a.shape
    n, k2 = w.shape
    if k != k2:
        raise ValueError(f"int8_mm: K {k} != {k2}")
    if a.device.type == "cpu":
        return torch._int_mm(a.contiguous(), w.contiguous().t())
    mp = _round_up(max(m, _MIN_ROWS), _ALIGN)
    kp, np_ = _round_up(k, _ALIGN), _round_up(n, _ALIGN)
    acc = torch._int_mm(_padded(a, mp, kp), _padded(w, np_, kp).t())
    return acc[:m, :n]


def int8_mm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``int8_mm``'s plain version: the product in float64, exact for
    int8 codes while K < 2^38 (each product is under 2^14 and the sum
    stays under 2^53), cast to int32."""
    return torch.matmul(a.double(), w.double().t()).to(torch.int32)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                x_scale: Optional[torch.Tensor] = None,
                impl: Optional[str] = None, *, device="cuda"):
    """``y = x @ w_q.T * scales`` (JAX :30-79).

    ``x``: float (..., K) activations, quantized per row on the fly
    (symmetric, absmax / 127) unless ``x_scale`` comes with an
    already-int8 ``x``.  ``w_q``: int8 (N, K); ``w_scale``: (N, 1).
    ``impl``: None (= "int8": the int32-accumulated product, then
    ``acc * x_scale * w_scale`` in that order), "auto" ("int8", or with
    ``BIGDL_TORCH_TUNER=1`` the cached ``int8_mm`` decision of
    ``ops/autotune``), "int8", or "dequant" (the weight scaled back to
    float and a float matmul, the same weight rounding).
    ``x`` must lie on ``device`` (default the card; raises without CUDA
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if x.device != dev:
        raise ValueError(f"int8_matmul: x lives on {x.device}, not {dev}")
    if impl in (None, "auto"):
        chosen = "int8"
        if impl == "auto":
            from bigdl_tpu_torch.ops import autotune

            if autotune.enabled():
                rec = autotune.decide_int8_mm(x.shape, w_q.shape, x.dtype,
                                              arrays=(x, w_q, w_scale))
                if rec is not None:
                    chosen = rec.get("impl", "int8")
        impl = chosen
    if impl == "dequant":
        w = w_q.float() * w_scale
        xf = x.float() * x_scale if x_scale is not None else x
        return torch.matmul(xf, w.t())
    if impl != "int8":
        raise ValueError(f"impl must be auto|int8|dequant, got {impl!r}")
    if x_scale is None:
        absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        x_scale = torch.clamp_min(absmax, 1e-8) / 127.0
        x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(
            torch.int8)
    else:
        x_q = x
    acc = int8_mm(x_q.reshape(-1, x_q.shape[-1]), w_q)
    acc = acc.reshape(*x_q.shape[:-1], w_q.shape[0])
    return acc.float() * x_scale * w_scale.reshape(-1)


__all__ = ["quantize_per_channel", "int8_mm", "int8_mm_plain",
           "int8_matmul"]
