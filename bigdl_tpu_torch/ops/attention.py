"""Scaled-dot-product attention: plain reference + the flash forward.

Counterpart of ``bigdl_tpu/ops/attention.py``:

* ``_reference_attention`` (JAX :52) is plain torch, the default path;
* ``flash_attention`` is the flash forward (JAX ``_flash_fwd_kernel``,
  :120, launched at :356).  On a CUDA tensor it launches the
  hand-written kernel ``csrc/flash_fwd.cu``; on a CPU tensor it runs
  ``flash_attention_plain``, the same tiled online softmax in torch;
* ``dot_product_attention`` (JAX :679) dispatches between them.

``impl="auto"`` keeps the JAX package's static policy for this card:
the reference path (JAX :673 takes the kernel only on a TPU at
Tq·Tk >= 4096²).  No H100 measurement yet justifies another crossover.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from bigdl_tpu_torch.ops import _cuda

# the kernel's key tile, which the plain version folds in the same steps
BLOCK_K = 64
HEAD_DIMS = (32, 64, 128)


def _reference_attention(q, k, v, *, causal: bool, scale: float,
                         mask=None, seq_offset: int = 0):
    """Plain softmax(q kᵀ) v over (B, H, Tq, D) x (B, H, Tk, D), f32
    scores, fully masked rows guarded to zeros (JAX :52-83)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(tq, device=q.device)[:, None] + seq_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        scores = scores.masked_fill(~(qpos >= kpos), float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    # a row max of -inf (fully masked row) shifts by 0, so the row is 0
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    unnorm = torch.exp(scores - row_max)
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / denom.clamp_min(1e-30)
    out = torch.matmul(probs, v.float())
    return out.to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward in plain torch: q (BH, Tq, D) against k/v
    (BH, Tk, D), key tiles of ``BLOCK_K`` folded into a running f32
    (m, l, acc).  Returns O in q's dtype and the per-row logsumexp
    (BH, Tq) f32 in scaled-score units.  The arithmetic is the
    kernel's, tile for tile."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    qs = q.float() * scale
    m = torch.full((bh, tq), float("-inf"), device=q.device)
    l = torch.zeros((bh, tq), device=q.device)
    acc = torch.zeros((bh, tq, d), device=q.device)
    qpos = torch.arange(tq, device=q.device)[:, None]
    n_tiles = -(-tk // BLOCK_K)
    if causal:
        n_tiles = min(n_tiles, -(-tq // BLOCK_K))
    for kt in range(n_tiles):
        k0, k1 = kt * BLOCK_K, min((kt + 1) * BLOCK_K, tk)
        ks = k[:, k0:k1].float()
        vs = v[:, k0:k1].float()
        s = torch.matmul(qs, ks.transpose(1, 2))            # (BH, Tq, bk)
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill(~(qpos >= kpos), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        shift = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        p = torch.exp(s - shift[..., None])
        alpha = torch.where(torch.isfinite(m), torch.exp(m - shift),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vs)
        m = m_new
    lc = l.clamp_min(1e-30)
    out = (acc / lc[..., None]).to(q.dtype)
    return out, m + torch.log(lc)


def _check_flash_args(q, k, v, seq_offset):
    if seq_offset != 0:
        raise ValueError("flash_attention takes seq_offset=0 only")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants (B, H, T, D) q, k and v")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k and v differ in dtype")


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, seq_offset: int = 0,
                    with_lse: bool = False):
    """Flash forward over (B, H, Tq, D) q and (B, H, Tk, D) k/v; any Tq
    and Tk.  Returns O, or (O, lse) with lse (B·H, Tq) f32 when
    ``with_lse``.

    A CUDA tensor goes to the ``flash_fwd`` kernel (D in 32/64/128, f32
    or bf16), and anything that kernel does not take raises; a CPU
    tensor goes to :func:`flash_attention_plain`."""
    _check_flash_args(q, k, v, seq_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, tq, d = q.shape
    tk = k.shape[2]
    qr = q.reshape(b * h, tq, d)
    kr = k.reshape(b * h, tk, d)
    vr = v.reshape(b * h, tk, d)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(qr, kr, vr, causal=causal,
                                         scale=scale)
    elif q.device.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"flash_fwd kernel takes D in {HEAD_DIMS}, got {d}")
        if q.dtype not in _cuda.DTYPE_CODES:
            raise ValueError(f"flash_fwd kernel takes f32 or bf16, got {q.dtype}")
        qr, kr, vr = qr.contiguous(), kr.contiguous(), vr.contiguous()
        out = torch.empty_like(qr)
        lse = (torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
               if with_lse else None)
        _cuda.launch_flash_fwd(qr, kr, vr, out, lse, causal=causal,
                               scale=scale)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = out.reshape(b, h, tq, d)
    return (out, lse) if with_lse else out


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          scale: Optional[float] = None, impl: str = "auto",
                          seq_offset: int = 0):
    """Attention entry point used by ``nn.MultiHeadAttention``.

    q, k, v: (batch, heads, seq, head_dim).  impl: "auto" (the JAX
    package's static policy: "reference" on this card), "reference",
    or "kernel" (:func:`flash_attention`)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto":
        impl = "reference"
    if impl == "kernel":
        if mask is not None:
            raise ValueError("the flash kernel has no explicit-mask support;"
                             " use impl='reference'")
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               seq_offset=seq_offset)
    if impl != "reference":
        raise ValueError(f"impl must be auto|reference|kernel, got {impl!r}")
    return _reference_attention(q, k, v, causal=causal, scale=scale,
                                mask=mask, seq_offset=seq_offset)


__all__ = ["dot_product_attention", "flash_attention",
           "flash_attention_plain"]
