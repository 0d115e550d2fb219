"""Paged flash-decode over the paged KV cache: the serving hot path.

Counterpart of ``bigdl_tpu/ops/decode_attention.py``:

* ``impl="dense"`` (JAX ``_dense``, :103): gather the slot's pages into
  a contiguous copy, masked softmax.  The engine's static default, and
  the path whose op sequence mirrors ``TransformerLM.generate``;
* ``impl="kernel"``: the paged flash-decode (JAX ``_decode_kernel``,
  :205, launched at :288).  On a CUDA tensor it launches the
  hand-written kernel ``csrc/paged_decode.cu``; on a CPU tensor it runs
  ``paged_decode_plain``, the same page-by-page online softmax in
  torch.

Mask contract, shared by every impl: position ``pos <= length``
attends, everything else is -inf before the softmax, so page 0 (the
trash page unallocated table entries point at) never contributes.

The JAX package's lax ``_fused`` impl is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.ops import _cuda

HEAD_DIMS = (32, 64, 128)


def used_page_bucket(max_length: int, page_size: int,
                     max_pages: int) -> int:
    """Host-side pow2 page bucket for one decode step: the smallest
    power of two >= the pages needed to cover position ``max_length``
    (``max_length // P + 1`` pages are live), clamped to the table
    width."""
    page_size = max(1, int(page_size))
    need = max(1, int(max_length) // page_size + 1)
    b = 1
    while b < need:
        b *= 2
    return min(b, max(1, int(max_pages)))


def decode_hbm_bytes(impl: str, b: int, h: int, d: int, page_size: int,
                     maxp: int, kv_itemsize: int = 4) -> float:
    """Analytic device-memory traffic of ONE layer's decode attention
    over ``maxp`` table columns: every impl reads the K/V pages the
    tables name; the dense path also writes and re-reads the gathered
    copy and the f32 score plane."""
    k = maxp * page_size
    pages = 2.0 * b * maxp * page_size * h * d * kv_itemsize  # K + V
    qio = 2.0 * b * h * d * 4                                 # q + out
    if impl == "dense":
        return pages * 3 + 2.0 * b * h * k * 4 + qio
    return pages + qio


def _dense(q, kp, vp, tables, lengths, *, scale: float):
    """Gather + masked softmax (JAX :103-121), in the dtypes the JAX
    path computes in."""
    from bigdl_tpu_torch.serving.cache import gather_pages

    qh = q[:, :, None, :]                      # (B, H, 1, Dh)
    kall = gather_pages(kp, tables)            # (B, H, maxp*P, Dh)
    vall = gather_pages(vp, tables)
    scores = torch.matmul(qh, kall.to(q.dtype).transpose(-1, -2)) * scale
    pos = torch.arange(kall.shape[2], device=q.device)
    mask = pos[None, None, None, :] <= lengths[:, None, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o = torch.matmul(probs, vall.to(probs.dtype))
    return o[:, :, 0, :]


def paged_decode_plain(q, kp, vp, tables, lengths, *, page_size: int,
                       scale: float):
    """The paged flash-decode in plain torch: for each table column j
    the slot's page ``tables[:, j]`` is folded into a running f32
    (m, l, acc) under the mask ``pos <= length``; columns past every
    slot's live pages are skipped, as the kernel skips them.  Output in
    q's dtype."""
    b, h, d = q.shape
    p = int(page_size)
    maxp = tables.shape[1]
    qf = q.float() * scale
    tbl = tables.long()
    m = torch.full((b, h), float("-inf"), device=q.device)
    l = torch.zeros((b, h), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    live = min(maxp, int(lengths.max()) // p + 1) if b else 0
    offs = torch.arange(p, device=q.device)
    for j in range(live):
        ks = kp[tbl[:, j]].float()             # (B, H, P, Dh)
        vs = vp[tbl[:, j]].float()
        s = torch.einsum("bhd,bhpd->bhp", qf, ks)
        pos = j * p + offs
        keep = pos[None, None, :] <= lengths[:, None, None]
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        shift = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        pr = torch.exp(s - shift[..., None])
        alpha = torch.where(torch.isfinite(m), torch.exp(m - shift),
                            torch.zeros_like(m))
        l = l * alpha + pr.sum(dim=-1)
        # a page past this slot's length (the trash page) has p = 0 in
        # every position; skip its values so no garbage is multiplied
        pv = torch.einsum("bhp,bhpd->bhd", pr,
                          torch.where(keep[..., None], vs,
                                      torch.zeros_like(vs)))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _check_decode_args(q, kp, vp, tables, lengths, page_size):
    if q.dim() != 3 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError("paged decode wants q (B, H, Dh) and kp/vp "
                         "(pages, H, P, Dh)")
    b, h, d = q.shape
    if kp.shape[1] != h or kp.shape[2] != page_size or kp.shape[3] != d:
        raise ValueError(f"page pool {tuple(kp.shape)} does not match q "
                         f"{tuple(q.shape)} with page_size {page_size}")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("tables must be (B, maxp) and lengths (B,)")
    devs = {t.device for t in (q, kp, vp, tables, lengths)}
    if len(devs) != 1:
        raise ValueError("paged decode: tensors on different devices")


def paged_decode(q, kp, vp, tables, lengths, *, page_size: int,
                 scale: Optional[float] = None):
    """Paged flash-decode: one query per slot against its pages.

    A CUDA tensor goes to the ``paged_decode`` kernel (Dh in 32/64/128;
    q and the cache each f32 or bf16; int32 tables and lengths), and
    anything that kernel does not take raises; a CPU tensor goes to
    :func:`paged_decode_plain`."""
    _check_decode_args(q, kp, vp, tables, lengths, page_size)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_plain(q, kp, vp, tables, lengths,
                                  page_size=page_size, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"paged_decode kernel takes Dh in {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if q.dtype not in _cuda.DTYPE_CODES or kp.dtype not in _cuda.DTYPE_CODES \
            or vp.dtype != kp.dtype:
        raise ValueError(f"paged_decode kernel takes f32/bf16 q and cache, "
                         f"got {q.dtype}, {kp.dtype}, {vp.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_decode kernel takes int32 tables and lengths")
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError("paged_decode kernel takes contiguous page pools")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("paged_decode kernel takes 16-byte aligned pools")
    q = q.contiguous()
    tables = tables.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    _cuda.launch_paged_decode(q, kp, vp, tables, lengths, out,
                              page_size=page_size, scale=scale)
    return out


def static_decode_dispatch() -> str:
    """The ``impl="auto"`` policy: the dense path, as in JAX :301."""
    return "dense"


def paged_decode_attention(q, kp, vp, tables, lengths, *,
                           page_size: int, scale: Optional[float] = None,
                           impl: str = "auto"):
    """One decode-attention step over the paged KV cache.

    q: ``(B, H, Dh)``; kp/vp: ``(num_pages, H, P, Dh)`` (one layer's
    pool); tables: ``(B, maxp)`` int32 (maxp may be the used-page
    bucket); lengths: ``(B,)`` int32, position ``pos <= length``
    attends.  impl: "auto" (= "dense"), "dense" or "kernel"."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        impl = static_decode_dispatch()
    if impl == "kernel":
        return paged_decode(q, kp, vp, tables, lengths, page_size=page_size,
                            scale=scale)
    if impl != "dense":
        raise ValueError(f"impl must be auto|dense|kernel, got {impl!r}")
    return _dense(q, kp, vp, tables, lengths, scale=scale)


__all__ = ["paged_decode_attention", "paged_decode", "paged_decode_plain",
           "static_decode_dispatch", "used_page_bucket", "decode_hbm_bytes"]
