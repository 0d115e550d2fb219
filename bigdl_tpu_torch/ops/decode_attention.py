"""Paged flash-decode over the paged KV cache: the serving hot path.

Counterpart of ``bigdl_tpu/ops/decode_attention.py``:

* ``impl="dense"`` (JAX ``_dense``, :103): gather the slot's pages into
  a contiguous copy, masked softmax.  The engine's static default, and
  the path whose op sequence mirrors ``TransformerLM.generate``;
* ``impl="fused"`` (JAX ``_fused``, :142-202): an online softmax over
  blocks of ``block_pages`` table columns (``_chunk_pages`` :129), each
  block's pages gathered through the table in page layout and folded
  into a carried f32 (m, l, acc).  It is XLA work in the JAX package,
  not a Pallas kernel, so here it is torch ops;
* ``impl="kernel"``: the paged flash-decode (JAX ``_decode_kernel``,
  :205, launched at :288).  On a CUDA tensor it launches the
  hand-written kernel ``csrc/paged_decode.cu``, which splits each
  slot's pages over several CTAs and merges their partial softmax
  states in a fixed order (flash-decoding); on a CPU tensor it runs
  ``paged_decode_plain``, the same page-by-page online softmax in
  torch.

Mask contract, shared by every impl: position ``pos <= length``
attends, everything else is -inf before the softmax, so page 0 (the
trash page unallocated table entries point at) never contributes.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.ops import _cuda

HEAD_DIMS = (32, 64, 128)
# streaming multiprocessors of an H100 SXM: the KV split's default target
H100_SMS = 132


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


def decode_splits(b: int, h: int, maxp: int, sms: int = H100_SMS) -> int:
    """How many CTAs the ``paged_decode`` kernel splits each (slot,
    head)'s KV over: enough for about two CTAs on each of the card's
    ``sms`` multiprocessors, at most one per table column."""
    return max(1, min(int(maxp), -(-2 * int(sms) // max(1, b * h))))


def decode_hbm_bytes(impl: str, b: int, h: int, d: int, page_size: int,
                     maxp: int, kv_itemsize: int = 4) -> float:
    """Analytic device-memory traffic of ONE layer's decode attention
    over ``maxp`` table columns: every impl reads the K/V pages the
    tables name; the dense path also writes and re-reads the gathered
    copy and the f32 score plane; so does the fused path's torch body
    (block by block: it bounds the working set, not the bytes), which
    also widens a cache narrower than f32 to an f32 copy of each block
    (JAX counts its fused as the ideal read, since XLA fuses the
    gather); the kernel also writes and re-reads its splits' f32
    partials (acc, m, l) when it splits the KV."""
    k = maxp * page_size
    n_kv = 2.0 * b * maxp * page_size * h * d                  # K + V
    pages = n_kv * kv_itemsize
    qio = 2.0 * b * h * d * 4                                 # q + out
    if impl in ("dense", "fused"):
        widen = 2.0 * n_kv * 4 if impl == "fused" and kv_itemsize != 4 \
            else 0.0
        return pages * 3 + widen + 2.0 * b * h * k * 4 + qio
    if impl == "kernel":
        splits = decode_splits(b, h, maxp)
        if splits > 1:
            qio += 2.0 * b * h * splits * (d + 2) * 4
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


def _chunk_pages(maxp: int, block_pages: int) -> int:
    """The largest page-block size <= the request that divides the table
    width (0 or an oversize request: the whole width, one block)."""
    maxp = int(maxp)
    bp = int(block_pages)
    if bp <= 0 or bp >= maxp:
        return maxp
    while bp > 1 and maxp % bp:
        bp -= 1
    return bp


def _fused(q, kp, vp, tables, lengths, *, page_size: int, scale: float,
           block_pages: int = 0):
    """Online-softmax paged decode over page blocks (JAX :142-202): each
    block's pages come through the table as (B, bp, H, P, Dh), their
    masked scores fold into the carried (m, l, acc), one rescale at the
    end; f32 accumulation throughout, output in q's dtype."""
    b, maxp = tables.shape
    h, d = q.shape[1], q.shape[2]
    p = int(page_size)
    bp = _chunk_pages(maxp, block_pages)
    qf = q.float() * scale                    # (B, H, Dh)
    tbl = tables.long()
    len_b = lengths[:, None, None, None]      # (B, 1, 1, 1)
    m = torch.full((b, h), float("-inf"), device=q.device)
    l = torch.zeros((b, h), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    offs = torch.arange(p, device=q.device)
    for c0 in range(0, maxp, bp):
        tbl_c = tbl[:, c0:c0 + bp]
        kc = kp[tbl_c].float()                # (B, bp, H, P, Dh)
        vc = vp[tbl_c].float()
        s = torch.einsum("bhd,bmhpd->bhmp", qf, kc)
        pos = ((c0 + torch.arange(bp, device=q.device)) * p)[
            None, None, :, None] + offs[None, None, None, :]
        s = torch.where(pos <= len_b, s, torch.full_like(s, float("-inf")))
        s = s.reshape(b, h, bp * p)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # rows masked so far keep m = -inf; a shift of 0 avoids NaN
        shift = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        pr = torch.exp(s - shift[..., None])
        alpha = torch.exp(torch.where(torch.isfinite(m), m - shift,
                                      torch.full_like(m, float("-inf"))))
        l = l * alpha + pr.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhmp,bmhpd->bhd", pr.reshape(b, h, bp, p), vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


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
    q and the cache each f32 or bf16; int32 tables and lengths), which
    splits each slot's KV over :func:`decode_splits` CTAs, and anything
    that kernel does not take raises; a CPU tensor goes to
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
    b, h, d = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = decode_splits(b, h, tables.shape[1], sms)
    part = (None if splits == 1 else
            torch.empty((b, h, splits, d + 2), dtype=torch.float32,
                        device=q.device))
    _cuda.launch_paged_decode(q, kp, vp, tables, lengths, out, part,
                              page_size=page_size, scale=scale)
    return out


def static_decode_dispatch() -> tuple:
    """The ``impl="auto"`` policy, ``(impl, block_pages)``: the dense
    path, as in JAX :301, and the tuner's static choice."""
    return "dense", 0


def paged_decode_attention(q, kp, vp, tables, lengths, *,
                           page_size: int, scale: Optional[float] = None,
                           impl: str = "auto", block_pages: int = 0):
    """One decode-attention step over the paged KV cache.

    q: ``(B, H, Dh)``; kp/vp: ``(num_pages, H, P, Dh)`` (one layer's
    pool); tables: ``(B, maxp)`` int32 (maxp may be the used-page
    bucket); lengths: ``(B,)`` int32, position ``pos <= length``
    attends.  impl: "auto" ("dense", or with ``BIGDL_TORCH_TUNER=1``
    the cached ``decode_attn`` decision of ``ops/autotune``), "dense",
    "fused" (its page blocks ``block_pages`` wide, 0 = one block) or
    "kernel"."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        impl, block_pages = static_decode_dispatch()
        from bigdl_tpu_torch.ops import autotune

        if autotune.enabled():
            rec = autotune.decide_decode_attn(
                q.shape, int(page_size), int(tables.shape[1]), q.dtype,
                kv_dtype=kp.dtype, arrays=(q, kp, vp, tables, lengths))
            if rec is not None:
                impl = rec.get("impl", impl)
                block_pages = int(rec.get("block_pages") or 0)
    if impl == "kernel":
        return paged_decode(q, kp, vp, tables, lengths, page_size=page_size,
                            scale=scale)
    if impl == "fused":
        return _fused(q, kp, vp, tables, lengths, page_size=page_size,
                      scale=scale, block_pages=block_pages)
    if impl != "dense":
        raise ValueError(
            f"impl must be auto|dense|fused|kernel, got {impl!r}")
    return _dense(q, kp, vp, tables, lengths, scale=scale)


__all__ = ["paged_decode_attention", "paged_decode", "paged_decode_plain",
           "static_decode_dispatch", "used_page_bucket", "decode_hbm_bytes",
           "decode_splits"]
