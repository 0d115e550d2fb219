"""Ring attention: exact attention with the sequence axis sharded.

Counterpart of ``bigdl_tpu/parallel/ring.py``.  Each rank of a
``torch.distributed`` group holds a ``(B, H, T/n, D)`` block of Q, K
and V, in ring order (rank i holds positions ``[i·T/n, (i+1)·T/n)``).
K and V rotate round the ring through ``parallel/wire.ppermute`` (rank
j sends to j + 1; n - 1 hops, the last skipped), and a flash-style
online softmax (running row max ``m``, normalizer ``l``, unnormalized
accumulator ``acc``, all f32) merges the partial result of each block,
so the attention is exact while no rank holds the (T, T) scores or the
whole K/V.  As in the JAX package the block math is plain tensor work
(``_block_partials``, ``_combine``), not a kernel.

Where the JAX package takes GLOBAL arrays that GSPMD shards over a mesh
axis, the port's ``*_sharded`` forms take each rank's LOCAL block: a
rank runs the same call with its own slice, and the result is its slice
of the output.  Gradients flow back through the wire's differentiable
``ppermute``: each rank's backward returns the gradient of the loss of
every rank with respect to its own inputs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.attention import MultiHeadAttention


def _block_partials(q, k, v, scale, causal, q_off, k_off):
    """Partial attention of a q block against one k/v block: (m, l,
    acc), row max (B, H, Tq), normalizer (B, H, Tq) and accumulator
    (B, H, Tq, D), relative to the shift ``where(isfinite(m), m, 0)``
    (JAX :27-54)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(tq, device=q.device)[:, None] + q_off
        kpos = torch.arange(tk, device=q.device)[None, :] + k_off
        scores = scores.masked_fill(~(qpos >= kpos), float("-inf"))
    m = scores.amax(dim=-1)
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - shift[..., None])
    l = p.sum(dim=-1)
    acc = torch.matmul(p, v.float())
    return m, l, acc


def _combine(m, l, acc, mi, li, acci):
    """Merge two partials into one, the same invariant (JAX :57-67).  A
    row wholly masked so far (m = -inf) weighs 0, never NaN."""
    ninf = torch.full_like(m, float("-inf"))
    m_new = torch.maximum(m, mi)
    shift = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m))
    alpha = torch.exp(torch.where(torch.isfinite(m), m, ninf) - shift)
    beta = torch.exp(torch.where(torch.isfinite(mi), mi, ninf) - shift)
    l_new = l * alpha + li * beta
    acc_new = acc * alpha[..., None] + acci * beta[..., None]
    return m_new, l_new, acc_new


def ring_attention(q, k, v, group=None, *, causal: bool = False,
                   scale: Optional[float] = None, wire=None):
    """Exact ring attention over ``group`` (a ``torch.distributed``
    group, None = the world; JAX :70-114, its shard_map body).  q, k, v
    are this rank's LOCAL (B, H, T/n, D) blocks in ring order; the
    result is this rank's block of the output, in q's dtype.

    ``wire`` (a ``parallel/wire.WireSpec`` or dtype string) compresses
    the K/V rotation: each hop ships the blockwise-quantized payload
    and its scales, dequantized on arrival and requantized for the next
    hop; the attention itself stays f32."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import wire as W

    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    spec = W.resolve(wire)
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    t_loc = q.shape[2]
    q_off = idx * t_loc

    b, h, _, d = q.shape
    m = torch.full((b, h, t_loc), float("-inf"), device=q.device)
    l = torch.zeros((b, h, t_loc), device=q.device)
    acc = torch.zeros((b, h, t_loc, d), device=q.device)

    ks, vs = k, v
    perm = [(j, (j + 1) % n) for j in range(n)]
    for s in range(n):
        # after s rotations this rank holds the block that started on
        # rank (idx - s) % n
        k_off = ((idx - s) % n) * t_loc
        mi, li, acci = _block_partials(q, ks, vs, scale, causal, q_off, k_off)
        m, l, acc = _combine(m, l, acc, mi, li, acci)
        if s != n - 1:  # the last hop would complete a wasted circle
            ks = W.ppermute(ks, group, perm, spec)
            vs = W.ppermute(vs, group, perm, spec)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _record_ring_bytes(k, v, n: int, wspec) -> None:
    """The K/V rotation's wire bytes (JAX :133-162): each local block
    rides n - 1 hops, at full width, as bf16, or as the quantized
    payload and its f32 per-block scales."""
    from bigdl_tpu_torch.obs import collectives as C
    from bigdl_tpu_torch.parallel import wire as W

    hops = n - 1
    baseline = (C.ppermute_bytes(k.numel(), k.dtype, hops=hops)
                + C.ppermute_bytes(v.numel(), v.dtype, hops=hops))
    if wspec is None:
        C.record("ppermute", k.dtype, baseline, axis_size=n)
    elif not wspec.scaled:
        moved = (C.ppermute_bytes(k.numel(), "bfloat16", hops=hops)
                 + C.ppermute_bytes(v.numel(), "bfloat16", hops=hops))
        C.record("ppermute", wspec.wire_name, moved, axis_size=n)
        C.record_savings("ring", baseline, moved)
    else:
        padded = W.padded_elems(k.numel(), wspec, 1)
        payload = 2 * C.ppermute_bytes(padded, wspec.wire_name, hops=hops)
        scales = 2 * C.ppermute_bytes(padded // wspec.block, "float32",
                                      hops=hops)
        C.record("ppermute", wspec.wire_name, payload, axis_size=n)
        C.record("ppermute", "float32", scales, axis_size=n)
        C.record_savings("ring", baseline, payload + scales)


def ring_attention_sharded(q, k, v, mesh, *, seq_axis: str = "seq",
                           batch_axis: Optional[str] = None,
                           causal: bool = False,
                           scale: Optional[float] = None, wire=None):
    """Ring attention over ``mesh``'s ``seq_axis`` (JAX :117-170).

    ``mesh`` is ``Engine.build_mesh``'s :class:`~bigdl_tpu_torch.engine.
    Mesh`.  Where JAX takes GLOBAL (B, H, T, D) arrays sharded by GSPMD,
    q, k and v here are this rank's LOCAL block: positions
    ``[i·T/n, (i+1)·T/n)`` for its coordinate i on ``seq_axis``, and,
    with ``batch_axis``, its own slice of the batch (attention is
    independent across the batch, so that axis needs no exchange).  The
    result is this rank's block of the output.  Records the rotation's
    collective bytes (``obs/collectives``) as JAX does."""
    from bigdl_tpu_torch.parallel import wire as W

    wspec = W.resolve(wire)
    n = int(mesh.shape[seq_axis])
    if n > 1:
        _record_ring_bytes(k, v, n, wspec)
    return ring_attention(q, k, v, mesh.group(seq_axis), causal=causal,
                          scale=scale, wire=wspec)


class RingMultiHeadAttention(MultiHeadAttention):
    """``MultiHeadAttention`` whose inner attention is ring attention
    over a mesh's sequence axis (JAX :173-203).  The projections stay
    ordinary matmuls on the rank's block of the sequence; only
    softmax(QKᵀ)V crosses ranks.  Its input is the rank's (B, T/n, dim)
    block."""

    def __init__(self, dim: int, n_head: int, mesh, *,
                 seq_axis: str = "seq", batch_axis: Optional[str] = None,
                 causal: bool = False, with_bias: bool = True,
                 dropout: float = 0.0, wire=None):
        super().__init__(dim, n_head, causal=causal, with_bias=with_bias,
                         dropout=dropout)
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis
        self.wire = wire

    def _inner_attention(self, q, k, v):
        return ring_attention_sharded(
            q, k, v, self.mesh, seq_axis=self.seq_axis,
            batch_axis=self.batch_axis, causal=self.causal, wire=self.wire)

    def __repr__(self):
        return (f"RingMultiHeadAttention(dim={self.dim}, heads={self.n_head},"
                f" seq_axis={self.seq_axis!r}, causal={self.causal})")


__all__ = ["ring_attention", "ring_attention_sharded",
           "RingMultiHeadAttention"]
