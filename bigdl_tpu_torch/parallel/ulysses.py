"""Ulysses sequence parallelism: all-to-all attention.

Counterpart of ``bigdl_tpu/parallel/ulysses.py``.  Activations stay
sequence-sharded, each rank with a ``(B, H, T/n, D)`` block; at the
attention one ``all_to_all`` (``parallel/wire.all_to_all``, split on
heads, concatenated on the sequence) reshards them to ``(B, H/n, T, D)``,
so every rank sees the whole sequence for its heads and the ordinary
``dot_product_attention(impl="auto")`` runs on it: the static policy or
the auto-tuner picks the reference path or the flash kernels.  A second
all_to_all reshards the output back.  Heads must divide by the group's
size.  Both all_to_alls are differentiable, so the backward takes the
same two exchanges the other way.

As in :mod:`~bigdl_tpu_torch.parallel.ring`, the ``*_sharded`` form
takes each rank's LOCAL block where the JAX package takes GSPMD-sharded
global arrays.
"""

from __future__ import annotations

import math
from typing import Optional

from bigdl_tpu_torch.nn.attention import MultiHeadAttention


def _group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group) if dist.is_initialized() else 1


def ulysses_attention(q, k, v, group=None, *, causal: bool = False,
                      scale: Optional[float] = None):
    """All-to-all attention over ``group`` (None = the world, or one
    rank when no process group exists; JAX :30-59).  q, k, v are this
    rank's LOCAL (B, H, T/n, D) blocks in ring order; the result is this
    rank's block of the output."""
    from bigdl_tpu_torch.ops.attention import dot_product_attention
    from bigdl_tpu_torch.parallel import wire as W

    n = _group_size(group)
    h = q.shape[1]
    if h % n:
        raise ValueError(
            f"ulysses_attention: {h} heads not divisible by axis size {n}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])

    def to_heads(x):  # (B, H, T/n, D) -> (B, H/n, T, D)
        return W.all_to_all(x, group, n, None, split_axis=1, concat_axis=2)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    # the whole sequence is here: the ordinary op, its causal mask at
    # offset 0, and "auto" = the static policy or the tuner's decision
    out = dot_product_attention(qh, kh, vh, causal=causal, scale=scale)
    return W.all_to_all(out, group, n, None, split_axis=2, concat_axis=1)


def ulysses_attention_sharded(q, k, v, mesh, *, seq_axis: str = "seq",
                              batch_axis: Optional[str] = None,
                              causal: bool = False,
                              scale: Optional[float] = None):
    """Ulysses attention over ``mesh``'s ``seq_axis`` (JAX :62-78): q, k
    and v are this rank's LOCAL block of the sequence (and, with
    ``batch_axis``, of the batch, which needs no exchange)."""
    return ulysses_attention(q, k, v, mesh.group(seq_axis), causal=causal,
                             scale=scale)


class UlyssesMultiHeadAttention(MultiHeadAttention):
    """``MultiHeadAttention`` whose inner attention reshards sequence to
    heads by all_to_all (JAX :81-106), the alternative to
    ``RingMultiHeadAttention`` when ``n_head >= mesh[seq_axis]``.  Its
    input is the rank's (B, T/n, dim) block."""

    def __init__(self, dim: int, n_head: int, mesh, *,
                 seq_axis: str = "seq", batch_axis: Optional[str] = None,
                 causal: bool = False, with_bias: bool = True,
                 dropout: float = 0.0):
        super().__init__(dim, n_head, causal=causal, with_bias=with_bias,
                         dropout=dropout)
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis

    def _inner_attention(self, q, k, v):
        return ulysses_attention_sharded(
            q, k, v, self.mesh, seq_axis=self.seq_axis,
            batch_axis=self.batch_axis, causal=self.causal)

    def __repr__(self):
        return (f"UlyssesMultiHeadAttention(dim={self.dim}, "
                f"heads={self.n_head}, seq_axis={self.seq_axis!r}, "
                f"causal={self.causal})")


__all__ = ["ulysses_attention", "ulysses_attention_sharded",
           "UlyssesMultiHeadAttention"]
