"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM and
the operations and bytes of each hand-written kernel and of each model.

A kernel's bound is the least time the chip could take for a launch:
the larger of its bytes over the HBM bandwidth and its operations over
the peak rate of its input type.  Each input byte is counted read once
and each output byte written once, whatever the kernel reads again; where
the work depends on the data (a causal mask, the live length of a KV
cache), what these inputs need is counted, not the most they could.
The formulas of rows 1-6 follow the port's kernel table (``PERF.md``).
"""

from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_POWER_W = 700.0


def bound_s(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def taps(size: int, k: int, stride: int, pad: int, out: int) -> int:
    """How many of ``size`` input rows the ``out`` outputs of a k-tap,
    strided, padded window read (a strided 1x1 conv reads every
    stride-th)."""
    return len({i * stride - pad + d for i in range(out) for d in range(k)}
               & set(range(size)))


def conv_bn(n: int, c: int, h: int, w: int, o: int, k: int, stride: int,
            itemsize: int) -> Tuple[float, float]:
    """Rows 4-5 (``conv_bn_1x1``, ``conv_bn_kxk``): a bias-free k x k
    conv, padding (k-1)//2, with the BN sums in its epilogue.  x read
    once (the taps it reaches), w read, y written, the f32 shift read
    and the two f32 sums written.  Returns (bytes, FLOPs)."""
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    x_read = n * c * taps(h, k, stride, pad, ho) * taps(w, k, stride, pad,
                                                        wo)
    nbytes = (x_read + o * c * k * k + n * o * ho * wo) * itemsize + 3 * o * 4
    return float(nbytes), float(2 * n * o * c * k * k * ho * wo)


def causal_pairs(t: int) -> float:
    """(query, key) pairs a causal mask keeps in a T x T attention."""
    return t * (t + 1) / 2


def flash_fwd(bh: int, t: int, d: int, itemsize: int) -> Tuple[float, float]:
    """Row 1, causal: q, k, v read, o written, the f32 lse written;
    4·D FLOPs a kept pair."""
    return (4.0 * bh * t * d * itemsize + bh * t * 4,
            4.0 * d * bh * causal_pairs(t))


def flash_bwd_dq(bh: int, t: int, d: int,
                 itemsize: int) -> Tuple[float, float]:
    """Row 2, causal: q, g, k, v read, dq written, lse and δ read;
    6·D FLOPs a kept pair."""
    return (5.0 * bh * t * d * itemsize + 2 * bh * t * 4,
            6.0 * d * bh * causal_pairs(t))


def flash_bwd_dkv(bh: int, t: int, d: int,
                  itemsize: int) -> Tuple[float, float]:
    """Row 3, causal: q, g, k, v read, dk and dv written, lse and δ
    read; 8·D FLOPs a kept pair."""
    return (6.0 * bh * t * d * itemsize + 2 * bh * t * 4,
            8.0 * d * bh * causal_pairs(t))


def paged_decode(b: int, h: int, d: int, positions: int, pages: int,
                 q_itemsize: int, kv_itemsize: int) -> Tuple[float, float]:
    """Row 6, one layer of one decode step over ``b`` slots: q read and
    the output written; the K and V rows of the live positions
    (``positions`` = Σ over the slots of length + 1, the new row
    included); the live table entries and the lengths.  4·H·D FLOPs a
    position."""
    nbytes = (2.0 * b * h * d * q_itemsize
              + 2.0 * positions * h * d * kv_itemsize
              + pages * 4 + b * 4)
    return nbytes, 4.0 * h * d * positions


def conv_flops(sites: Iterable[tuple]) -> float:
    """Forward FLOPs of convolutions given as (c, o, k, ho, wo) a
    sample."""
    return float(sum(2 * c * o * k * k * ho * wo for c, o, k, ho, wo in sites))


def lm_matrix_params(dim: int, n_layer: int, vocab: int,
                     mlp_ratio: int) -> int:
    """Parameters in the matrix products of a GPT-2 block stack and its
    head: q, k, v, o and the two MLP matrices a layer, then the head
    (embedding lookups and biases are not products)."""
    return n_layer * (4 + 2 * mlp_ratio) * dim * dim + dim * vocab


def lm_train_flops(dim: int, n_layer: int, vocab: int, mlp_ratio: int,
                   batch: int, seq: int) -> float:
    """One training step: 6 FLOPs a matrix parameter a token, plus causal
    attention at 6·T²·d a layer and a sequence (forward 2·T²·d, backward
    twice that)."""
    tokens = batch * seq
    return (6.0 * lm_matrix_params(dim, n_layer, vocab, mlp_ratio) * tokens
            + 6.0 * seq * seq * dim * n_layer * batch)


def lm_serve_flops(dim: int, n_layer: int, vocab: int, mlp_ratio: int,
                   prefill_lengths: Iterable[int], decoded: int,
                   context_sum: float) -> float:
    """Served work, 2 FLOPs a multiply-add: a prefill of T tokens runs
    the blocks' matrices over T tokens, the head over its last one, and
    causal attention at 2·T²·d a layer; a decoded token runs every
    matrix once and attends its context L (itself included) at 4·L·d a
    layer.  ``context_sum`` is Σ L over the ``decoded`` tokens."""
    blocks = n_layer * (4 + 2 * mlp_ratio) * dim * dim
    head = dim * vocab
    pre = sum(2.0 * (blocks * t + head) + 2.0 * t * t * dim * n_layer
              for t in prefill_lengths)
    return (pre + 2.0 * (blocks + head) * decoded
            + 4.0 * dim * n_layer * context_sum)
