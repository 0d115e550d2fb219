"""Attention / Transformer layers.

Counterpart of ``bigdl_tpu/nn/attention.py``: ``LayerNorm`` (:39),
``MultiHeadAttention`` (:72), ``TransformerBlock`` (:208) with
``prefill`` (:267) and ``decode_step`` (:282), and
``PositionalEmbedding`` (:316).  Parameters carry the JAX package's
names and are drawn from the same host RNG in the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.nn.layers import Linear, Xavier
from bigdl_tpu_torch.nn.module import AbstractModule, Composite
from bigdl_tpu_torch.ops.attention import dot_product_attention


class LayerNorm(AbstractModule):
    """Layer normalization over the last dimension: statistics in f32,
    eps 1e-5, the result cast back to the input dtype."""

    param_names = ("weight", "bias")

    def __init__(self, n_output: int, eps: float = 1e-5):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self._set_param("weight", np.ones(n_output, np.float32))
        self._set_param("bias", np.zeros(n_output, np.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class MultiHeadAttention(AbstractModule):
    """Multi-head self attention, (batch, seq, dim) -> (batch, seq, dim).
    ``attn_impl`` picks the inner attention (``ops.attention``):
    "auto", "reference" or "kernel"."""

    param_names = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")

    def __init__(self, dim: int, n_head: int, causal: bool = False,
                 with_bias: bool = True, attn_impl: str = "auto"):
        super().__init__()
        if dim % n_head:
            raise ValueError(f"dim {dim} not divisible by n_head {n_head}")
        self.dim = dim
        self.n_head = n_head
        self.head_dim = dim // n_head
        self.causal = causal
        self.with_bias = with_bias
        self.attn_impl = attn_impl
        init = Xavier()
        for name in ("wq", "wk", "wv", "wo"):
            self._set_param(name, init.init((dim, dim), dim, dim))
        for name in ("bq", "bk", "bv", "bo"):
            self._set_param(name, np.zeros(dim, np.float32)
                            if with_bias else None)

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.head_dim).transpose(1, 2)

    def _merge(self, o):
        b, h, t, hd = o.shape
        return o.transpose(1, 2).reshape(b, t, h * hd)

    def _inner_attention(self, q, k, v):
        return dot_product_attention(q, k, v, causal=self.causal,
                                     impl=self.attn_impl)

    def project_qkv(self, h):
        q = torch.matmul(h, self.wq.t())
        k = torch.matmul(h, self.wk.t())
        v = torch.matmul(h, self.wv.t())
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return q, k, v

    def out_proj(self, o):
        y = torch.matmul(o, self.wo.t())
        if self.bo is not None:
            y = y + self.bo
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.project_qkv(x)
        o = self._inner_attention(self._split(q), self._split(k),
                                  self._split(v))
        return self.out_proj(self._merge(o))


class TransformerBlock(Composite):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x)), with
    the tanh-approximated GELU that ``jax.nn.gelu`` defaults to."""

    def __init__(self, dim: int, n_head: int, mlp_ratio: int = 4,
                 causal: bool = True, attn_impl: str = "auto"):
        super().__init__()
        self.dim = dim
        self._add_child("ln1", LayerNorm(dim))
        self._add_child("attn", MultiHeadAttention(
            dim, n_head, causal=causal, attn_impl=attn_impl))
        self._add_child("ln2", LayerNorm(dim))
        self._add_child("fc1", Linear(dim, mlp_ratio * dim))
        self._add_child("fc2", Linear(mlp_ratio * dim, dim))

    def mlp(self, x):
        """The pre-LN MLP half shared by forward, prefill, decode_step
        and the engine's decode step."""
        h = self.fc1(self.ln2(x))
        h = F.gelu(h, approximate="tanh")
        return x + self.fc2(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x + self.attn(self.ln1(x)))

    def prefill(self, x):
        """Full-prefix block forward that also returns the per-head K/V
        (B, H, T, Dh) for a decode cache."""
        attn = self.attn
        q, k, v = attn.project_qkv(self.ln1(x))
        kh, vh = attn._split(k), attn._split(v)
        o = attn._inner_attention(attn._split(q), kh, vh)
        x = x + attn.out_proj(attn._merge(o))
        return self.mlp(x), kh, vh

    def decode_step(self, x, cache_k, cache_v, t: int):
        """One-token decode: ``x`` is (B, 1, dim); the caches are
        (B, H, T_total, Dh).  The new K/V are written into the caches IN
        PLACE at position ``t`` (the JAX package returns updated copies
        via ``dynamic_update_slice``); the query attends over positions
        <= t."""
        attn = self.attn
        q, k, v = attn.project_qkv(self.ln1(x))
        qh = attn._split(q)
        cache_k[:, :, t:t + 1] = attn._split(k).to(cache_k.dtype)
        cache_v[:, :, t:t + 1] = attn._split(v).to(cache_v.dtype)
        scale = 1.0 / math.sqrt(attn.head_dim)
        scores = torch.matmul(
            qh, cache_k.to(qh.dtype).transpose(-1, -2)) * scale
        mask = torch.arange(cache_k.shape[2], device=x.device) <= t
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        o = torch.matmul(probs, cache_v.to(probs.dtype))
        x = x + attn.out_proj(attn._merge(o))
        return self.mlp(x)


class PositionalEmbedding(AbstractModule):
    """Learned absolute positional embedding added to (B, T, D) input."""

    param_names = ("weight",)

    def __init__(self, max_len: int, dim: int):
        super().__init__()
        self.max_len = max_len
        self.dim = dim
        self._set_param("weight", RandomGenerator.RNG.normal(
            0.0, 0.02, size=(max_len, dim)).astype(np.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.weight[:x.shape[1]][None, :, :]


__all__ = ["LayerNorm", "MultiHeadAttention", "TransformerBlock",
           "PositionalEmbedding"]
