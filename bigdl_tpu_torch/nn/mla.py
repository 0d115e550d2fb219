"""The attention block of DeepSeek-V3-style models: RMSNorm, rotary
embedding on a slice of the head in the interleaved layout, the SwiGLU
MLP and multi-head latent attention (MLA).

No JAX counterpart: the JAX package has no such model.  The equations
are those of the published ``deepseek_v3`` modeling code, without query
LoRA (``q_lora_rank`` null) and without YaRN (``rope_scaling`` null):

* ``RMSNorm``: ``w · (x / sqrt(mean(x²) + eps))``, the normalize in f32
  and rounded to x's dtype before the weight;
* MLA over x (B, T, d), H heads: ``q = Wq·x`` split per head into
  ``q_nope`` (``d_nope``) and ``q_pe`` (``d_rope``); ``[c; k_pe] =
  Wkva·x`` with c of ``kv_rank``; ``c ← RMSNorm(c)``; ``[k_nope; v] =
  Wkvb·c`` per head; q_pe and k_pe (one for all heads) turn by RoPE;
  causal softmax over ``[q_nope; q_pe]·[k_nope; k_pe]`` at scale
  ``1/sqrt(d_nope + d_rope)`` against v (``d_v``); ``o = Wo·heads``.
  With ``attn_impl="kernel"`` the attention is ``ops.attention``'s flash
  kernels at (D, Dv) = (192, 128); else ``dot_product_attention``;
* RoPE turns each pair (2i, 2i+1) of the rotary slice by the angle
  ``p · θ^(−2i/d_rope)``.  The published code gathers the pairs into
  halves before it turns them, the same permutation for q and k, which
  leaves every q·k product as it is here.

Parameters are drawn on the module's device from a ``torch.Generator``
(N(0, ``std``) matrices, RMSNorm weights 1), so a model of billions of
parameters builds without a host draw.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import AbstractModule, Composite


def draw(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """An f32 N(0, std) tensor on the generator's device."""
    out = torch.empty(shape, device=generator.device, dtype=torch.float32)
    return out.normal_(0.0, std, generator=generator)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """``weight · x / sqrt(mean(x²) + eps)``: the normalize in f32, then
    rounded to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * y.to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE over the last dim of x (..., T, R), pairs (2i, 2i+1) turned
    by ``t · θ^(−2i/R)`` at position t (0-based along T); in f32, the
    result in x's dtype."""
    t, r = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, r, 2, device=x.device,
                                  dtype=torch.float32) / r)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xp = x.float().unflatten(-1, (r // 2, 2))
    x0, x1 = xp[..., 0], xp[..., 1]
    out = torch.stack((x0 * cos - x1 * sin, x0 * sin + x1 * cos), dim=-1)
    return out.flatten(-2).to(x.dtype)


class Dense(AbstractModule):
    """``y = x Wᵀ``, W (out, in) drawn N(0, std) on the generator's
    device."""

    param_names = ("weight",)

    def __init__(self, n_in: int, n_out: int, std: float,
                 generator: torch.Generator):
        super().__init__()
        self.n_in, self.n_out = n_in, n_out
        self._set_param("weight", draw((n_out, n_in), std, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)


class RMSNorm(AbstractModule):
    """RMSNorm with a learned scale, initialised to 1."""

    param_names = ("weight",)

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.dim, self.eps = dim, eps
        self._set_param("weight", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class SwiGLU(AbstractModule):
    """``down(silu(gate(x)) ⊙ up(x))`` of width ``hidden``: gate and up
    as one (2·hidden, dim) matrix, gate's rows first."""

    param_names = ("w_gate_up", "w_down")

    def __init__(self, dim: int, hidden: int, std: float,
                 generator: torch.Generator):
        super().__init__()
        self.dim, self.hidden = dim, hidden
        self._set_param("w_gate_up", draw((2 * hidden, dim), std, generator))
        self._set_param("w_down", draw((dim, hidden), std, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = F.linear(x, self.w_gate_up).chunk(2, dim=-1)
        return F.linear(F.silu(gate) * up, self.w_down)


class MultiHeadLatentAttention(Composite):
    """MLA without query LoRA (the module docstring): children ``wq``,
    ``wkv_a``, ``kv_norm``, ``wkv_b`` and ``wo``.  Causal; x (B, T, dim)
    to (B, T, dim)."""

    def __init__(self, dim: int, n_head: int, d_nope: int, d_rope: int,
                 d_v: int, kv_rank: int, rope_theta: float,
                 kv_norm_eps: float, std: float,
                 generator: torch.Generator, attn_impl: str = "kernel"):
        super().__init__()
        self.n_head, self.d_nope, self.d_rope = n_head, d_nope, d_rope
        self.d_v, self.kv_rank, self.rope_theta = d_v, kv_rank, rope_theta
        self.attn_impl = attn_impl
        self._add_child("wq", Dense(dim, n_head * (d_nope + d_rope), std,
                                    generator))
        self._add_child("wkv_a", Dense(dim, kv_rank + d_rope, std,
                                       generator))
        self._add_child("kv_norm", RMSNorm(kv_rank, kv_norm_eps,
                                           generator.device))
        self._add_child("wkv_b", Dense(kv_rank, n_head * (d_nope + d_v),
                                       std, generator))
        self._add_child("wo", Dense(n_head * d_v, dim, std, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from bigdl_tpu_torch.ops.attention import (dot_product_attention,
                                                   flash_attention)

        b, t, _ = x.shape
        h, dn, dr, dv = self.n_head, self.d_nope, self.d_rope, self.d_v
        q = self.wq(x).view(b, t, h, dn + dr).transpose(1, 2)
        c, k_pe = self.wkv_a(x).split((self.kv_rank, dr), dim=-1)
        kv = self.wkv_b(self.kv_norm(c)).view(b, t, h, dn + dv) \
            .transpose(1, 2)
        k_nope, v = kv.split((dn, dv), dim=-1)
        q_pe = rope(q[..., dn:], self.rope_theta)
        k_pe = rope(k_pe[:, None], self.rope_theta)
        q = torch.cat((q[..., :dn], q_pe), dim=-1)
        k = torch.cat((k_nope, k_pe.expand(b, h, t, dr)), dim=-1)
        scale = 1.0 / math.sqrt(dn + dr)
        if self.attn_impl == "kernel":
            o = flash_attention(q, k, v.contiguous(), causal=True,
                                scale=scale)
        else:
            o = dot_product_attention(q, k, v, causal=True, scale=scale,
                                      impl=self.attn_impl)
        return self.wo(o.transpose(1, 2).reshape(b, t, h * dv))


__all__ = ["Dense", "RMSNorm", "SwiGLU", "MultiHeadLatentAttention",
           "rms_norm", "rope", "draw"]
