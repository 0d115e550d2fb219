"""A DeepSeek-V3-style language model: multi-head latent attention and a
dropless, sigmoid-routed MoE with shared experts (Moonlight-16B-A3B,
DeepSeek-V3 and their kin, ``model_type`` ``deepseek_v3``).

No JAX counterpart.  The layer equations are the published modeling
code's (``nn/mla.py``, ``parallel/moe.py`` ``SigmoidMoE``):

    h = x + MLA(RMSNorm(x));  y = h + F(RMSNorm(h))

F is a SwiGLU of width ``dense_hidden`` in the first ``n_dense`` layers
and the MoE in the rest; token embedding, a final RMSNorm and an untied
head.  Tokens are 0-based.  The model holds experts [first_expert,
first_expert + held_experts) of each MoE layer and routes over all
``n_experts``: one rank's share of an expert-parallel deployment, run
without its exchange.  The selection biases are buffers (``router.bias``
of each MoE layer), zero until set; ``moe_stats`` (``MoEStats``) sums
the held experts' loads by MoE layer while a profiler or the obs tracer
records.

Every parameter is drawn on ``device`` from a ``torch.Generator``
seeded with ``seed`` (matrices and the embedding N(0, ``std``), norms
1), so building billions of parameters takes no host draw.  It trains
through ``LocalOptimizer`` like the other models: no dropout (so no
``rng_seed``), bf16 casts of every parameter but the routers' f32
weights.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.nn.mla import (Dense, MultiHeadLatentAttention, RMSNorm,
                                    SwiGLU, draw)
from bigdl_tpu_torch.nn.module import AbstractModule, Composite
from bigdl_tpu_torch.parallel.moe import MoEStats, SigmoidMoE


class Embedding(AbstractModule):
    """0-based token embedding, (vocab, dim)."""

    param_names = ("weight",)

    def __init__(self, vocab_size: int, dim: int, std: float,
                 generator: torch.Generator):
        super().__init__()
        self._set_param("weight", draw((vocab_size, dim), std, generator))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.weight[tokens.long()]


class DecoderLayer(Composite):
    """Pre-norm MLA, then a pre-norm SwiGLU or MoE, each added back."""

    def __init__(self, attn: MultiHeadLatentAttention, mlp, dim: int,
                 eps: float, device):
        super().__init__()
        self._add_child("attn_norm", RMSNorm(dim, eps, device))
        self._add_child("attn", attn)
        self._add_child("mlp_norm", RMSNorm(dim, eps, device))
        self._add_child("mlp", mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x + self.attn(self.attn_norm(x))
        return h + self.mlp(self.mlp_norm(h))


class DeepseekV3LM(Composite):
    """(batch, seq) 0-based ids -> logits (batch, seq, vocab_size)."""

    def __init__(self, vocab_size: int, dim: int, n_layer: int,
                 n_dense: int, n_head: int, d_nope: int, d_rope: int,
                 d_v: int, kv_rank: int, dense_hidden: int, moe_hidden: int,
                 n_experts: int, top_k: int, n_shared: int, scaling: float,
                 first_expert: int, held_experts: int, rope_theta: float,
                 norm_eps: float, kv_norm_eps: float, std: float = 0.02,
                 attn_impl: str = "kernel", seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.vocab_size, self.dim, self.n_layer = vocab_size, dim, n_layer
        self.moe_stats = MoEStats(n_layer - n_dense, held_experts, dev)
        self._add_child("embed", Embedding(vocab_size, dim, std, gen))
        for i in range(n_layer):
            attn = MultiHeadLatentAttention(
                dim, n_head, d_nope, d_rope, d_v, kv_rank, rope_theta,
                kv_norm_eps, std, gen, attn_impl=attn_impl)
            if i < n_dense:
                mlp = SwiGLU(dim, dense_hidden, std, gen)
            else:
                mlp = SigmoidMoE(dim, moe_hidden, n_experts, top_k, n_shared,
                                 scaling, first_expert, held_experts, std,
                                 gen, stats=self.moe_stats,
                                 layer=i - n_dense)
            self._add_child(f"h{i}", DecoderLayer(attn, mlp, dim, norm_eps,
                                                  dev))
        self._add_child("norm", RMSNorm(dim, norm_eps, dev))
        self._add_child("head", Dense(dim, vocab_size, std, gen))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        for i in range(self.n_layer):
            x = self.child(f"h{i}")(x)
        return self.head(self.norm(x))


__all__ = ["DeepseekV3LM", "DecoderLayer", "Embedding"]
