"""Transformer language model: the flagship the serving engine runs.

Counterpart of ``bigdl_tpu/models/transformer.py``: token + learned
positional embeddings, N pre-LN ``TransformerBlock``s, a final
LayerNorm and a bias-free vocab projection.  Tokens are 0-based.
Parameters are drawn on the host from ``RandomGenerator.RNG`` in the
JAX package's order, then moved to ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import RandomGenerator, resolve_device
from bigdl_tpu_torch.nn.attention import (LayerNorm, PositionalEmbedding,
                                          TransformerBlock)
from bigdl_tpu_torch.nn.layers import Linear
from bigdl_tpu_torch.nn.module import AbstractModule, Composite


class TokenEmbedding(AbstractModule):
    """0-based token embedding, N(0, 0.02) init."""

    param_names = ("weight",)

    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim
        self._set_param("weight", RandomGenerator.RNG.normal(
            0.0, 0.02, size=(vocab_size, dim)).astype(np.float32))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.weight[tokens.long()]


class TransformerLM(Composite):
    """Decoder-only causal LM over (batch, seq) int tokens -> logits
    (batch, seq, vocab).  ``attn_impl`` is the prefill/forward
    attention: "auto", "reference" or "kernel" (``ops.attention``)."""

    def __init__(self, vocab_size: int, dim: int = 256, n_head: int = 4,
                 n_layer: int = 4, max_len: int = 1024, mlp_ratio: int = 4,
                 attn_impl: str = "auto", device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.dim = dim
        self.n_head = n_head
        self.n_layer = n_layer
        self.max_len = max_len
        self._add_child("wte", TokenEmbedding(vocab_size, dim))
        self._add_child("wpe", PositionalEmbedding(max_len, dim))
        for i in range(n_layer):
            self._add_child(f"h{i}", TransformerBlock(
                dim, n_head, mlp_ratio=mlp_ratio, causal=True,
                attn_impl=attn_impl))
        self._add_child("ln_f", LayerNorm(dim))
        self._add_child("head", Linear(dim, vocab_size, with_bias=False))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def blocks(self):
        return [self.child(f"h{i}") for i in range(self.n_layer)]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.wpe(self.wte(tokens))
        for block in self.blocks():
            x = block(x)
        return self.head(self.ln_f(x))

    def _sample(self, logits, temperature: float, generator):
        if temperature > 0.0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0] \
                .to(torch.int32)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 cache_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Autoregressive decoding with a contiguous KV cache.

        The prompt runs one batched prefill (``TransformerBlock.prefill``,
        the attention path the forward takes), then one token at a time
        goes through ``TransformerBlock.decode_step`` over per-layer
        (B, H, T_total, Dh) caches written in place.  ``temperature=0``
        is greedy argmax (the first maximal index); ``> 0`` samples and
        needs ``generator``.  Returns (B, prompt_len + max_new_tokens)
        int32 token ids on the model's device."""
        dev = self.device
        prompt = torch.as_tensor(np.asarray(prompt), device=dev).to(
            torch.int32)
        bsz, t0 = prompt.shape
        total = t0 + max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt {t0} + {max_new_tokens} new tokens exceeds "
                f"max_len {self.max_len}")
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        if max_new_tokens <= 0:
            return prompt
        head_dim = self.dim // self.n_head
        if cache_dtype is None:
            cache_dtype = self.wte.weight.dtype

        x = self.wpe(self.wte(prompt))
        caches = []
        for block in self.blocks():
            x, kh, vh = block.prefill(x)
            ck = torch.zeros((bsz, self.n_head, total, head_dim),
                             dtype=cache_dtype, device=dev)
            cv = torch.zeros_like(ck)
            ck[:, :, :t0] = kh.to(cache_dtype)
            cv[:, :, :t0] = vh.to(cache_dtype)
            caches.append((ck, cv))
        logits = self.head(self.ln_f(x[:, -1:, :]))
        tokens = torch.zeros((bsz, total), dtype=torch.int32, device=dev)
        tokens[:, :t0] = prompt
        tokens[:, t0] = self._sample(logits[:, 0, :], temperature, generator)

        for t in range(t0, total - 1):
            x = self.wte(tokens[:, t:t + 1]) + self.wpe.weight[t][None, None]
            for block, (ck, cv) in zip(self.blocks(), caches):
                x = block.decode_step(x, ck, cv, t)
            logits = self.head(self.ln_f(x))
            tokens[:, t + 1] = self._sample(logits[:, 0, :], temperature,
                                            generator)
        return tokens

    def extra_repr(self):
        return (f"vocab={self.vocab_size}, dim={self.dim}, "
                f"layers={self.n_layer}")


def build_transformer_lm(vocab_size: int, **kw) -> TransformerLM:
    return TransformerLM(vocab_size, **kw)


__all__ = ["TokenEmbedding", "TransformerLM", "build_transformer_lm"]
