"""Plain GPT-2 block stack (Radford et al. 2019; the layer equations of
``openai-community`` GPT-2's ``modeling_gpt2``) in float32 torch.

Token and learned position embeddings; each block x + attn(LN(x)), then
x + MLP(LN(x)) with the tanh GELU; causal softmax attention over all
heads; a final LayerNorm (eps from the configuration) and the output
head.  Departures from GPT-2 that the measured program makes, and this
reference therefore makes too: q, k and v are three projections (the
same mathematics as GPT-2's fused ``c_attn``), and the head is its own
bias-free matrix, not the token embedding (the parameter names are the
program's, so that one dict of weights serves both).  Nothing here
imports the measured program.

``quant="fp8"`` computes every matrix product as float8 training does
(``reference.resnet``: inputs in e4m3, the gradients reaching the outputs
in e5m2): the control below bfloat16.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark import roofline

from benchmark.reference.resnet import fake_fp8, grad_fp8


def weight_specs(cfg: dict) -> List[tuple]:
    """(name, shape, init): matrices and token embeddings N(0, 0.02),
    positions N(0, 0.01), biases 0, LayerNorm γ 1 and β 0 (GPT-2's)."""
    d, v = cfg["n_embd"], cfg["vocab_size"]
    f = cfg["mlp_ratio"] * d
    specs = [("wte.weight", (v, d), ("normal", 0.02)),
             ("wpe.weight", (cfg["n_positions"], d), ("normal", 0.01))]
    for i in range(cfg["n_layer"]):
        p = f"h{i}."
        specs += [(p + "ln1.weight", (d,), ("ones",)),
                  (p + "ln1.bias", (d,), ("zeros",))]
        for m in ("wq", "wk", "wv", "wo"):
            specs.append((p + "attn." + m, (d, d), ("normal", 0.02)))
        for b in ("bq", "bk", "bv", "bo"):
            specs.append((p + "attn." + b, (d,), ("zeros",)))
        specs += [(p + "ln2.weight", (d,), ("ones",)),
                  (p + "ln2.bias", (d,), ("zeros",)),
                  (p + "fc1.weight", (f, d), ("normal", 0.02)),
                  (p + "fc1.bias", (f,), ("zeros",)),
                  (p + "fc2.weight", (d, f), ("normal", 0.02)),
                  (p + "fc2.bias", (d,), ("zeros",))]
    specs += [("ln_f.weight", (d,), ("ones",)), ("ln_f.bias", (d,), ("zeros",)),
              ("head.weight", (v, d), ("normal", 0.02))]
    return specs


def _mm(x, w, b=None, quant=None):
    if quant == "fp8":
        return grad_fp8(F.linear(fake_fp8(x), fake_fp8(w), b))
    return F.linear(x, w, b)


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict,
            quant=None) -> torch.Tensor:
    """Logits (B, T, vocab) of 0-based ids (B, T)."""
    eps, heads = cfg["layer_norm_epsilon"], cfg["n_head"]
    b, t = tokens.shape
    d = cfg["n_embd"]
    x = w["wte.weight"][tokens] + w["wpe.weight"][:t]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["n_layer"]):
        p = f"h{i}."
        h = F.layer_norm(x, (d,), w[p + "ln1.weight"], w[p + "ln1.bias"], eps)
        q, k, v = (_mm(h, w[p + "attn.w" + n], w[p + "attn.b" + n], quant)
                   .view(b, t, heads, d // heads).transpose(1, 2)
                   for n in "qkv")
        if quant == "fp8":
            q, k = fake_fp8(q), fake_fp8(k)
        s = torch.matmul(q, k.transpose(-1, -2)) * (d // heads) ** -0.5
        if quant == "fp8":
            s = grad_fp8(s)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        if quant == "fp8":
            a, v = fake_fp8(a), fake_fp8(v)
        o = torch.matmul(a, v)
        if quant == "fp8":
            o = grad_fp8(o)
        o = o.transpose(1, 2).reshape(b, t, d)
        x = x + _mm(o, w[p + "attn.wo"], w[p + "attn.bo"], quant)
        h = F.layer_norm(x, (d,), w[p + "ln2.weight"], w[p + "ln2.bias"], eps)
        h = F.gelu(_mm(h, w[p + "fc1.weight"], w[p + "fc1.bias"], quant),
                   approximate="tanh")
        x = x + _mm(h, w[p + "fc2.weight"], w[p + "fc2.bias"], quant)
    x = F.layer_norm(x, (d,), w["ln_f.weight"], w["ln_f.bias"], eps)
    return _mm(x, w["head.weight"], None, quant)


def loss_sum(w, tokens, target, cfg, quant=None) -> torch.Tensor:
    """Σ of the next-token cross entropy over every position;
    ``target`` 0-based, (B, T)."""
    logits = forward(w, tokens, cfg, quant)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           target.reshape(-1), reduction="sum")


def model_flops(cfg: dict, mix: dict, record: dict) -> float:
    """A training window's model FLOPs (``roofline.lm_train_flops``)."""
    return roofline.lm_train_flops(cfg["n_embd"], cfg["n_layer"],
                                   cfg["vocab_size"], cfg["mlp_ratio"],
                                   mix["batch"], mix["seq"]) * record["steps"]
