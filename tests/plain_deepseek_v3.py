"""Plain DeepSeek-V3 in float32 torch, for the port's CPU tests: the
layer equations of the published ``deepseek_v3`` modeling code, written
out with no kernel, cache, batching or checkpointing, and importing
neither package.

A configuration is a dict with the keys of ``benchmark/configs/
moonlight-16b-a3b.json`` (``hidden_size``, ``num_attention_heads``,
``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
``kv_lora_rank``, ``intermediate_size``, ``moe_intermediate_size``,
``router_experts``, ``n_routed_experts`` held from
``first_held_expert``, ``num_experts_per_tok``, ``n_shared_experts``,
``routed_scaling_factor``, ``first_k_dense_replace``,
``num_hidden_layers``, ``vocab_size``, ``rope_theta``, ``rms_norm_eps``,
``kv_norm_eps``); weights a dict under the port's parameter names;
``biases`` {MoE layer index: the selection bias}.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x, theta):
    """Pair (2i, 2i+1) of the last dim turned by t·θ^(−2i/R) at row t."""
    t, r = x.shape[-2], x.shape[-1]
    ang = torch.arange(t, dtype=torch.float32)[:, None] \
        * theta ** (-torch.arange(0, r, 2, dtype=torch.float32) / r)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x0 * torch.cos(ang) - x1 * torch.sin(ang)
    out[..., 1::2] = x0 * torch.sin(ang) + x1 * torch.cos(ang)
    return out


def attention(q, k, v, scale):
    """Causal softmax(q kᵀ·scale) v over (B, H, T, ·)."""
    t = q.shape[-2]
    s = q @ k.transpose(-1, -2) * scale
    mask = torch.ones(t, t, dtype=torch.bool).triu(1)
    return torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1) @ v


def swiglu(x, w_gate_up, w_down):
    """w_gate_up (2F, d) gate rows first, w_down (d, F)."""
    gate, up = (x @ w_gate_up.t()).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ w_down.t()


def mla(x, w, p, cfg):
    b, t, _ = x.shape
    h = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    q = (x @ w[p + "attn.wq.weight"].t()).view(b, t, h, dn + dr) \
        .transpose(1, 2)
    ckv = x @ w[p + "attn.wkv_a.weight"].t()
    c, k_pe = ckv[..., :cfg["kv_lora_rank"]], ckv[..., cfg["kv_lora_rank"]:]
    c = rms(c, w[p + "attn.kv_norm.weight"], cfg["kv_norm_eps"])
    kv = (c @ w[p + "attn.wkv_b.weight"].t()).view(b, t, h, dn + dv) \
        .transpose(1, 2)
    q = torch.cat((q[..., :dn], rope(q[..., dn:], cfg["rope_theta"])), -1)
    k_pe = rope(k_pe[:, None], cfg["rope_theta"]).expand(b, h, t, dr)
    k = torch.cat((kv[..., :dn], k_pe), dim=-1)
    o = attention(q, k, kv[..., dn:], 1.0 / math.sqrt(dn + dr))
    o = o.transpose(1, 2).reshape(b, t, h * dv)
    return o @ w[p + "attn.wo.weight"].t()


def route(xs, w_router, bias, cfg):
    """(idx, gates): top-k of sigmoid(x·W_rᵀ) + b; gates from the
    unbiased scores, normalised over the chosen and scaled."""
    s = torch.sigmoid(xs @ w_router.t())
    idx = torch.topk(s + bias, cfg["num_experts_per_tok"], dim=-1).indices
    g = s.gather(1, idx)
    return idx, g / (g.sum(-1, keepdim=True) + 1e-20) \
        * cfg["routed_scaling_factor"]


def moe(x, w, p, bias, cfg, first=None, count=None, shared=True):
    """The MoE layer on x (B, T, d): the routed experts [first, first +
    count) of the weights' ``n_routed_experts`` (held from
    ``first_held_expert``; default all of them), plus the shared experts
    where ``shared``."""
    b, t, d = x.shape
    xs = x.reshape(b * t, d)
    idx, gates = route(xs, w[p + "mlp.router.weight"], bias, cfg)
    out = torch.zeros_like(xs)
    if shared:
        out = out + swiglu(xs, w[p + "mlp.shared.w_gate_up"],
                           w[p + "mlp.shared.w_down"])
    base = cfg["first_held_expert"]
    first = base if first is None else first
    count = cfg["n_routed_experts"] if count is None else count
    for e in range(first, first + count):
        for j in range(idx.shape[1]):
            sel = idx[:, j] == e
            y = swiglu(xs, w[p + "mlp.experts.w_gate_up"][e - base].t(),
                       w[p + "mlp.experts.w_down"][e - base].t())
            out = out + torch.where(sel[:, None], y * gates[:, j, None], 0.0)
    return out.view(b, t, d)


def forward(w, tokens, cfg, biases):
    """Logits (B, T, vocab) of 0-based ids (B, T)."""
    eps = cfg["rms_norm_eps"]
    x = w["embed.weight"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        p = f"h{i}."
        x = x + mla(rms(x, w[p + "attn_norm.weight"], eps), w, p, cfg)
        hn = rms(x, w[p + "mlp_norm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(hn, w[p + "mlp.w_gate_up"], w[p + "mlp.w_down"])
        else:
            x = x + moe(hn, w, p, biases[i], cfg)
    return rms(x, w["norm.weight"], eps) @ w["head.weight"].t()


def loss(w, tokens, target, cfg, biases):
    """Mean next-token cross entropy; ``target`` 0-based."""
    logits = forward(w, tokens, cfg, biases)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           target.reshape(-1))


def grads(w, tokens, target, cfg, biases):
    """(loss, {name: gradient})."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in w.items()}
    value = loss(leaves, tokens, target, cfg, biases)
    g = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), dict(zip(leaves, g))
