"""Plain DeepSeek-V3 block stack (the layer equations of the published
``deepseek_v3`` modeling code, ``model_type`` of Moonlight-16B-A3B) in
float32 torch, on one expert-parallel rank's share.

Token embedding; each layer x + MLA(RMSNorm(x)), then h + F(RMSNorm(h))
with F a SwiGLU in the first ``first_k_dense_replace`` layers and the
MoE after; a final RMSNorm and an untied head.

* MLA, no query LoRA: q = Wq·x split per head into q_nope and q_pe;
  [c; k_pe] = Wkva·x; c ← RMSNorm(c) (eps ``kv_norm_eps``); [k_nope; v]
  = Wkvb·c; q_pe and the one k_pe turn by RoPE, pair (2i, 2i+1) by
  p·θ^(−2i/d_rope) (the published code gathers the pairs into halves
  first, for q and k alike: the same q·k); causal softmax of
  [q_nope; q_pe]·[k_nope; k_pe] / sqrt(d_nope + d_rope), against v.
* MoE: s = sigmoid(x·W_rᵀ) over all ``router_experts``; the top
  ``num_experts_per_tok`` of s + b (b from :func:`router_biases`,
  selection only); w = ``routed_scaling_factor`` · s / Σ s over the
  chosen; y = Σ over the chosen experts held here (``first_held_expert``
  on, ``n_routed_experts`` of them) of w·E(x), plus the shared SwiGLU of
  width ``n_shared_experts`` · ``moe_intermediate_size``.  No capacity.

Computed layer by layer under ``torch.utils.checkpoint`` and attention
in query blocks, so that three f32 Adam steps at 8K tokens fit beside
the optimizer's state; each routed expert takes its tokens by index.
The parameter names are the program's, so one dict of weights serves
both.  Nothing here imports the measured program.

``quant="fp8"`` is the control below bfloat16: every product the
program runs in bfloat16 as float8 training does (``reference.resnet``:
inputs in e4m3, the gradients reaching the outputs in e5m2), and the
router as the program runs it one precision down: its weight and product
in f32, its input x in the compute precision (the program's bf16, here
e4m3, the gradient back to x in e5m2).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.resnet import fake_fp8, grad_fp8

# query rows an attention block takes at a time
QUERY_BLOCK = 1024


def router_biases(cfg: dict, device) -> Dict[int, torch.Tensor]:
    """{MoE layer index: b (router_experts,)}: N(0, router_bias_std) from
    a generator seeded with ``router_bias_seed``, drawn in layer order on
    ``device``; the program's buffers are set to the same."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["router_bias_seed"]))
    out = {}
    for i in range(cfg["first_k_dense_replace"], cfg["num_hidden_layers"]):
        out[i] = torch.randn(cfg["router_experts"], generator=gen,
                             device=device) * cfg["router_bias_std"]
    return out


def weight_specs(cfg: dict) -> List[tuple]:
    """(name, shape, init): matrices, experts and the embedding
    N(0, initializer_range), RMSNorm weights 1."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, f = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    std = ("normal", cfg["initializer_range"])
    specs = [("embed.weight", (v, d), std)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"h{i}."
        specs += [(p + "attn_norm.weight", (d,), ("ones",)),
                  (p + "attn.wq.weight", (h * (dn + dr), d), std),
                  (p + "attn.wkv_a.weight", (r + dr, d), std),
                  (p + "attn.kv_norm.weight", (r,), ("ones",)),
                  (p + "attn.wkv_b.weight", (h * (dn + dv), r), std),
                  (p + "attn.wo.weight", (d, h * dv), std),
                  (p + "mlp_norm.weight", (d,), ("ones",))]
        if i < cfg["first_k_dense_replace"]:
            fd = cfg["intermediate_size"]
            specs += [(p + "mlp.w_gate_up", (2 * fd, d), std),
                      (p + "mlp.w_down", (d, fd), std)]
            continue
        g, fs = cfg["n_routed_experts"], cfg["n_shared_experts"] * f
        specs += [(p + "mlp.router.weight", (cfg["router_experts"], d), std),
                  (p + "mlp.experts.w_gate_up", (g, d, 2 * f), std),
                  (p + "mlp.experts.w_down", (g, f, d), std),
                  (p + "mlp.shared.w_gate_up", (2 * fs, d), std),
                  (p + "mlp.shared.w_down", (d, fs), std)]
    specs += [("norm.weight", (d,), ("ones",)),
              ("head.weight", (v, d), std)]
    return specs


def _mm(x, w, quant=None):
    """x·Wᵀ, W (out, in)."""
    if quant == "fp8":
        return grad_fp8(F.linear(fake_fp8(x), fake_fp8(w)))
    return F.linear(x, w)


def _bmm(a, b, quant=None):
    if quant == "fp8":
        return grad_fp8(torch.matmul(fake_fp8(a), fake_fp8(b)))
    return torch.matmul(a, b)


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rope(x, theta):
    t, r = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, r, 2, device=x.device,
                                  dtype=torch.float32) / r)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.stack((x0 * cos - x1 * sin, x0 * sin + x1 * cos),
                       dim=-1).flatten(-2)


def _swiglu(x, w_gate_up, w_down, quant):
    gate, up = _mm(x, w_gate_up, quant).chunk(2, dim=-1)
    return _mm(F.silu(gate) * up, w_down, quant)


def _attend_block(q, k, v, q0, scale, quant):
    """Causal softmax(q kᵀ·scale) v for query rows [q0, q0 + Tb) against
    keys [0, q0 + Tb)."""
    tb = q.shape[-2]
    kk, vv = k[..., :q0 + tb, :], v[..., :q0 + tb, :]
    s = _bmm(q, kk.transpose(-1, -2), quant) * scale
    qpos = torch.arange(q0, q0 + tb, device=q.device)[:, None]
    kpos = torch.arange(q0 + tb, device=q.device)[None, :]
    a = torch.softmax(s.masked_fill(kpos > qpos, float("-inf")), dim=-1)
    return _bmm(a, vv, quant)


def _mla(x, w, p, cfg, quant):
    b, t, _ = x.shape
    h = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    q = _mm(x, w[p + "attn.wq.weight"], quant).view(b, t, h, dn + dr) \
        .transpose(1, 2)
    c, k_pe = _mm(x, w[p + "attn.wkv_a.weight"], quant).split(
        (cfg["kv_lora_rank"], dr), dim=-1)
    c = _rms(c, w[p + "attn.kv_norm.weight"], cfg["kv_norm_eps"])
    kv = _mm(c, w[p + "attn.wkv_b.weight"], quant).view(b, t, h, dn + dv) \
        .transpose(1, 2)
    k_nope, v = kv.split((dn, dv), dim=-1)
    theta = cfg["rope_theta"]
    q = torch.cat((q[..., :dn], _rope(q[..., dn:], theta)), dim=-1)
    k_pe = _rope(k_pe[:, None], theta).expand(b, h, t, dr)
    k = torch.cat((k_nope, k_pe), dim=-1)
    scale = 1.0 / math.sqrt(dn + dr)
    outs = []
    for q0 in range(0, t, QUERY_BLOCK):
        qb = q[..., q0:q0 + QUERY_BLOCK, :]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_block, qb, k, v, q0, scale,
                                   quant, use_reentrant=False))
        else:
            outs.append(_attend_block(qb, k, v, q0, scale, quant))
    o = torch.cat(outs, dim=-2).transpose(1, 2).reshape(b, t, h * dv)
    return _mm(o, w[p + "attn.wo.weight"], quant)


def route(x, w_router, bias, cfg, quant=None):
    """(idx, gates): the chosen experts (S, k) of x (S, d) and their
    gates, in f32 (x in e4m3 under ``quant="fp8"``)."""
    if quant == "fp8":
        x = grad_fp8(fake_fp8(x))
    s = torch.sigmoid(F.linear(x, w_router))
    idx = torch.topk(s + bias, cfg["num_experts_per_tok"], dim=-1).indices
    g = s.gather(1, idx)
    return idx, g / (g.sum(-1, keepdim=True) + 1e-20) \
        * cfg["routed_scaling_factor"]


def _moe(x, w, p, bias, cfg, quant):
    b, t, d = x.shape
    xs = x.reshape(b * t, d)
    idx, gates = route(xs, w[p + "mlp.router.weight"], bias, cfg, quant)
    out = _swiglu(xs, w[p + "mlp.shared.w_gate_up"],
                  w[p + "mlp.shared.w_down"], quant)
    first = cfg["first_held_expert"]
    wgu, wdn = w[p + "mlp.experts.w_gate_up"], w[p + "mlp.experts.w_down"]
    for e in range(cfg["n_routed_experts"]):
        rows, cols = (idx == first + e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _swiglu(xs[rows], wgu[e].t(), wdn[e].t(), quant)
        out = out.index_add(0, rows, y * gates[rows, cols, None])
    return out.view(b, t, d)


def _layer(x, w, i, bias, cfg, quant):
    p = f"h{i}."
    eps = cfg["rms_norm_eps"]
    x = x + _mla(_rms(x, w[p + "attn_norm.weight"], eps), w, p, cfg, quant)
    hn = _rms(x, w[p + "mlp_norm.weight"], eps)
    if bias is None:
        return x + _swiglu(hn, w[p + "mlp.w_gate_up"], w[p + "mlp.w_down"],
                           quant)
    return x + _moe(hn, w, p, bias, cfg, quant)


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict,
            quant=None) -> torch.Tensor:
    """Logits (B, T, vocab) of 0-based ids (B, T)."""
    biases = router_biases(cfg, tokens.device)
    x = w["embed.weight"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        args = (w, i, biases.get(i), cfg, quant)
        if torch.is_grad_enabled():
            x = checkpoint(_layer, x, *args, use_reentrant=False)
        else:
            x = _layer(x, *args)
    x = _rms(x, w["norm.weight"], cfg["rms_norm_eps"])
    return _mm(x, w["head.weight"], quant)


def loss_sum(w, tokens, target, cfg, quant=None) -> torch.Tensor:
    """Σ of the next-token cross entropy over every position;
    ``target`` 0-based, (B, T)."""
    logits = forward(w, tokens, cfg, quant)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           target.reshape(-1), reduction="sum")


def active_matrix_params(cfg: dict) -> float:
    """Matrix parameters a token meets: MLA, the dense or shared
    SwiGLU, the router and the head, and the held experts at their
    expected assignments a token, top-k · held / routed."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, f = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    mla = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    dense = cfg["first_k_dense_replace"]
    moe = cfg["num_hidden_layers"] - dense
    held = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] \
        / cfg["router_experts"]
    per_moe = (d * cfg["router_experts"]
               + 3 * d * f * cfg["n_shared_experts"] + held * 3 * d * f)
    return (cfg["num_hidden_layers"] * mla
            + dense * 3 * d * cfg["intermediate_size"] + moe * per_moe
            + d * cfg["vocab_size"])


def attention_flops_per_pair(cfg: dict) -> float:
    """Forward, dq and dkv FLOPs of one head on one kept (query, key)
    pair: 2(Dqk + Dv), 2(2·Dqk + Dv) and 4(Dqk + Dv)."""
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    return 2 * (dqk + dv) + 2 * (2 * dqk + dv) + 4 * (dqk + dv)


def model_flops(cfg: dict, mix: dict, record: dict) -> float:
    """A training window's model FLOPs: 6 a matrix parameter a token
    (:func:`active_matrix_params`), plus causal attention at
    :func:`attention_flops_per_pair` a head and kept pair, each layer."""
    b, t = mix["batch"], mix["seq"]
    attn = attention_flops_per_pair(cfg) * cfg["num_attention_heads"] \
        * t * (t + 1) / 2 * b * cfg["num_hidden_layers"]
    return (6.0 * active_matrix_params(cfg) * b * t + attn) * record["steps"]
