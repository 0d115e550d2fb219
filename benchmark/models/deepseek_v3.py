"""The program's DeepSeek-V3: ``models/deepseek_v3.py``'s
``DeepseekV3LM`` at the configuration's widths and held share, trained
under ``CrossEntropyCriterion``.  ``STATS`` keeps the last built model's
``MoEStats`` (the held experts' loads while profiling) for the readers,
after the driver has let the model go."""

from __future__ import annotations

import torch

from benchmark.models import kernels

STATS = None


def build(cfg: dict, device):
    global STATS
    kernels(device)
    from bigdl_tpu_torch.models.deepseek_v3 import DeepseekV3LM

    model = DeepseekV3LM(
        cfg["vocab_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
        cfg["first_k_dense_replace"], cfg["num_attention_heads"],
        cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
        cfg["kv_lora_rank"], cfg["intermediate_size"],
        cfg["moe_intermediate_size"], cfg["router_experts"],
        cfg["num_experts_per_tok"], cfg["n_shared_experts"],
        cfg["routed_scaling_factor"], cfg["first_held_expert"],
        cfg["n_routed_experts"], float(cfg["rope_theta"]),
        cfg["rms_norm_eps"], cfg["kv_norm_eps"],
        std=cfg["initializer_range"], attn_impl=cfg["attn_impl"],
        device=device)
    STATS = model.moe_stats
    return model


def criterion(cfg: dict):
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion

    return CrossEntropyCriterion()


def load(model, w: dict, ref, cfg: dict) -> dict:
    """Copy the benchmark's weights into the program's parameters (the
    reference names them as the program does) and the reference's
    selection biases into the routers' buffers; returns {id(parameter):
    name}."""
    params = dict(model.named_parameters())
    names = [n for n, _, _ in ref.weight_specs(cfg)]
    if sorted(params) != sorted(names):
        raise ValueError("the program's parameters are not the "
                         f"reference's: {sorted(set(params) ^ set(names))}")
    dev = next(iter(params.values())).device
    with torch.no_grad():
        for n in names:
            params[n].copy_(w[n])
        for i, b in ref.router_biases(cfg, dev).items():
            model.child(f"h{i}").mlp.router.bias.copy_(b)
    return {id(params[n]): n for n in names}
