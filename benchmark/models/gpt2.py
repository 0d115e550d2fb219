"""The program's GPT-2: ``models/transformer.py``'s ``TransformerLM`` at
the configuration's widths, trained under ``CrossEntropyCriterion``."""

from __future__ import annotations

import torch

from benchmark.models import kernels


def build(cfg: dict, device):
    kernels(device)
    from bigdl_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(cfg["vocab_size"], dim=cfg["n_embd"],
                         n_head=cfg["n_head"], n_layer=cfg["n_layer"],
                         max_len=cfg["n_positions"],
                         mlp_ratio=cfg["mlp_ratio"], dropout=cfg["dropout"],
                         attn_impl=cfg["attn_impl"], device=device)


def criterion(cfg: dict):
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion

    return CrossEntropyCriterion()


def load(model, w: dict, ref, cfg: dict) -> dict:
    """Copy the benchmark's weights into the program's parameters (the
    reference names them as the program does); returns {id(parameter):
    name}."""
    params = dict(model.named_parameters())
    names = [n for n, _, _ in ref.weight_specs(cfg)]
    if sorted(params) != sorted(names):
        raise ValueError("the program's parameters are not the "
                         f"reference's: {sorted(set(params) ^ set(names))}")
    with torch.no_grad():
        for n in names:
            params[n].copy_(w[n])
    return {id(params[n]): n for n in names}

