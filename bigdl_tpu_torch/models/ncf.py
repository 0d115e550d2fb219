"""Neural Collaborative Filtering (NeuralCF).

Counterpart of ``bigdl_tpu/models/ncf.py`` (:36-67): a GMF branch (the
elementwise product of user and item embeddings) joined with an MLP
branch (dense layers over the joined embeddings), then a ``Linear``
and ``LogSoftMax`` over the rating classes.  The graph and its
topological order, so its parameter tree, are the JAX package's.  The
input is a (B, 2) matrix of 1-based (user, item) ids, fed as float32
(exact up to 2^24, so the model trains in f32).
"""

from __future__ import annotations

from typing import Sequence

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.nn import (CMulTable, Graph, Input, JoinTable, Linear,
                                LogSoftMax, LookupTable, ReLU, Select)


def build_ncf(user_count: int, item_count: int, class_num: int = 5,
              user_embed: int = 20, item_embed: int = 20,
              hidden_layers: Sequence[int] = (40, 20, 10),
              mf_embed: int = 20, include_mf: bool = True,
              device="cuda") -> Graph:
    """NeuralCF with the reference example's widths, drawn from
    ``RandomGenerator.RNG`` in JAX's order, then moved to ``device``."""
    dev = resolve_device(device)
    inp = Input()
    users = Select(2, 1)(inp)
    items = Select(2, 2)(inp)
    mlp_u = LookupTable(user_count, user_embed)(users)
    mlp_i = LookupTable(item_count, item_embed)(items)
    h = JoinTable(2, 2)(mlp_u, mlp_i)
    width = user_embed + item_embed
    for n in hidden_layers:
        h = ReLU()(Linear(width, n)(h))
        width = n
    if include_mf:
        mf_u = LookupTable(user_count, mf_embed)(users)
        mf_i = LookupTable(item_count, mf_embed)(items)
        gmf = CMulTable()(mf_u, mf_i)
        h = JoinTable(2, 2)(gmf, h)
        width = mf_embed + width
    out = LogSoftMax()(Linear(width, class_num)(h))
    return Graph(inp, out).to(dev)


__all__ = ["build_ncf"]
