"""Carry the JAX package's parameter tree into the port's modules.

No JAX counterpart.  ``params_from_jax`` takes the nested dict that the
JAX ``TransformerLM.params()`` returns, with its leaves already turned
into numpy arrays (``np.asarray`` of each leaf), and gives the same
nesting with torch tensors: ``wte/wpe/h{i}/{ln1,attn,ln2,fc1,fc2}/
ln_f/head``, where ``attn`` holds ``wq,wk,wv,wo,bq,bk,bv,bo`` and
``head`` has no bias.  ``load_jax_params`` copies such a tree into a
port model, so that both packages compute with the same weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree) -> Dict[str, Any]:
    """Nested dict of array-likes -> the same nesting of torch tensors
    (copies; None leaves stay None)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree, copy=True))


def load_jax_params(model, tree) -> None:
    """Copy a JAX parameter tree (numpy leaves) into ``model`` in
    place, onto the model's device and dtype.  Every module of the
    model must find its parameters in the tree."""
    params = params_from_jax(tree)
    missing = sorted(set(model.params()) - set(params))
    if missing:
        raise KeyError(f"JAX parameter tree lacks {missing}")
    model.set_params(params)


__all__ = ["params_from_jax", "load_jax_params"]
