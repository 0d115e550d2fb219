"""Carry the JAX package's parameter and state trees into the port.

No JAX counterpart.  ``params_from_jax`` takes the nested dict that the
JAX ``TransformerLM.params()`` returns, with its leaves already turned
into numpy arrays (``np.asarray`` of each leaf), and gives the same
nesting with torch tensors: ``wte/wpe/h{i}/{ln1,attn,ln2,fc1,fc2}/
ln_f/head``, where ``attn`` holds ``wq,wk,wv,wo,bq,bk,bv,bo`` and
``head`` has no bias.  ``load_jax_params`` copies such a tree into a
port model, so that both packages compute with the same weights; a
``Sequential`` (ResNet, the autoencoder) nests by child index,
``"0"``, ``"1"``, ..., as the JAX ``Container.params()`` does, and a
``Graph`` (NCF, Inception) by its nodes' topological index, as the
JAX ``Graph`` does.  The control containers nest the same way:
``IfElse`` and ``WhileLoop`` hold their two children as ``"0"`` and
``"1"``, and a ``DynamicGraph`` nests by the topological index of its
widened sort (the condition node and the feedback sources included).
A keras ``Sequential`` or ``Model`` carries its weights in ``.core``
(the JAX keras model's ``.core.params()``).  ``load_jax_state`` does the
same for the BN running statistics of ``model.state()``.  Every layer
keeps its JAX parameter names and layouts (``LocallyConnected2D``'s
``(O, I·kh·kw, oh, ow)``, ``Maxout``'s ``(in, k·out)``,
``VolumetricFullConvolution``'s IODHW, ...), so the trees load as they
are, with no per-layer mapping.
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


def _missing(want, have, path="") -> list:
    """Paths of ``want``'s leaves that ``have`` lacks."""
    out = []
    for k, v in want.items():
        p = f"{path}/{k}" if path else k
        if k not in have:
            out.append(p)
        elif isinstance(v, dict):
            out.extend(_missing(v, have[k] if isinstance(have[k], dict)
                                else {}, p))
    return out


def load_jax_params(model, tree) -> None:
    """Copy a JAX parameter tree (numpy leaves) into ``model`` in
    place, onto the model's device and dtype.  Every parameter of the
    model must find its leaf in the tree: the transformer's names, or a
    ``Sequential``'s child indices (fused models too)."""
    model = getattr(model, "core", model)
    params = params_from_jax(tree)
    missing = _missing(model.params(), params)
    if missing:
        raise KeyError(f"JAX parameter tree lacks {missing}")
    model.set_params(params)


def load_jax_state(model, tree) -> None:
    """Copy a JAX ``model.state()`` tree (BN running mean and variance,
    numpy leaves) into the model's buffers, as ``load_jax_params``."""
    model = getattr(model, "core", model)
    state = params_from_jax(tree)
    missing = _missing(model.state(), state)
    if missing:
        raise KeyError(f"JAX state tree lacks {missing}")
    model.set_state(state)


__all__ = ["params_from_jax", "load_jax_params", "load_jax_state"]
