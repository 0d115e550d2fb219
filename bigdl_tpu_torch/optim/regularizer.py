"""Regularizers: L1 and L2 penalties on a layer's parameters.

Counterpart of ``bigdl_tpu/optim/regularizer.py`` (:17-39).  A layer
given ``w_regularizer``/``b_regularizer`` lists them, and
``AbstractModule.regularization_loss`` sums their penalties; the
trainers add that sum to the loss (JAX ``optimizer.py:552``), so
autograd gives the penalty's gradient, as the JAX package lets
``jax.grad`` do.
"""

from __future__ import annotations

import torch


class L1L2Regularizer:
    """l1 · Σ|w| + ½ · l2 · Σw².  |w| is taken as ``where(w >= 0, w,
    -w)``: the same value, and the derivative 1 at w = 0 that
    ``jax.grad`` of ``jnp.abs`` gives (torch's ``abs`` gives 0 there,
    and a bias starts at 0)."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = l1, l2

    def __call__(self, param: torch.Tensor):
        loss = 0.0
        if self.l1:
            loss = loss + self.l1 * torch.sum(
                torch.where(param >= 0, param, -param))
        if self.l2:
            loss = loss + 0.5 * self.l2 * torch.sum(param * param)
        return loss

    def get_config(self) -> dict:
        """A layer's spec records its regularizers as this dict."""
        return {"class": type(self).__name__, "l1": self.l1, "l2": self.l2}


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float):
        super().__init__(l2=l2)


def regularizer_from_config(config):
    """The regularizer a spec's dict describes; anything else (``None``,
    a regularizer) is returned as it is."""
    if not isinstance(config, dict):
        return config
    cls = {c.__name__: c for c in (L1L2Regularizer, L1Regularizer,
                                   L2Regularizer)}[config["class"]]
    reg = cls.__new__(cls)
    L1L2Regularizer.__init__(reg, config["l1"], config["l2"])
    return reg


__all__ = ["L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "regularizer_from_config"]
