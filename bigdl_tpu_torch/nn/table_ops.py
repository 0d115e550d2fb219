"""Table containers and ops: the residual block's fork and add, and the
Inception block's branches and their join.

Counterpart of ``bigdl_tpu/nn/table_ops.py``: ``ConcatTable`` (:22)
applies each child to the same input and returns the tuple of their
outputs; ``CAddTable`` (:63), ``CMulTable`` (:83) and ``CMaxTable``
(:100) reduce a tuple elementwise, left to right; ``JoinTable``
(:170-183) concatenates a tuple along a 1-based dimension; ``Concat``
(:269-292) runs each child on the same input and concatenates their
outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import AbstractModule, Container


class ConcatTable(Container):
    def forward(self, x, rng_seed: Optional[int] = None):
        return tuple(self._call_child(i, m, x, rng_seed)
                     for i, m in enumerate(self._modules.values()))


class CAddTable(AbstractModule):
    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, xs):
        y = xs[0]
        for t in xs[1:]:
            y = y + t
        return y


class CMulTable(AbstractModule):
    def forward(self, xs):
        y = xs[0]
        for t in xs[1:]:
            y = y * t
        return y


class CMaxTable(AbstractModule):
    """Elementwise max; ``torch.maximum`` splits the gradient at a tie
    as ``jnp.maximum`` does."""

    def forward(self, xs):
        y = xs[0]
        for t in xs[1:]:
            y = torch.maximum(y, t)
        return y


class JoinTable(AbstractModule):
    """Concatenate a tuple along the 1-based ``dimension``; with
    ``n_input_dims`` > 0, an input of more dims than that has a batch
    dim in front, and the dimension shifts by one."""

    config_names = ("dimension", "n_input_dims")

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, xs):
        d = self.dimension - 1
        if self.n_input_dims > 0 and xs[0].dim() > self.n_input_dims:
            d += 1
        return torch.cat(list(xs), dim=d)


class Concat(Container):
    """Run each child on the same input and concatenate the outputs
    along the 1-based ``dimension`` (2: the channels of an NCHW batch).
    Child i that takes a dropout seed gets ``fold_in(rng_seed, i)``."""

    config_names = ("dimension",)

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, x, rng_seed: Optional[int] = None):
        return torch.cat([self._call_child(i, m, x, rng_seed)
                          for i, m in enumerate(self._modules.values())],
                         dim=self.dimension - 1)


__all__ = ["ConcatTable", "CAddTable", "CMulTable", "CMaxTable",
           "JoinTable", "Concat"]
