"""Table containers and ops: the residual block's fork and add.

Counterpart of ``bigdl_tpu/nn/table_ops.py``: ``ConcatTable`` (:22)
applies each child to the same input and returns the tuple of their
outputs; ``CAddTable`` (:63) sums a tuple elementwise, left to right.
"""

from __future__ import annotations

from bigdl_tpu_torch.nn.module import AbstractModule, Container


class ConcatTable(Container):
    def forward(self, x):
        return tuple(m(x) for m in self._modules.values())


class CAddTable(AbstractModule):
    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, xs):
        y = xs[0]
        for t in xs[1:]:
            y = y + t
        return y


__all__ = ["ConcatTable", "CAddTable"]
