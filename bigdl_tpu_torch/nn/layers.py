"""Layers of the port's slice: the Xavier filler and ``Linear``.

Counterpart of ``bigdl_tpu/nn/layers.py`` (``InitializationMethod``,
``Xavier`` at :93, ``Linear`` at :126).  Initial weights are drawn on
the host from the shared numpy ``RandomGenerator.RNG``, in the same
order and shapes as the JAX package, so seeded models start equal.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.nn.module import AbstractModule


class InitializationMethod:
    def init(self, shape, fan_in, fan_out):
        raise NotImplementedError


class Xavier(InitializationMethod):
    """Glorot uniform, the default for ``Linear`` weights."""

    def init(self, shape, fan_in, fan_out):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return RandomGenerator.RNG.uniform(-limit, limit, size=shape).astype(
            np.float32)


class Linear(AbstractModule):
    """``y = x Wᵀ + b`` with the ``(out, in)`` weight of the JAX package."""

    param_names = ("weight", "bias")

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        init = init_method or Xavier()
        self._set_param("weight", init.init(
            (output_size, input_size), input_size, output_size))
        self._set_param("bias", np.zeros(output_size, np.float32)
                        if with_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return y

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"


__all__ = ["InitializationMethod", "Xavier", "Linear"]
