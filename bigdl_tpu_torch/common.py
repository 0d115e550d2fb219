"""Common utilities: the seedable host RNG and device resolution.

Counterpart of ``bigdl_tpu/common.py``.  ``RandomGenerator`` is a copy
of the JAX package's numpy host RNG, so that a model built here after
``RandomGenerator.RNG.set_seed(k)`` draws exactly the numbers the JAX
model draws after the same call: seeded models start bit-equal.
"""

from __future__ import annotations

import numpy as np
import torch


class _RNG:
    """Global seedable RNG used for parameter initialisation (numpy
    ``RandomState``, drawn eagerly on the host at construction time)."""

    def __init__(self, seed: int | None = None):
        self._seed = seed if seed is not None else 0
        self._rng = np.random.RandomState(self._seed)

    def set_seed(self, seed: int) -> "_RNG":
        self._seed = int(seed)
        self._rng = np.random.RandomState(self._seed)
        return self

    # camelCase alias for API parity with the reference's Scala spelling.
    setSeed = set_seed

    @property
    def seed(self) -> int:
        return self._seed

    def uniform(self, low: float, high: float, size=None):
        return self._rng.uniform(low, high, size=size)

    def normal(self, mean: float, stdv: float, size=None):
        return self._rng.normal(mean, stdv, size=size)

    def randperm(self, n: int):
        return self._rng.permutation(n)

    def randint(self, low, high=None, size=None):
        return self._rng.randint(low, high, size=size)


class RandomGenerator:
    """Namespace matching the reference's ``RandomGenerator.RNG`` spelling."""

    RNG = _RNG()


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  The default is the card; a
    caller that wants the CPU says ``device="cpu"``.  Asking for CUDA on
    a machine without it raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["RandomGenerator", "resolve_device"]
