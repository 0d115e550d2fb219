"""Common utilities: the seedable host RNG, seed folding, device
resolution, dtype names and the 1-based ``Table``.

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


_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data``: the role of
    ``jax.random.fold_in`` (a step's key from the base key, a block's
    from the step's), not its numbers.  splitmix64 of the pair."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


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


_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
    "double": torch.float64, "int32": torch.int32, "int8": torch.int8,
}


def get_dtype(dtype=None):
    """The torch dtype of a name (JAX :60: the same names), f32 for
    None; a dtype passes through."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        return _DTYPES[dtype]
    return dtype


def to_numpy(x) -> np.ndarray:
    """A numpy array of ``x``; a tensor is detached and read to the
    host first."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Table(dict):
    """1-based-keyed table, the reference's generic container (JAX
    :84).  Plain lists and tuples are the tables on the compute path;
    this is for code that indexes ``output[1]``, ``output[2]``."""

    @staticmethod
    def from_seq(seq):
        t = Table()
        for i, v in enumerate(seq):
            t[i + 1] = v
        return t

    def to_seq(self):
        return [self[i + 1] for i in range(len(self))]


__all__ = ["RandomGenerator", "Table", "fold_in", "get_dtype",
           "resolve_device", "to_numpy"]
