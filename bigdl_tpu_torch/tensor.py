"""The ``Tensor`` facade: BigDL's ``Tensor[T]`` op surface over a torch
tensor.

Counterpart of ``bigdl_tpu/tensor.py``.  The reference tensor is
mutable and 1-based; this facade keeps that contract at the API edge:
a wrapper whose "mutations" rebind the wrapped tensor (``set`` aliases
a whole tensor), with the reference's 1-based ``narrow``/``select``/
``transpose`` dims and starts, 1-based indices from ``max``/``min``/
``topk``/``sort``, and ``set_value``/``value_at``.  Its arrays are held
as JAX holds them (64-bit values narrowed to 32 bits, lists as f32), so
both facades give the same numbers.

JAX converts a facade through ``__array__``/``__jax_array__``; here
``__array__`` serves numpy (a dataset's arrays), ``__torch_function__``
serves every torch function (a layer's ``torch.matmul``), and
``AbstractModule.__call__`` and the criteria unwrap a facade argument,
so a ``Tensor`` goes straight into a layer, a criterion and a
``LocalOptimizer``'s dataset.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}


def _canonical(data, dtype=None) -> torch.Tensor:
    """``jnp.asarray``'s result as a torch tensor: lists f32 unless a
    dtype is given, 64-bit arrays narrowed."""
    if isinstance(data, Tensor):
        data = data._a
    if isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        if dtype is None and not hasattr(data, "dtype"):
            dtype = torch.float32
        t = torch.as_tensor(np.asarray(data))
    if dtype is not None:
        return t.to(dtype)
    return t.to(_NARROW[t.dtype]) if t.dtype in _NARROW else t


def unwrap(x):
    """A facade's tensor; a tuple or list of them, unwrapped one level
    down; anything else as it is."""
    if isinstance(x, Tensor):
        return x._a
    if isinstance(x, (tuple, list)) and any(isinstance(v, Tensor)
                                            for v in x):
        return type(x)(unwrap(v) for v in x)
    return x


class Tensor:
    """Mutable facade over a torch tensor (JAX :36)."""

    __array_priority__ = 100     # numpy defers binary ops to Tensor

    def __init__(self, *sizes, dtype=None):
        if len(sizes) == 1 and not isinstance(sizes[0], (int, np.integer)):
            self._a = _canonical(sizes[0], dtype)
        elif sizes:
            self._a = torch.zeros(tuple(int(s) for s in sizes),
                                  dtype=dtype or torch.float32)
        else:
            self._a = torch.zeros((), dtype=dtype or torch.float32)

    # ------------------------------------------------------------ bridges
    @classmethod
    def from_ndarray(cls, a) -> "Tensor":
        return cls(np.asarray(a))

    def to_ndarray(self) -> np.ndarray:
        return self._a.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.to_ndarray()
        return a.astype(dtype) if dtype is not None else a

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        return func(*(unwrap(a) for a in args),
                    **{k: unwrap(v) for k, v in kwargs.items()})

    @property
    def data(self) -> torch.Tensor:
        """The wrapped torch tensor."""
        return self._a

    # ---------------------------------------------------------- shape api
    def size(self, dim: Optional[int] = None):
        """size() -> the shape; size(d), d 1-based."""
        if dim is None:
            return tuple(self._a.shape)
        return self._a.shape[dim - 1]

    def dim(self) -> int:
        return self._a.dim()

    n_dimension = dim
    nDimension = property(lambda self: self._a.dim())

    def n_element(self) -> int:
        return int(self._a.numel())

    nElement = n_element

    @property
    def shape(self):
        return tuple(self._a.shape)

    @property
    def dtype(self):
        return self._a.dtype

    def is_empty(self) -> bool:
        return self._a.numel() == 0

    def is_scalar(self) -> bool:
        return self._a.dim() == 0

    # ------------------------------------------------------ slicing (1-based)
    def narrow(self, dim: int, index: int, size: int) -> "Tensor":
        """narrow(dim, index, size), dim and index 1-based; a copy (write
        back with set()/copy())."""
        return Tensor(self._a.narrow(dim - 1, index - 1, size).clone())

    def select(self, dim: int, index: int) -> "Tensor":
        """select(dim, index): ``dim`` (1-based) dropped."""
        return Tensor(self._a.select(dim - 1, index - 1).clone())

    def index_select(self, dim: int, indices) -> "Tensor":
        ix = torch.as_tensor(np.asarray(indices, np.int64) - 1,
                             device=self._a.device)
        return Tensor(self._a.index_select(dim - 1, ix))

    def view(self, *sizes) -> "Tensor":
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        return Tensor(self._a.reshape(sizes))

    reshape = view

    def squeeze(self, dim: Optional[int] = None) -> "Tensor":
        if dim is None:
            self._a = torch.squeeze(self._a)
        elif self._a.shape[dim - 1] == 1:
            self._a = torch.squeeze(self._a, dim - 1)
        return self

    def unsqueeze(self, dim: int) -> "Tensor":
        self._a = torch.unsqueeze(self._a, dim - 1)
        return self

    def t(self) -> "Tensor":
        assert self._a.dim() == 2, "t() expects a 2D tensor"
        return Tensor(self._a.t().contiguous())

    def transpose(self, dim1: int, dim2: int) -> "Tensor":
        return Tensor(self._a.transpose(dim1 - 1, dim2 - 1).contiguous())

    def clone(self) -> "Tensor":
        return Tensor(self._a.clone())

    def contiguous(self) -> "Tensor":
        return self

    # ------------------------------------------------- mutation (rebinding)
    def set(self, other) -> "Tensor":
        """set(other): alias other's whole tensor."""
        self._a = other._a if isinstance(other, Tensor) else _canonical(other)
        return self

    def copy(self, src) -> "Tensor":
        """copy(src): overwrite the contents elementwise."""
        self._a = _canonical(src).to(self._a.dtype).reshape(self._a.shape)
        return self

    def fill(self, value) -> "Tensor":
        self._a = torch.full_like(self._a, value)
        return self

    def zero(self) -> "Tensor":
        return self.fill(0)

    def resize(self, *sizes) -> "Tensor":
        """Keeps the contents when the element count matches, else zeros
        (the reference's reallocation)."""
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        sizes = tuple(int(s) for s in sizes)
        if int(np.prod(sizes)) == self._a.numel():
            self._a = self._a.reshape(sizes)
        else:
            self._a = torch.zeros(sizes, dtype=self._a.dtype,
                                  device=self._a.device)
        return self

    def resize_as(self, other: "Tensor") -> "Tensor":
        return self.resize(*other.shape)

    resizeAs = resize_as

    def set_value(self, *args) -> "Tensor":
        """setValue(d1, ..., dn, value), indices 1-based."""
        *idx, value = args
        a = self._a.clone()
        a[tuple(int(i) - 1 for i in idx)] = value
        self._a = a
        return self

    setValue = set_value

    def value_at(self, *idx):
        return self._a[tuple(int(i) - 1 for i in idx)].item()

    valueAt = value_at

    # ------------------------------------------------------------- math
    @staticmethod
    def _coerce(other):
        return other._a if isinstance(other, Tensor) else other

    def add(self, other) -> "Tensor":
        self._a = self._a + self._coerce(other)
        return self

    def sub(self, other) -> "Tensor":
        self._a = self._a - self._coerce(other)
        return self

    def mul(self, scalar) -> "Tensor":
        self._a = self._a * self._coerce(scalar)
        return self

    def div(self, other) -> "Tensor":
        self._a = self._a / self._coerce(other)
        return self

    def cmul(self, other) -> "Tensor":
        return self.mul(other)

    def cdiv(self, other) -> "Tensor":
        return self.div(other)

    def pow(self, n) -> "Tensor":
        self._a = self._a ** n
        return self

    def sqrt(self) -> "Tensor":
        self._a = torch.sqrt(self._a)
        return self

    def exp(self) -> "Tensor":
        self._a = torch.exp(self._a)
        return self

    def log(self) -> "Tensor":
        self._a = torch.log(self._a)
        return self

    def abs(self) -> "Tensor":
        self._a = torch.abs(self._a)
        return self

    def add_mm(self, m1, m2) -> "Tensor":
        """addmm: self += m1 @ m2."""
        self._a = self._a + self._coerce(m1) @ self._coerce(m2)
        return self

    addmm = add_mm

    def mm(self, m1, m2) -> "Tensor":
        self._a = self._coerce(m1) @ self._coerce(m2)
        return self

    def mv(self, m, v) -> "Tensor":
        self._a = self._coerce(m) @ self._coerce(v)
        return self

    def dot(self, other):
        return float(torch.sum(self._a * self._coerce(other)))

    def sum(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._a.sum())
        return Tensor(torch.sum(self._a, dim - 1, keepdim=True))

    def mean(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._a.mean())
        return Tensor(torch.mean(self._a, dim - 1, keepdim=True))

    def _extremum(self, dim, values, index):
        if dim is None:
            return float(values(self._a))
        v = values(self._a, dim - 1, keepdim=True)
        i = index(self._a, dim - 1, keepdim=True).to(torch.int32) + 1
        return Tensor(v), Tensor(i)

    def max(self, dim: Optional[int] = None):
        """max() -> a scalar; max(dim) -> (values, 1-based indices)."""
        return self._extremum(dim, torch.amax, torch.argmax)

    def min(self, dim: Optional[int] = None):
        return self._extremum(dim, torch.amin, torch.argmin)

    def norm(self, p: int = 2):
        return float(torch.sum(torch.abs(self._a) ** p) ** (1.0 / p))

    # ------------------------------------------------------ apply1 / map
    def apply1(self, fn: Callable[[float], float]) -> "Tensor":
        """apply1(f): an elementwise host function (numpy vectorize; for
        the API, not the hot path)."""
        a = self.to_ndarray()
        self._a = torch.from_numpy(np.vectorize(fn)(a).astype(a.dtype))
        return self

    def map(self, other, fn: Callable[[float, float], float]) -> "Tensor":
        a = self.to_ndarray()
        b = np.asarray(self._coerce(other))
        self._a = torch.from_numpy(np.vectorize(fn)(a, b).astype(a.dtype))
        return self

    # ----------------------------------------- gather / scatter / masked
    def gather(self, dim: int, index) -> "Tensor":
        """gather(dim, index): index holds 1-based positions along
        ``dim``; the output has index's shape."""
        ix = torch.as_tensor(np.asarray(index, np.int64) - 1,
                             device=self._a.device)
        return Tensor(torch.take_along_dim(self._a, ix, dim - 1))

    def scatter(self, dim: int, index, src) -> "Tensor":
        """scatter(dim, index, src): src's values written at the 1-based
        positions of index along ``dim``."""
        ix = torch.as_tensor(np.asarray(index, np.int64) - 1,
                             device=self._a.device)
        srcv = self._coerce(src)
        a = self._a.clone()
        if isinstance(srcv, torch.Tensor) or np.ndim(srcv):
            s = _canonical(srcv).to(a.dtype)
            s = s[tuple(slice(0, n) for n in ix.shape)]
            a.scatter_(dim - 1, ix, s)
        else:
            a.scatter_(dim - 1, ix, float(srcv))
        self._a = a
        return self

    def masked_fill(self, mask, value) -> "Tensor":
        """maskedFill(mask, value) where mask != 0."""
        m = _canonical(self._coerce(mask)) != 0
        self._a = torch.where(m, torch.as_tensor(value, dtype=self._a.dtype),
                              self._a)
        return self

    def masked_select(self, mask) -> "Tensor":
        """maskedSelect: the 1-D tensor of the elements where mask != 0."""
        m = _canonical(self._coerce(mask)) != 0
        return Tensor(self._a[m])

    def masked_copy(self, mask, src) -> "Tensor":
        """maskedCopy: src's elements, in order, into the positions the
        mask selects."""
        m = _canonical(self._coerce(mask)) != 0
        s = _canonical(self._coerce(src)).reshape(-1).to(self._a.dtype)
        a = self._a.clone()
        a[m] = s[:int(m.sum())]
        self._a = a
        return self

    def _index_put(self, dim, indices, value, accumulate=False):
        ix = torch.as_tensor(np.asarray(indices, np.int64) - 1,
                             device=self._a.device)
        idx = [slice(None)] * self._a.dim()
        idx[dim - 1] = ix
        a = self._a.clone()
        v = _canonical(value).to(a.dtype) if isinstance(
            value, (Tensor, torch.Tensor, np.ndarray, list)) else value
        if accumulate:
            a[tuple(idx)] += v
        else:
            a[tuple(idx)] = v
        self._a = a
        return self

    def index_fill(self, dim: int, indices, value) -> "Tensor":
        return self._index_put(dim, indices, value)

    def index_copy(self, dim: int, indices, src) -> "Tensor":
        return self._index_put(dim, indices, self._coerce(src))

    def index_add(self, dim: int, indices, src) -> "Tensor":
        return self._index_put(dim, indices, self._coerce(src), True)

    # --------------------------------------------- more reference math
    def cmax(self, other) -> "Tensor":
        self._a = torch.maximum(self._a, torch.as_tensor(self._coerce(other),
                                                         dtype=self._a.dtype))
        return self

    def cmin(self, other) -> "Tensor":
        self._a = torch.minimum(self._a, torch.as_tensor(self._coerce(other),
                                                         dtype=self._a.dtype))
        return self

    def clamp(self, min_value, max_value) -> "Tensor":
        self._a = torch.clamp(self._a, min_value, max_value)
        return self

    def sign(self) -> "Tensor":
        self._a = torch.sign(self._a)
        return self

    def floor(self) -> "Tensor":
        self._a = torch.floor(self._a)
        return self

    def ceil(self) -> "Tensor":
        self._a = torch.ceil(self._a)
        return self

    def addcmul(self, scalar, t1, t2) -> "Tensor":
        """self += scalar · t1 · t2."""
        self._a = self._a + scalar * self._coerce(t1) * self._coerce(t2)
        return self

    def addcdiv(self, scalar, t1, t2) -> "Tensor":
        self._a = self._a + scalar * self._coerce(t1) / self._coerce(t2)
        return self

    def addr(self, v1, v2) -> "Tensor":
        """The outer product v1 (m) × v2 (n) added into self (m, n)."""
        self._a = self._a + torch.outer(_canonical(self._coerce(v1)),
                                        _canonical(self._coerce(v2)))
        return self

    def _ordered(self, dim, descending):
        d = (self._a.dim() if dim is None else dim) - 1
        key = -self._a if descending else self._a
        order = torch.argsort(key, dim=d, stable=True)
        return d, order

    def topk(self, k: int, dim: Optional[int] = None,
             increase: bool = False):
        """topk(k, dim, increase) -> (values, 1-based f32 indices); the
        smallest k when ``increase``."""
        d, order = self._ordered(dim, not increase)
        idx = order.narrow(d, 0, k)
        vals = torch.take_along_dim(self._a, idx, d)
        return Tensor(vals), Tensor((idx + 1).to(torch.float32))

    def sort(self, dim: Optional[int] = None, descending: bool = False):
        d, order = self._ordered(dim, descending)
        vals = torch.take_along_dim(self._a, order, d)
        return Tensor(vals), Tensor((order + 1).to(torch.float32))

    def nonzero(self) -> "Tensor":
        """The 1-based (nnz, ndim) coordinates of the nonzeros."""
        return Tensor(torch.nonzero(self._a) + 1)

    def expand(self, *sizes) -> "Tensor":
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        return Tensor(self._a.expand(tuple(int(s) for s in sizes)).clone())

    def repeat_tensor(self, *sizes) -> "Tensor":
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        sizes = tuple(int(s) for s in sizes)
        a = self._a
        if len(sizes) > a.dim():
            a = a.reshape((1,) * (len(sizes) - a.dim()) + tuple(a.shape))
        elif len(sizes) < a.dim():
            sizes = (1,) * (a.dim() - len(sizes)) + sizes
        return Tensor(a.repeat(*sizes))

    def split(self, size: int, dim: int = 1):
        """Chunks of ``size`` along 1-based ``dim`` (the last may be
        smaller)."""
        return [Tensor(c.clone()) for c in torch.split(self._a, size,
                                                        dim - 1)]

    def chunk(self, n_chunks: int, dim: int = 1):
        size = -(-self._a.shape[dim - 1] // n_chunks)
        return self.split(size, dim)

    # ------------------------------------------------- random fills
    def _host_draw(self, draw) -> "Tensor":
        a = np.asarray(draw(tuple(self._a.shape)))
        self._a = torch.from_numpy(a.astype(
            torch.empty((), dtype=self._a.dtype).numpy().dtype))
        return self

    def uniform(self, a: float = 0.0, b: float = 1.0) -> "Tensor":
        from bigdl_tpu_torch.common import RandomGenerator

        return self._host_draw(lambda s: RandomGenerator.RNG.uniform(a, b, s))

    def normal(self, mean: float = 0.0, stdv: float = 1.0) -> "Tensor":
        from bigdl_tpu_torch.common import RandomGenerator

        return self._host_draw(
            lambda s: RandomGenerator.RNG.normal(mean, stdv, s))

    def bernoulli(self, p: float = 0.5) -> "Tensor":
        from bigdl_tpu_torch.common import RandomGenerator

        return self._host_draw(
            lambda s: RandomGenerator.RNG.uniform(0, 1, s) < p)

    # reference camelCase spellings
    maskedFill = masked_fill
    maskedSelect = masked_select
    maskedCopy = masked_copy
    indexSelect = index_select
    indexFill = index_fill
    indexCopy = index_copy
    indexAdd = index_add
    repeatTensor = repeat_tensor

    # -------------------------------------------------------- operators
    def __add__(self, other):
        return Tensor(self._a + self._coerce(other))

    __radd__ = __add__

    def __sub__(self, other):
        return Tensor(self._a - self._coerce(other))

    def __rsub__(self, other):
        return Tensor(self._coerce(other) - self._a)

    def __mul__(self, other):
        return Tensor(self._a * self._coerce(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return Tensor(self._a / self._coerce(other))

    def __neg__(self):
        return Tensor(-self._a)

    def __getitem__(self, item):
        out = self._a[item]
        return Tensor(out) if out.dim() else out.item()

    def __len__(self):
        return self._a.shape[0]

    def __eq__(self, other):
        if isinstance(other, Tensor):
            return (self._a.shape == other._a.shape
                    and bool((self._a == other._a).all()))
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return (f"Tensor(shape={tuple(self._a.shape)}, dtype={self._a.dtype})"
                f"\n{self.to_ndarray()}")


def randn(*sizes) -> Tensor:
    """A tensor drawn from the seedable ``RandomGenerator`` (the
    reference's ``Tensor[Float](...).randn()``)."""
    from bigdl_tpu_torch.common import RandomGenerator

    return Tensor(RandomGenerator.RNG.normal(0.0, 1.0, tuple(sizes))
                  .astype(np.float32))


def rand(*sizes) -> Tensor:
    from bigdl_tpu_torch.common import RandomGenerator

    return Tensor(RandomGenerator.RNG.uniform(0.0, 1.0, tuple(sizes))
                  .astype(np.float32))


__all__ = ["Tensor", "randn", "rand", "unwrap"]
