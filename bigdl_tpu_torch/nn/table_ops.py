"""Table containers and ops: every class of the JAX module.

Counterpart of ``bigdl_tpu/nn/table_ops.py``: ``ConcatTable`` (:22)
applies each child to the same input and returns the tuple of their
outputs; ``CAddTable`` (:63), ``CMulTable`` (:83) and ``CMaxTable``
(:100) reduce a tuple elementwise, left to right; ``JoinTable``
(:170-183) concatenates a tuple along a 1-based dimension; ``Concat``
(:269-292) runs each child on the same input and concatenates their
outputs; the containers ``ParallelTable``, ``MapTable`` and ``Bottle``
and the other table ops follow, each cited by line.  A table is a
tuple; dims and indices are 1-based, as in the reference.
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


class ParallelTable(Container):
    """Child i on table entry i (JAX :40); child i that takes a dropout
    seed gets ``fold_in(rng_seed, i)``."""

    def forward(self, xs, rng_seed: Optional[int] = None):
        return tuple(self._call_child(i, m, x, rng_seed)
                     for i, (m, x) in enumerate(zip(self._modules.values(),
                                                    xs)))


class MapTable(Container):
    """One shared child on every entry of the table (JAX :392), its
    weights shared across entries.  A child with state (BN) updates it
    entry by entry, in order, as JAX threads the state through the
    entries; entry i's dropout seed is ``fold_in(rng_seed, i)``."""

    def __init__(self, module: Optional[AbstractModule] = None):
        super().__init__()
        if module is not None:
            self.add(module)

    def add(self, module: AbstractModule):
        if len(self._modules) > 0:
            raise ValueError("MapTable takes exactly one module")
        return super().add(module)

    def forward(self, xs, rng_seed: Optional[int] = None):
        m = self._modules["0"]
        return tuple(self._call_child(i, m, x, rng_seed)
                     for i, x in enumerate(xs))


class Bottle(Container):
    """Fold the leading dims into one batch dim, so that x keeps its
    last ``n_input_dim - 1`` dims, apply the child (which must give a
    rank-``n_output_dim`` output), unfold (JAX :420)."""

    config_names = ("n_input_dim", "n_output_dim")

    def __init__(self, module: Optional[AbstractModule] = None,
                 n_input_dim: int = 2, n_output_dim: int = 2):
        super().__init__()
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim
        if module is not None:
            self.add(module)

    def add(self, module: AbstractModule):
        if len(self._modules) > 0:
            raise ValueError("Bottle takes exactly one module")
        return super().add(module)

    def forward(self, x, rng_seed: Optional[int] = None):
        cut = x.dim() - self.n_input_dim + 1
        lead = tuple(x.shape[:cut])
        merged = x.reshape((-1,) + tuple(x.shape[cut:]))
        child = self._modules["0"]
        y = child(merged, rng_seed=rng_seed) if child.takes_rng_seed \
            else child(merged)
        if y.dim() != self.n_output_dim:
            raise ValueError(f"Bottle: child produced a rank-{y.dim()} "
                             f"output but n_output_dim={self.n_output_dim}")
        return y.reshape(lead + tuple(y.shape[1:]))


class CSubTable(AbstractModule):
    """``x1 - x2`` (JAX :76)."""

    def forward(self, xs):
        return xs[0] - xs[1]


class CDivTable(AbstractModule):
    """``x1 / x2`` (JAX :93)."""

    def forward(self, xs):
        return xs[0] / xs[1]


class CMinTable(AbstractModule):
    """Elementwise min, left to right (JAX :111); ``torch.minimum``
    splits the gradient at a tie as ``jnp.minimum`` does."""

    def forward(self, xs):
        y = xs[0]
        for t in xs[1:]:
            y = torch.minimum(y, t)
        return y


class CAveTable(AbstractModule):
    """Elementwise mean of the table (JAX :298)."""

    def forward(self, xs):
        y = xs[0]
        for t in xs[1:]:
            y = y + t
        return y / len(xs)


class InTopK(AbstractModule):
    """TF's InTopK over the table (predictions (B, C), 0-based targets
    (B,)): 1.0 where the target's class is among the top ``k``, as
    float32 (JAX :122).  TF's rules: the target is in the top k iff
    fewer than k classes score strictly higher (ties count in); a
    non-finite target score is never in; a target outside [0, C) gives
    0 (its index is clamped before the gather, where JAX's gather
    clamps on its own)."""

    config_names = ("k",)

    def __init__(self, k: int = 1):
        super().__init__()
        self.k = k

    def forward(self, xs):
        preds, tgt = xs
        t = tgt.to(torch.int64)
        idx = torch.clamp(t, 0, preds.shape[1] - 1)[:, None]
        score = torch.gather(preds, 1, idx)
        n_higher = torch.sum(preds > score, dim=1)
        ok = (n_higher < self.k) & torch.isfinite(score[:, 0])
        valid = (tgt >= 0) & (tgt < preds.shape[1])
        return (ok & valid).to(torch.float32)


class WhereTable(AbstractModule):
    """``cond ? x : y`` over the table (cond, x, y), cond as {0, 1}
    floats (JAX :147); the predicate gets no gradient.  With
    ``leading_broadcast`` (TF's Select v1) a lower-rank cond broadcasts
    along the leading axes (a rank-1 cond is a row mask), without it
    numpy-style (SelectV2)."""

    config_names = ("leading_broadcast",)

    def __init__(self, leading_broadcast: bool = False):
        super().__init__()
        self.leading_broadcast = leading_broadcast

    def forward(self, xs):
        cond, x, y = xs
        if self.leading_broadcast and cond.dim() < x.dim():
            cond = cond.reshape(tuple(cond.shape)
                                + (1,) * (x.dim() - cond.dim()))
        return torch.where(cond != 0, x, y)


class SelectTable(AbstractModule):
    """Table entry at the 1-based ``index`` (negative: from the end)
    (JAX :187)."""

    config_names = ("index",)

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[self.index - 1 if self.index > 0 else self.index]


class FlattenTable(AbstractModule):
    """Nested tables flattened, depth first (JAX :199)."""

    def forward(self, xs):
        out = []

        def rec(t):
            if isinstance(t, (tuple, list)):
                for u in t:
                    rec(u)
            else:
                out.append(t)

        rec(xs)
        return tuple(out)


class MM(AbstractModule):
    """Batched matmul of the table (a, b), each optionally transposed in
    its last two dims (JAX :216)."""

    config_names = ("trans_a", "trans_b")

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, xs):
        a, b = xs
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(AbstractModule):
    """(Batched) matrix-vector product of the table (m, v), m optionally
    transposed (JAX :234)."""

    config_names = ("trans",)

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, xs):
        m, v = xs
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class DotProduct(AbstractModule):
    """Σ a·b over the last dim (JAX :249)."""

    def forward(self, xs):
        a, b = xs
        return torch.sum(a * b, dim=-1)


class CosineDistance(AbstractModule):
    """Cosine of each row pair of the table (a, b), the norms' product
    at least 1e-12 (JAX :258)."""

    def forward(self, xs):
        a, b = xs
        na = torch.linalg.vector_norm(a, dim=-1)
        nb = torch.linalg.vector_norm(b, dim=-1)
        return torch.sum(a * b, dim=-1) / torch.maximum(
            na * nb, na.new_tensor(1e-12))


class SplitTable(AbstractModule):
    """The slices of x along the 1-based ``dimension`` (shifted by one
    when x has more dims than a positive ``n_input_dims``; a negative
    dimension counts from the end and is not shifted), as a table (JAX
    :308)."""

    config_names = ("dimension", "n_input_dims")

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, x):
        if self.dimension > 0:
            d = self.dimension - 1
            if self.n_input_dims > 0 and x.dim() > self.n_input_dims:
                d += 1
        else:
            d = x.dim() + self.dimension
        return tuple(torch.unbind(x, dim=d))


class BifurcateSplitTable(AbstractModule):
    """x halved along the 1-based ``dimension`` into a 2-entry table
    (JAX :334)."""

    config_names = ("dimension",)

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        d = self.dimension - 1
        if x.shape[d] % 2:
            raise ValueError(f"BifurcateSplitTable: size {x.shape[d]} of "
                             f"dim {self.dimension} is odd")
        return tuple(torch.chunk(x, 2, dim=d))


class NarrowTable(AbstractModule):
    """``length`` table entries from the 1-based ``offset`` (length -1:
    through the end) (JAX :349)."""

    config_names = ("offset", "length")

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset, self.length = offset, length

    def forward(self, xs):
        start = self.offset - 1
        if self.length == -1:
            return tuple(xs[start:])
        return tuple(xs[start:start + self.length])


class Pack(AbstractModule):
    """The table's tensors stacked along a new 1-based ``dim`` (JAX
    :364)."""

    config_names = ("dim",)

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, xs):
        xs = xs if isinstance(xs, (tuple, list)) else (xs,)
        return torch.stack(list(xs), dim=self.dim - 1)


class MixtureTable(AbstractModule):
    """Mixture of experts over the table (gater (B, K), experts): the
    experts a table of K (B, ...) tensors or one (B, K, ...) tensor,
    the output their gater-weighted sum (JAX :377)."""

    def forward(self, xs):
        gater, experts = xs
        if isinstance(experts, (tuple, list)):
            experts = torch.stack(list(experts), dim=1)
        g = gater.reshape(tuple(gater.shape) + (1,) * (experts.dim() - 2))
        return torch.sum(g * experts, dim=1)


__all__ = ["ConcatTable", "ParallelTable", "MapTable", "Bottle", "CAddTable",
           "CSubTable", "CMulTable", "CDivTable", "CMaxTable", "CMinTable",
           "CAveTable", "InTopK", "WhereTable", "JoinTable", "SelectTable",
           "FlattenTable", "MM", "MV", "DotProduct", "CosineDistance",
           "Concat", "SplitTable", "BifurcateSplitTable", "NarrowTable",
           "Pack", "MixtureTable"]
