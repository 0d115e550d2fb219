"""Sparse tensors and the sparse layers of the port: Wide & Deep's
inputs.

Counterpart of ``bigdl_tpu/nn/sparse.py``.  ``SparseTensor`` is a
host-side COO facade on numpy (0-based indices, as JAX's), with
``narrow``, ``concat``, ``t``, ``add`` and ``to_padded``, the fixed-slot
batch encoding.  Its arrays are held as JAX holds them (64-bit values
and indices narrowed to 32 bits), so both packages' results are the
same bits.  JAX's ``to_bcoo`` has no counterpart in a package without
JAX: ``to_torch()`` gives a ``torch.sparse_coo_tensor`` in its place.

The compute is a gather and a segment sum: ``jax.ops.segment_sum``
becomes ``index_add_``, whose CUDA atomics add in no fixed order (a
card run is held to the CPU within a limit, not bit for bit).
``LookupTableSparse``'s padded (B, S) path, the one Wide & Deep trains
through, sums each row's slots in order and has no atomics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.layers import RandomNormal, Xavier
from bigdl_tpu_torch.nn.module import AbstractModule

# JAX without x64 narrows 64-bit arrays to these
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.astype(_NARROW[a.dtype]) if a.dtype in _NARROW else a


def _segment_sum(values: torch.Tensor, rows: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ``values``' rows summed into ``n``
    segments by ``rows``."""
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return out.index_add(0, rows, values)


class SparseTensor:
    """COO sparse tensor: ``indices`` (nnz, ndim) int32, ``values``
    (nnz,) and the dense ``shape``, on the host (JAX :31).  Indices are
    0-based."""

    def __init__(self, indices, values, shape: Tuple[int, ...]):
        self.indices = _host(indices).astype(np.int32)
        if self.indices.ndim != 2:
            raise ValueError("indices must be (nnz, ndim)")
        self.values = _host(values)
        self.shape = tuple(int(s) for s in shape)
        if self.indices.shape[1] != len(self.shape):
            raise ValueError("indices ndim != shape ndim")

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @staticmethod
    def from_dense(dense) -> "SparseTensor":
        d = _host(dense)
        idx = np.argwhere(d != 0)
        return SparseTensor(idx, d[tuple(idx.T)], d.shape)

    def to_dense(self) -> torch.Tensor:
        """The dense tensor, duplicates summed."""
        values = torch.from_numpy(self.values)
        idx = tuple(torch.from_numpy(self.indices.T.astype(np.int64)))
        return values.new_zeros(self.shape).index_put(idx, values,
                                                      accumulate=True)

    def to_torch(self) -> torch.Tensor:
        """A ``torch.sparse_coo_tensor`` of the same entries: the port's
        stand-in for JAX's ``to_bcoo`` (a ``jax.experimental.sparse``
        BCOO), for torch's sparse algebra."""
        return torch.sparse_coo_tensor(
            torch.from_numpy(self.indices.T.astype(np.int64)),
            torch.from_numpy(self.values), self.shape,
            check_invariants=True)

    def narrow(self, dim: int, start: int, length: int) -> "SparseTensor":
        """The 0-based slice [start, start + length) along ``dim`` (its
        nnz depends on the data: a host op)."""
        keep = (self.indices[:, dim] >= start) & (
            self.indices[:, dim] < start + length)
        out_idx = self.indices[keep].copy()
        out_idx[:, dim] -= start
        shape = list(self.shape)
        shape[dim] = length
        return SparseTensor(out_idx, self.values[keep], tuple(shape))

    @staticmethod
    def concat(dim: int, tensors: Sequence["SparseTensor"]) -> "SparseTensor":
        """The tensors joined along 0-based ``dim``."""
        offset = 0
        idx_parts, val_parts = [], []
        out_shape = list(tensors[0].shape)
        out_shape[dim] = 0
        for t in tensors:
            idx = t.indices.copy()
            idx[:, dim] += offset
            idx_parts.append(idx)
            val_parts.append(t.values)
            offset += t.shape[dim]
            out_shape[dim] += t.shape[dim]
        return SparseTensor(np.concatenate(idx_parts, 0),
                            np.concatenate(val_parts, 0), tuple(out_shape))

    def t(self) -> "SparseTensor":
        """The 2-D transpose (the indices' columns swapped)."""
        if self.ndim != 2:
            raise ValueError("t() needs a 2-D SparseTensor")
        return SparseTensor(self.indices[:, ::-1].copy(), self.values,
                            (self.shape[1], self.shape[0]))

    def mul(self, scalar) -> "SparseTensor":
        return SparseTensor(self.indices, self.values * scalar, self.shape)

    def add(self, other: "SparseTensor") -> "SparseTensor":
        """The union of both tensors' entries (duplicates add when
        densified, as COO does)."""
        if self.shape != other.shape:
            raise ValueError("shape mismatch")
        return SparseTensor(np.concatenate([self.indices, other.indices], 0),
                            np.concatenate([self.values, other.values], 0),
                            self.shape)

    def to_padded(self, max_per_row: int):
        """(B, vocab) COO rows -> the fixed-slot ``(ids, weights)`` arrays
        of shape (B, max_per_row) (JAX :136): ids 1-based int32 with 0
        the padding (the column + 1), the weights the values."""
        B = self.shape[0]
        ids = np.zeros((B, max_per_row), np.int32)
        wts = np.zeros((B, max_per_row), np.float32)
        fill = np.zeros(B, np.int64)
        for (r, c), v in zip(self.indices, self.values):
            if fill[r] >= max_per_row:
                raise ValueError(
                    f"row {r} has more than {max_per_row} entries")
            ids[r, fill[r]] = c + 1
            wts[r, fill[r]] = v
            fill[r] += 1
        return ids, wts

    def __repr__(self):
        return f"SparseTensor(shape={self.shape}, nnz={self.nnz})"


def _coo(sparse: SparseTensor, like: torch.Tensor):
    """(rows, cols, values) of a 2-D sparse tensor on ``like``'s device,
    the values in its dtype."""
    idx = torch.from_numpy(sparse.indices.astype(np.int64)).to(like.device)
    vals = torch.from_numpy(sparse.values).to(device=like.device,
                                              dtype=like.dtype)
    return idx[:, 0], idx[:, 1], vals


class SparseTensorMath:
    """BLAS-style entry points over a COO operand and dense tensors
    (JAX :161): a gather of the dense rows, then a segment sum."""

    @staticmethod
    def mm(sparse: SparseTensor, dense: torch.Tensor) -> torch.Tensor:
        """sparse (m, k) @ dense (k, n) -> dense (m, n)."""
        rows, cols, vals = _coo(sparse, dense)
        return _segment_sum(dense[cols] * vals[:, None], rows,
                            sparse.shape[0])

    @staticmethod
    def addmm(beta, mat, alpha, sparse: SparseTensor, dense):
        """beta · mat + alpha · (sparse @ dense)."""
        return beta * mat + alpha * SparseTensorMath.mm(sparse, dense)

    @staticmethod
    def mv(sparse: SparseTensor, vec: torch.Tensor) -> torch.Tensor:
        """sparse (m, k) @ vec (k,) -> dense (m,)."""
        rows, cols, vals = _coo(sparse, vec)
        return _segment_sum(vec[cols] * vals, rows, sparse.shape[0])

    @staticmethod
    def addmv(beta, vec_out, alpha, sparse: SparseTensor, vec):
        """beta · vec_out + alpha · (sparse @ vec)."""
        return beta * vec_out + alpha * SparseTensorMath.mv(sparse, vec)

    @staticmethod
    def vdot(a: SparseTensor, b: torch.Tensor) -> torch.Tensor:
        """<a, b> of a sparse and a dense tensor of one shape."""
        idx = tuple(torch.from_numpy(a.indices.T.astype(np.int64)).to(
            b.device))
        vals = torch.from_numpy(a.values).to(device=b.device, dtype=b.dtype)
        return torch.sum(b[idx] * vals)


class SparseLinear(AbstractModule):
    """``Linear`` over a sparse 2-D input (JAX :205): y = A W^T + b as
    a gather of W's columns and a segment sum; a dense input is a plain
    matmul.  The weight is Xavier's (out, in)."""

    config_names = ("input_size", "output_size", "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, backward_start: int = -1,
                 backward_length: int = -1, w_regularizer=None,
                 b_regularizer=None):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        self._set_regularizers((("w_regularizer", w_regularizer, ("weight",)),
                                ("b_regularizer", b_regularizer, ("bias",))))
        self._set_param("weight", Xavier().init(
            (output_size, input_size), input_size, output_size))
        self._set_param("bias", np.zeros(output_size, np.float32)
                        if with_bias else None)

    def forward(self, x):
        w = self.weight
        if isinstance(x, SparseTensor):
            rows, cols, vals = _coo(x, w)
            y = _segment_sum(w.t()[cols] * vals[:, None], rows, x.shape[0])
        else:
            y = x @ w.t()
        if self.bias is not None:
            y = y + self.bias
        return y


class LookupTableSparse(AbstractModule):
    """Embedding bag (JAX :258): each row's ids looked up and combined
    by ``combiner`` (sum, mean, sqrtn), with optional per-id weights and
    a ``max_norm`` (> 0) rescale of each looked-up row.

    - Padded path (JAX :296-317), the one Wide & Deep trains through:
      ids a dense (B, S) matrix of 1-based ids (floats allowed), 0 the
      padding; row ``max(id − 1, 0)`` is read and masked by ``id > 0``
      (id 0 does not read the last row, unlike ``LookupTable``).
    - COO path (JAX :318-346): ids a ``SparseTensor`` whose values are
      the 1-based ids; the segment sum is ``index_add``.

    The spec is JAX's, which leaves ``max_norm`` out."""

    config_names = ("n_index", "n_output", "combiner")

    param_names = ("weight",)

    def __init__(self, n_index: int, n_output: int, combiner: str = "sum",
                 max_norm: float = -1.0, w_regularizer=None):
        super().__init__()
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError("combiner must be sum|mean|sqrtn")
        self.n_index, self.n_output = n_index, n_output
        self.combiner = combiner
        self.max_norm = max_norm
        self._set_regularizers((("w_regularizer", w_regularizer,
                                 ("weight",)),))
        self._set_param("weight", RandomNormal(0.0, 1.0).init(
            (n_index, n_output), n_index, n_output))

    def _renorm(self, emb):
        if self.max_norm > 0:
            norms = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            emb = emb * torch.clamp_max(self.max_norm / (norms + 1e-12), 1.0)
        return emb

    def forward(self, x):
        ids, weights = x if isinstance(x, (tuple, list)) else (x, None)
        if not isinstance(ids, SparseTensor):
            return self._padded(ids, weights)
        return self._coo(ids, weights)

    def _padded(self, ids, weights):
        if ids.dim() != 2:
            raise TypeError("LookupTableSparse expects a SparseTensor or a "
                            "padded (B, S) id matrix")
        idx = torch.clamp_min(ids.to(torch.int32).long() - 1, 0)
        emb = self._renorm(self.weight[idx])                # (B, S, D)
        mask = (ids > 0).to(emb.dtype)
        w = mask if weights is None else weights.to(emb.dtype) * mask
        summed = torch.sum(emb * w[..., None], dim=1)
        if self.combiner == "sum":
            return summed
        if self.combiner == "mean":
            return summed / torch.clamp_min(torch.sum(w, dim=1), 1e-12)[:,
                                                                        None]
        return summed / torch.sqrt(torch.clamp_min(
            torch.sum(w * w, dim=1), 1e-12))[:, None]

    def _coo(self, ids: SparseTensor, weights):
        dev = self.weight.device
        rows = torch.from_numpy(ids.indices[:, 0].astype(np.int64)).to(dev)
        emb_ids = torch.from_numpy(ids.values.astype(np.int32).astype(
            np.int64) - 1).to(dev)
        emb = self._renorm(self.weight[emb_ids])
        w = None
        if weights is not None:
            wv = weights.values if isinstance(weights, SparseTensor) \
                else weights
            w = torch.as_tensor(_host(wv) if not isinstance(
                wv, torch.Tensor) else wv).to(device=dev, dtype=emb.dtype)
            emb = emb * w[:, None]
        batch = ids.shape[0]
        summed = _segment_sum(emb, rows, batch)
        if self.combiner == "sum":
            return summed
        ones = torch.ones_like(rows, dtype=summed.dtype)
        if self.combiner == "mean":
            counts = _segment_sum(ones if w is None else w, rows, batch)
            return summed / torch.clamp_min(counts, 1e-12)[:, None]
        sq = _segment_sum(ones if w is None else w * w, rows, batch)
        return summed / torch.sqrt(torch.clamp_min(sq, 1e-12))[:, None]


class SparseJoinTable(AbstractModule):
    """Join sparse tensors along 1-based ``dimension`` (JAX :355)."""

    config_names = ("dimension",)

    def __init__(self, dimension: int = 2):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return SparseTensor.concat(self.dimension - 1, list(x))


__all__ = ["SparseTensor", "SparseTensorMath", "SparseLinear",
           "LookupTableSparse", "SparseJoinTable"]
