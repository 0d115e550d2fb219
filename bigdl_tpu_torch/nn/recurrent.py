"""The recurrent stack: cells, the time loop and its wrappers.

Counterpart of ``bigdl_tpu/nn/recurrent.py``: ``_gate_dropout`` (:43),
``Cell`` (:58), ``RnnCell`` (:126), ``LSTM`` (:157), ``LSTMPeephole``
(:228), ``GRU`` (:278), ``Recurrent`` (:348), ``BiRecurrent`` (:378),
``TimeDistributed`` (:421), ``Select`` (:440) and ``MultiRNNCell``
(:456).  Input is batch-first, (B, T, F).

The structure is the JAX package's: the input projection of every
timestep is one hoisted (B·T, in) × (in, G·H) matmul, then a loop over
T runs the small recurrent matmul and the gate elementwise ops of each
step (JAX ``lax.scan``; here a Python loop that autograd
differentiates).  The weights keep JAX's layout and names (gates packed
(i, f, g, o) into ``w`` (in, 4H), ``u`` (H, 4H) and ``b`` (4H) for the
LSTM), so JAX parameter trees load with no transpose, and ``Recurrent``
nests its cell under ``"0"`` as JAX's ``Container`` does.

Per-gate input dropout takes the step's seed (``forward(x, rng_seed)``,
the port's counterpart of the JAX ``rng`` key): G independent masks
from one ``torch.Generator`` seeded with it, other bits than JAX's.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import RandomGenerator, fold_in
from bigdl_tpu_torch.nn.layers import Sigmoid, Tanh
from bigdl_tpu_torch.nn.module import AbstractModule, Container


def _gate_dropout(x, n_gates: int, p: float, training: bool,
                  seed: Optional[int]):
    """(n_gates, B, T, in): x under n_gates independent inverted-dropout
    masks, or None when dropout is off (the plain ``x @ w`` path)."""
    if p <= 0.0 or not training or seed is None:
        return None
    keep = 1.0 - p
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    masks = torch.rand((n_gates,) + tuple(x.shape), generator=gen,
                       device=x.device) < keep
    return torch.where(masks, x[None], torch.zeros_like(x)) / keep


def _uniform(shape, stdv):
    return RandomGenerator.RNG.uniform(-stdv, stdv, size=shape).astype(
        np.float32)


def _gated_projection(x, w, b, n_gates, hidden, dropped):
    """``x @ w + b``, or its per-gate-masked form when dropout is on;
    w is (in, n_gates·H)."""
    if dropped is None:
        return x @ w + b
    wg = w.reshape(w.shape[0], n_gates, hidden)
    proj = torch.einsum("gbti,igh->btgh", dropped, wg)
    return proj.reshape(x.shape[0], x.shape[1], n_gates * hidden) + b


class Cell(AbstractModule):
    """Base recurrent cell.  Subclasses define ``precompute`` ((B, T,
    in) -> (B, T, G·H), the hoisted input projection with its dropout),
    ``step`` ((carry, proj_t) -> (carry, output_t)) and ``init_carry``.
    Called alone, a cell runs one timestep of (B, in) input."""

    hidden_size: int = 0
    takes_rng_seed = True

    def precompute(self, x, rng_seed=None):
        raise NotImplementedError

    def step(self, carry, proj_t):
        raise NotImplementedError

    def init_carry(self, batch: int, dtype, device, input_shape=None):
        raise NotImplementedError

    def run_sequence(self, x, rng_seed: Optional[int] = None):
        """(B, T, ...) -> (B, T, ...): the hoisted projection, then the
        loop over T."""
        proj = self.precompute(x, rng_seed)
        carry = self.init_carry(x.shape[0], x.dtype, x.device, x.shape)
        ys = []
        # unbind, not proj[:, t]: its backward stacks the T gradients
        # once, where T selects would each scatter into a zero (B, T, G·H)
        for proj_t in torch.unbind(proj, dim=1):
            carry, y = self.step(carry, proj_t)
            ys.append(y)
        return torch.stack(ys, dim=1)

    def forward(self, x, rng_seed: Optional[int] = None):
        proj = self.precompute(x[:, None], rng_seed)[:, 0]
        carry = self.init_carry(x.shape[0], x.dtype, x.device,
                                x[:, None].shape)
        return self.step(carry, proj)[1]


class RnnCell(Cell):
    """``h' = act(x w + b + h u)`` (JAX :126)."""

    param_names = ("w", "u", "b")
    config_names = ("input_size", "hidden_size")

    def __init__(self, input_size: int, hidden_size: int, activation=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation or Tanh()
        self.reset()

    def reset(self):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        self._set_param("w", _uniform((self.input_size, self.hidden_size),
                                      stdv))
        self._set_param("u", _uniform((self.hidden_size, self.hidden_size),
                                      stdv))
        self._set_param("b", np.zeros(self.hidden_size, np.float32))
        return self

    def precompute(self, x, rng_seed=None):
        return x @ self.w + self.b

    def init_carry(self, batch, dtype, device, input_shape=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)

    def step(self, carry, proj_t):
        h = self.activation(proj_t + carry @ self.u)
        return h, h


class LSTM(Cell):
    """LSTM with the gates packed (i, f, g, o) (JAX :157): ``p`` is the
    per-gate input dropout, ``activation`` the candidate and output
    nonlinearity (Tanh), ``inner_activation`` the gates' (Sigmoid)."""

    param_names = ("w", "u", "b")
    config_names = ("input_size", "hidden_size", "p")
    n_gates = 4

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation=None, inner_activation=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p
        self.activation = activation or Tanh()
        self.inner_activation = inner_activation or Sigmoid()
        self.reset()

    def reset(self):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        h4 = 4 * self.hidden_size
        self._set_param("w", _uniform((self.input_size, h4), stdv))
        self._set_param("u", _uniform((self.hidden_size, h4), stdv))
        self._set_param("b", np.zeros(h4, np.float32))
        return self

    def precompute(self, x, rng_seed=None):
        dropped = _gate_dropout(x, self.n_gates, self.p, self.training,
                                rng_seed)
        return _gated_projection(x, self.w, self.b, self.n_gates,
                                 self.hidden_size, dropped)

    def init_carry(self, batch, dtype, device, input_shape=None):
        z = torch.zeros((batch, self.hidden_size), dtype=dtype,
                        device=device)
        return (z, z)

    def step(self, carry, proj_t):
        h, c = carry
        i, f, g, o = torch.chunk(proj_t + h @ self.u, 4, dim=-1)
        act, inner = self.activation, self.inner_activation
        c_new = inner(f) * c + inner(i) * act(g)
        h_new = inner(o) * act(c_new)
        return (h_new, c_new), h_new

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class LSTMPeephole(Cell):
    """LSTM with diagonal peepholes from the cell state into the i, f
    and o gates (JAX :228)."""

    param_names = ("w", "u", "b", "p_i", "p_f", "p_o")
    config_names = ("input_size", "hidden_size", "p")
    n_gates = 4

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p
        self.reset()

    def reset(self):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        h, h4 = self.hidden_size, 4 * self.hidden_size
        self._set_param("w", _uniform((self.input_size, h4), stdv))
        self._set_param("u", _uniform((h, h4), stdv))
        self._set_param("b", np.zeros(h4, np.float32))
        for name in ("p_i", "p_f", "p_o"):
            self._set_param(name, _uniform((h,), stdv))
        return self

    precompute = LSTM.precompute
    init_carry = LSTM.init_carry

    def step(self, carry, proj_t):
        h, c = carry
        i, f, g, o = torch.chunk(proj_t + h @ self.u, 4, dim=-1)
        i = torch.sigmoid(i + self.p_i * c)
        f = torch.sigmoid(f + self.p_f * c)
        c_new = f * c + i * torch.tanh(g)
        o = torch.sigmoid(o + self.p_o * c_new)
        h_new = o * torch.tanh(c_new)
        return (h_new, c_new), h_new


class GRU(Cell):
    """GRU with the (r, z) gates packed and a separate candidate (JAX
    :278); ``p`` is the per-gate input dropout over its three inputs."""

    param_names = ("w_rz", "u_rz", "b_rz", "w_h", "u_h", "b_h")
    config_names = ("input_size", "hidden_size", "p")

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation=None, inner_activation=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p
        self.activation = activation or Tanh()
        self.inner_activation = inner_activation or Sigmoid()
        self.reset()

    def reset(self):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        n_in, h = self.input_size, self.hidden_size
        self._set_param("w_rz", _uniform((n_in, 2 * h), stdv))
        self._set_param("u_rz", _uniform((h, 2 * h), stdv))
        self._set_param("b_rz", np.zeros(2 * h, np.float32))
        self._set_param("w_h", _uniform((n_in, h), stdv))
        self._set_param("u_h", _uniform((h, h), stdv))
        self._set_param("b_h", np.zeros(h, np.float32))
        return self

    def precompute(self, x, rng_seed=None):
        dropped = _gate_dropout(x, 3, self.p, self.training, rng_seed)
        if dropped is None:
            rz = x @ self.w_rz + self.b_rz
            hcand = x @ self.w_h + self.b_h
        else:
            rz = _gated_projection(x, self.w_rz, self.b_rz, 2,
                                   self.hidden_size, dropped[:2])
            hcand = dropped[2] @ self.w_h + self.b_h
        return torch.cat([rz, hcand], dim=-1)

    def init_carry(self, batch, dtype, device, input_shape=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)

    def step(self, carry, proj_t):
        h, hs = carry, self.hidden_size
        rz = proj_t[..., :2 * hs] + h @ self.u_rz
        r, z = torch.chunk(self.inner_activation(rz), 2, dim=-1)
        cand = self.activation(proj_t[..., 2 * hs:] + (r * h) @ self.u_h)
        h_new = (1 - z) * cand + z * h
        return h_new, h_new

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class Recurrent(Container):
    """Runs one cell over time: (B, T, in) -> (B, T, H) (JAX :348)."""

    takes_rng_seed = True

    def add(self, cell: Cell):
        if len(self._modules) > 0:
            raise ValueError("Recurrent takes exactly one Cell")
        if not isinstance(cell, Cell):
            raise TypeError("Recurrent.add expects a recurrent Cell")
        return super().add(cell)

    @property
    def cell(self) -> Cell:
        return self._modules["0"]

    def forward(self, x, rng_seed: Optional[int] = None):
        return self.cell.run_sequence(x, rng_seed)


class BiRecurrent(Container):
    """A forward and a time-reversed copy of one cell, the reverse one
    drawn anew (JAX :378); the outputs are concatenated on the feature
    dim, or given as a pair to ``merge`` (a table module)."""

    takes_rng_seed = True

    def __init__(self, merge=None):
        super().__init__()
        # kept off the module tree: the parameter tree is {"0", "1"}, as
        # JAX's
        object.__setattr__(self, "merge", merge)

    def add(self, cell: Cell):
        if len(self._modules) > 0:
            raise ValueError("BiRecurrent takes exactly one Cell")
        bwd_cell = copy.deepcopy(cell)
        fwd = Recurrent().add(cell)
        bwd = Recurrent().add(bwd_cell.reset())
        super().add(fwd)
        return super().add(bwd)

    def forward(self, x, rng_seed: Optional[int] = None):
        seeds = (None, None) if rng_seed is None else (
            fold_in(rng_seed, 0), fold_in(rng_seed, 1))
        fwd_out = self._modules["0"](x, rng_seed=seeds[0])
        bwd_out = torch.flip(self._modules["1"](torch.flip(x, [1]),
                                                rng_seed=seeds[1]), [1])
        if self.merge is None:
            return torch.cat([fwd_out, bwd_out], dim=-1)
        return self.merge((fwd_out, bwd_out))


class TimeDistributed(Container):
    """Folds time into the batch, applies the wrapped layer, unfolds
    (JAX :421)."""

    def __init__(self, layer: Optional[AbstractModule] = None):
        super().__init__()
        if layer is not None:
            self.add(layer)

    @property
    def takes_rng_seed(self) -> bool:
        return self._modules["0"].takes_rng_seed

    def forward(self, x, rng_seed: Optional[int] = None):
        b, t = x.shape[0], x.shape[1]
        layer = self._modules["0"]
        merged = x.reshape((b * t,) + tuple(x.shape[2:]))
        y = layer(merged, rng_seed=rng_seed) if layer.takes_rng_seed \
            else layer(merged)
        return y.reshape((b, t) + tuple(y.shape[1:]))


class Select(AbstractModule):
    """One 1-based ``index`` along the 1-based ``dim``; negative values
    count from the end (``Select(2, -1)``: the last timestep) (JAX
    :440)."""

    config_names = ("dim", "index")

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def forward(self, x):
        d = self.dim - 1 if self.dim > 0 else x.dim() + self.dim
        i = self.index - 1 if self.index > 0 else x.shape[d] + self.index
        return x.select(d, i)


class MultiRNNCell(Cell, Container):
    """A vertical stack of cells run as one (JAX :456): cell k's output
    feeds cell k+1 at the same timestep, so the stack runs as one loop
    per cell in turn, each with its own hoisted projection and dropout
    seed ``fold_in(rng_seed, k)``.  Parameters nest by position."""

    def __init__(self, cells=None):
        super().__init__()
        for c in (cells or []):
            self.add(c)

    def add(self, cell):
        if not isinstance(cell, Cell):
            raise TypeError("MultiRNNCell takes recurrent Cells")
        return Container.add(self, cell)

    @property
    def cells(self):
        return list(self._modules.values())

    @property
    def hidden_size(self):
        cells = self.cells
        return cells[-1].hidden_size if cells else 0

    def _seeds(self, rng_seed):
        return [None if rng_seed is None else fold_in(rng_seed, i)
                for i in range(len(self._modules))]

    def run_sequence(self, x, rng_seed: Optional[int] = None):
        y = x
        for c, seed in zip(self.cells, self._seeds(rng_seed)):
            y = c.run_sequence(y, seed)
        return y

    def forward(self, x, rng_seed: Optional[int] = None):
        y = x
        for c, seed in zip(self.cells, self._seeds(rng_seed)):
            y = c(y, rng_seed=seed)
        return y

    def init_carry(self, batch, dtype, device, input_shape=None):
        return tuple(c.init_carry(batch, dtype, device, input_shape)
                     for c in self.cells)

    def precompute(self, x, rng_seed=None):
        raise NotImplementedError(
            "MultiRNNCell runs whole sub-cell loops (run_sequence); it has "
            "no single hoisted projection")

    def step(self, carry, proj_t):
        raise NotImplementedError(
            "MultiRNNCell runs whole sub-cell loops (run_sequence)")


__all__ = ["Cell", "RnnCell", "LSTM", "LSTMPeephole", "GRU", "Recurrent",
           "BiRecurrent", "TimeDistributed", "Select", "MultiRNNCell"]
