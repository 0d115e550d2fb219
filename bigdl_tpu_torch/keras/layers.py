"""Keras-1.2.2 layers with shape inference.

Counterpart of ``bigdl_tpu/keras/layers.py``: each layer keeps the
Keras-1.2.2 constructor surface, infers its output shape from its input
shape (batch dim excluded, the reference's ``Shape``) with
``compute_output_shape`` as JAX does, and ``build``s a core module of
the port (``bigdl_tpu_torch.nn``) once the input shape is known.  The
core is built on the host, its weights drawn from
``RandomGenerator.RNG`` in JAX's order; the keras model moves it to its
device.  Image layout is NCHW ("th" dim ordering, the reference's
default).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.nn import layers as L
from bigdl_tpu_torch.nn import module as M
from bigdl_tpu_torch.nn import recurrent as R


__all__ = [
    "KerasLayer", "InputLayer", "Dense", "Activation", "Dropout",
    "Flatten", "Reshape", "Permute", "RepeatVector", "Convolution2D",
    "MaxPooling2D", "AveragePooling2D", "GlobalAveragePooling2D",
    "GlobalMaxPooling2D", "ZeroPadding2D", "BatchNormalization",
    "Embedding", "LSTM", "GRU", "SimpleRNN", "Bidirectional",
    "TimeDistributedDense",
]

_ACTIVATIONS = {
    "relu": L.ReLU,
    "tanh": L.Tanh,
    "sigmoid": L.Sigmoid,
    "hard_sigmoid": L.HardSigmoid,
    "softmax": L.SoftMax,
    "log_softmax": L.LogSoftMax,
    "softplus": L.SoftPlus,
    "softsign": L.SoftSign,
    "elu": L.ELU,
    "linear": M.Identity,
}


def _activation_module(name):
    if name is None or name == "linear":
        return None
    if isinstance(name, str):
        return _ACTIVATIONS[name]()
    return name


class KerasLayer:
    """Base: ``build(input_shape) -> core module`` +
    ``compute_output_shape(input_shape)``; shapes are tuples WITHOUT the
    batch dim (reference Shape semantics)."""

    def __init__(self, input_shape: Optional[Sequence[int]] = None, name=None):
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name
        self.output_shape: Optional[Tuple[int, ...]] = None
        self.core = None

    def build(self, input_shape):
        raise NotImplementedError

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)

    def _built(self, input_shape):
        self.core = self.build(tuple(input_shape))
        if self.name:
            self.core.set_name(self.name)
        self.output_shape = self.compute_output_shape(tuple(input_shape))
        return self.core


class InputLayer(KerasLayer):
    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape, name)

    def build(self, input_shape):
        return M.Identity()


class Dense(KerasLayer):
    """keras.layers.Dense — W x + b with optional activation."""

    def __init__(self, output_dim: int, activation=None, input_dim=None,
                 input_shape=None, b_regularizer=None, W_regularizer=None,
                 bias=True, name=None):
        if input_dim is not None:
            input_shape = (input_dim,)
        super().__init__(input_shape, name)
        self.output_dim = output_dim
        self.activation = activation
        self.bias = bias
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer

    def build(self, input_shape):
        core = M.Sequential()
        core.add(L.Linear(int(input_shape[-1]), self.output_dim,
                          with_bias=self.bias,
                          w_regularizer=self.W_regularizer,
                          b_regularizer=self.b_regularizer))
        act = _activation_module(self.activation)
        if act is not None:
            core.add(act)
        return core

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(KerasLayer):
    def __init__(self, activation: str, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.activation = activation

    def build(self, input_shape):
        return _activation_module(self.activation) or M.Identity()


class Dropout(KerasLayer):
    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def build(self, input_shape):
        return L.Dropout(self.p)


class Flatten(KerasLayer):
    def build(self, input_shape):
        return L.Reshape([int(np.prod(input_shape))], batch_mode=True)

    def compute_output_shape(self, input_shape):
        return (int(np.prod(input_shape)),)


class Reshape(KerasLayer):
    def __init__(self, target_shape, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.target_shape = tuple(target_shape)

    def build(self, input_shape):
        return L.Reshape(list(self.target_shape), batch_mode=True)

    def compute_output_shape(self, input_shape):
        return self.target_shape


class Permute(KerasLayer):
    def __init__(self, dims, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dims = tuple(dims)  # 1-based over non-batch dims (keras)

    def build(self, input_shape):
        # express permutation as a sequence of swaps on 1-based dims
        # counting the batch dim (core Transpose convention)
        perm = [d + 1 for d in self.dims]
        current = list(range(2, len(self.dims) + 2))
        swaps = []
        for i, want in enumerate(perm):
            j = current.index(want)
            if j != i:
                swaps.append((i + 2, j + 2))
                current[i], current[j] = current[j], current[i]
        return L.Transpose(swaps) if swaps else M.Identity()

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[d - 1] for d in self.dims)


class RepeatVector(KerasLayer):
    def __init__(self, n: int, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.n = n

    def build(self, input_shape):
        # dim counts the batch dim (core convention): insert at dim 2
        return L.Replicate(self.n, dim=2)

    def compute_output_shape(self, input_shape):
        return (self.n,) + tuple(input_shape)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Convolution2D(KerasLayer):
    """keras.layers.Convolution2D — NCHW ("th") layout."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode: str = "valid",
                 subsample=(1, 1), input_shape=None, bias=True,
                 W_regularizer=None, b_regularizer=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = _pair(subsample)
        self.bias = bias
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer

    def build(self, input_shape):
        n_in = int(input_shape[0])
        if self.border_mode == "same":
            pw = ph = -1
        else:
            pw = ph = 0
        core = M.Sequential()
        core.add(L.SpatialConvolution(
            n_in, self.nb_filter, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], pw, ph,
            with_bias=self.bias, w_regularizer=self.W_regularizer,
            b_regularizer=self.b_regularizer,
        ))
        act = _activation_module(self.activation)
        if act is not None:
            core.add(act)
        return core

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        sh, sw = self.subsample
        if self.border_mode == "same":
            oh = -(-h // sh)
            ow = -(-w // sw)
        else:
            oh = (h - self.nb_row) // sh + 1
            ow = (w - self.nb_col) // sw + 1
        return (self.nb_filter, oh, ow)


class MaxPooling2D(KerasLayer):
    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides else self.pool_size
        self.border_mode = border_mode

    def _core_cls(self):
        return L.SpatialMaxPooling

    def build(self, input_shape):
        ph, pw = self.pool_size
        sh, sw = self.strides
        if self._core_cls() is L.SpatialMaxPooling:
            return L.SpatialMaxPooling(pw, ph, sw, sh)
        return L.SpatialAveragePooling(pw, ph, sw, sh)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        ph, pw = self.pool_size
        sh, sw = self.strides
        return (c, (h - ph) // sh + 1, (w - pw) // sw + 1)


class AveragePooling2D(MaxPooling2D):
    def _core_cls(self):
        return L.SpatialAveragePooling


class GlobalAveragePooling2D(KerasLayer):
    def build(self, input_shape):
        c, h, w = (int(s) for s in input_shape)
        return M.Sequential() \
            .add(L.SpatialAveragePooling(w, h, 1, 1)) \
            .add(L.Reshape([c], batch_mode=True))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class GlobalMaxPooling2D(KerasLayer):
    def build(self, input_shape):
        c, h, w = (int(s) for s in input_shape)
        return M.Sequential() \
            .add(L.SpatialMaxPooling(w, h, 1, 1)) \
            .add(L.Reshape([c], batch_mode=True))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding=(1, 1), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.padding = _pair(padding)

    def build(self, input_shape):
        ph, pw = self.padding
        return L.SpatialZeroPadding(pw, pw, ph, ph)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c, h + 2 * self.padding[0], w + 2 * self.padding[1])


class BatchNormalization(KerasLayer):
    def __init__(self, epsilon=1e-3, momentum=0.99, axis=1,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.epsilon = epsilon
        self.momentum = momentum
        # keras-1.2.2 "th" models normalize the channel axis (1); any
        # other axis would need a transpose sandwich — reject loudly
        if axis not in (1, -1):
            raise ValueError(f"BatchNormalization axis {axis} unsupported")
        self.axis = axis

    def build(self, input_shape):
        # keras momentum is the running-average keep rate; the core layer
        # uses the update rate
        update = 1.0 - self.momentum
        if len(input_shape) == 3:
            if self.axis == -1:
                raise ValueError(
                    "BatchNormalization axis=-1 on an image tensor "
                    "implies tf dim_ordering — unsupported")
            return L.SpatialBatchNormalization(int(input_shape[0]),
                                               eps=self.epsilon,
                                               momentum=update)
        return L.BatchNormalization(int(input_shape[-1]), eps=self.epsilon,
                                    momentum=update)


class Embedding(KerasLayer):
    def __init__(self, input_dim: int, output_dim: int, input_length=None,
                 input_shape=None, name=None):
        if input_shape is None and input_length is not None:
            input_shape = (input_length,)
        super().__init__(input_shape, name)
        self.input_dim, self.output_dim = input_dim, output_dim

    def build(self, input_shape):
        # keras indices are 0-based; core LookupTable is 1-based
        return M.Sequential() \
            .add(L.AddConstant(1.0)) \
            .add(L.LookupTable(self.input_dim, self.output_dim))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class _KerasRecurrent(KerasLayer):
    cell_cls = None

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid", return_sequences=False,
                 input_shape=None, input_dim=None, input_length=None,
                 stateful=False, go_backwards=False,
                 dropout_W=0.0, dropout_U=0.0,
                 W_regularizer=None, U_regularizer=None, b_regularizer=None,
                 name=None):
        if input_shape is None and input_dim is not None:
            input_shape = (input_length, input_dim)
        super().__init__(input_shape, name)
        if stateful:
            # cross-batch carried state needs a stateful recurrence
            # that Recurrent does not keep; fail loudly rather than
            # silently resetting state every batch
            raise ValueError(
                "stateful=True recurrent layers are not supported: the "
                "recurrence resets state per batch "
                "(Keras-1.2.2 stateful semantics carry it across batches)")
        if dropout_U:
            raise ValueError(
                "dropout_U (recurrent-state dropout) is not supported; "
                "dropout_W maps to the cell's per-gate input dropout")
        self.output_dim = output_dim
        self.activation = activation
        self.inner_activation = inner_activation
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.dropout_W = dropout_W
        self.W_regularizer = W_regularizer
        self.U_regularizer = U_regularizer
        self.b_regularizer = b_regularizer

    def _cell(self, n_in):
        raise NotImplementedError

    def build(self, input_shape):
        n_in = int(input_shape[-1])
        core = M.Sequential()
        if self.go_backwards:
            # Keras-1.2.2 go_backwards: iterate the sequence reversed;
            # returned sequences stay in PROCESSING order (keras does
            # not re-flip them), so one time-axis Reverse before the
            # scan reproduces both return_sequences modes
            from bigdl_tpu_torch.nn.layers_extra import Reverse as _Rev

            core.add(_Rev(2))
        core.add(R.Recurrent().add(self._cell(n_in)))
        if not self.return_sequences:
            core.add(R.Select(2, -1))
        return core

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], self.output_dim)
        return (self.output_dim,)


class LSTM(_KerasRecurrent):
    def _cell(self, n_in):
        return R.LSTM(n_in, self.output_dim, p=self.dropout_W,
                      activation=_activation_module(self.activation),
                      inner_activation=_activation_module(self.inner_activation),
                      w_regularizer=self.W_regularizer,
                      u_regularizer=self.U_regularizer,
                      b_regularizer=self.b_regularizer)


class GRU(_KerasRecurrent):
    def _cell(self, n_in):
        return R.GRU(n_in, self.output_dim, p=self.dropout_W,
                     activation=_activation_module(self.activation),
                     inner_activation=_activation_module(self.inner_activation),
                     w_regularizer=self.W_regularizer,
                     u_regularizer=self.U_regularizer,
                     b_regularizer=self.b_regularizer)


class SimpleRNN(_KerasRecurrent):
    def _cell(self, n_in):
        return R.RnnCell(n_in, self.output_dim,
                         activation=_activation_module(self.activation)
                         or L.Tanh())


class Bidirectional(KerasLayer):
    """keras.layers.wrappers.Bidirectional.

    ``BiRecurrent`` emits the last-dim CONCAT of the forward pass and
    the (re-flipped to input order) backward pass.  Keras semantics:

    * ``return_sequences=False`` takes each direction's FINAL state —
      forward's sits at the last timestep, backward's at the FIRST
      (it consumed the sequence reversed);
    * non-concat ``merge_mode`` (sum/mul/ave) combines the two halves
      elementwise.
    """

    def __init__(self, layer: _KerasRecurrent, merge_mode="concat",
                 input_shape=None, name=None):
        super().__init__(input_shape or layer.input_shape, name)
        if merge_mode not in ("concat", "sum", "mul", "ave"):
            raise ValueError(f"Bidirectional merge_mode {merge_mode!r} "
                             "unsupported")
        if getattr(layer, "go_backwards", False):
            # BiRecurrent drives both directions itself; building from
            # layer._cell would silently ignore the inner flag (which in
            # keras swaps which wrapped copy sees the reversed sequence)
            raise ValueError(
                "Bidirectional(go_backwards=True) unsupported: the "
                "direction pair is already covered by BiRecurrent")
        self.layer = layer
        self.merge_mode = merge_mode

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.table_ops import (
            CAddTable, CMulTable, ConcatTable, JoinTable,
        )

        n_in = int(input_shape[-1])
        H = self.layer.output_dim
        core = M.Sequential()
        core.add(R.BiRecurrent().add(self.layer._cell(n_in)))
        if not self.layer.return_sequences:
            # forward final = last step's first H dims; backward final =
            # FIRST step's last H dims (backward saw the whole sequence
            # there; the last step saw one element)
            fwd = M.Sequential().add(R.Select(2, -1)).add(L.Narrow(2, 1, H))
            bwd = M.Sequential().add(R.Select(2, 1)) \
                .add(L.Narrow(2, H + 1, H))
            core.add(ConcatTable().add(fwd).add(bwd))
            combine_dim = 2
        else:
            if self.merge_mode == "concat":
                return core
            halves = ConcatTable() \
                .add(L.Narrow(3, 1, H)).add(L.Narrow(3, H + 1, H))
            core.add(halves)
            combine_dim = 3
        if self.merge_mode == "concat":
            # n_input_dims == tensor ndim: `combine_dim` is the absolute
            # 1-based axis (the ncf JoinTable(2, 2) convention)
            core.add(JoinTable(combine_dim, combine_dim))
        elif self.merge_mode == "sum":
            core.add(CAddTable())
        elif self.merge_mode == "mul":
            core.add(CMulTable())
        else:  # ave
            core.add(CAddTable()).add(L.MulConstant(0.5))
        return core

    def compute_output_shape(self, input_shape):
        d = self.layer.output_dim * (2 if self.merge_mode == "concat" else 1)
        if self.layer.return_sequences:
            return (input_shape[0], d)
        return (d,)


class TimeDistributedDense(KerasLayer):
    def __init__(self, output_dim: int, activation=None, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.output_dim = output_dim
        self.activation = activation

    def build(self, input_shape):
        inner = M.Sequential().add(L.Linear(int(input_shape[-1]),
                                            self.output_dim))
        act = _activation_module(self.activation)
        if act is not None:
            inner.add(act)
        return R.TimeDistributed(inner)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


# ---------------------------------------------------------------------------
# the rest of the Keras-1.2.2 core vocabulary
# ---------------------------------------------------------------------------


class Convolution1D(KerasLayer):
    """keras.layers.Convolution1D over (steps, dim) inputs."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 input_shape=None, bias=True, W_regularizer=None,
                 b_regularizer=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter, self.filter_length = nb_filter, filter_length
        self.activation = activation
        self.border_mode = border_mode
        self.subsample_length = subsample_length
        self.bias = bias
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer

    def build(self, input_shape):
        dim = int(input_shape[-1])
        core = M.Sequential()
        if self.border_mode == "same":
            k = self.filter_length
            left, right = (k - 1) // 2, k - 1 - (k - 1) // 2
            if left:
                core.add(L.Padding(1, -left, 2))
            if right:
                core.add(L.Padding(1, right, 2))
        core.add(L.TemporalConvolution(
            dim, self.nb_filter, self.filter_length, self.subsample_length,
            with_bias=self.bias))
        act = _activation_module(self.activation)
        if act is not None:
            core.add(act)
        return core

    def compute_output_shape(self, input_shape):
        steps = input_shape[0]
        if self.border_mode == "same":
            out = -(-steps // self.subsample_length)
        else:
            out = (steps - self.filter_length) // self.subsample_length + 1
        return (out, self.nb_filter)


class MaxPooling1D(KerasLayer):
    def __init__(self, pool_length: int = 2, stride=None,
                 border_mode="valid", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool_length = pool_length
        self.stride = stride if stride is not None else pool_length

    def _core(self):
        from bigdl_tpu_torch.nn.layers_extra import TemporalMaxPooling

        return TemporalMaxPooling(self.pool_length, self.stride)

    def build(self, input_shape):
        return self._core()

    def compute_output_shape(self, input_shape):
        steps, dim = input_shape
        return ((steps - self.pool_length) // self.stride + 1, dim)


class AveragePooling1D(MaxPooling1D):
    def _core(self):
        from bigdl_tpu_torch.nn.layers_extra import TemporalAveragePooling

        return TemporalAveragePooling(self.pool_length, self.stride)


class GlobalMaxPooling1D(KerasLayer):
    def build(self, input_shape):
        # L.Max reduces its 1-based dim over the FULL batched tensor:
        # dim 2 is the time axis of (B, T, F)
        return L.Max(2)

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class GlobalAveragePooling1D(KerasLayer):
    def build(self, input_shape):
        return L.Mean(2)

    def compute_output_shape(self, input_shape):
        return (input_shape[-1],)


class AtrousConvolution2D(KerasLayer):
    """keras.layers.AtrousConvolution2D — dilated conv, NCHW layout."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 atrous_rate=(1, 1), activation=None,
                 border_mode: str = "valid", subsample=(1, 1),
                 input_shape=None, bias=True, W_regularizer=None,
                 b_regularizer=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.atrous_rate = _pair(atrous_rate)
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = _pair(subsample)
        self.bias = bias
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer

    def _effective_kernel(self):
        dh, dw = self.atrous_rate
        return (dh * (self.nb_row - 1) + 1, dw * (self.nb_col - 1) + 1)

    def build(self, input_shape):
        n_in = int(input_shape[0])
        eh, ew = self._effective_kernel()
        if self.border_mode == "same":
            ph, pw = (eh - 1) // 2, (ew - 1) // 2
        else:
            ph = pw = 0
        core = M.Sequential()
        core.add(L.SpatialDilatedConvolution(
            n_in, self.nb_filter, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], pw, ph,
            self.atrous_rate[1], self.atrous_rate[0],
            with_bias=self.bias))
        act = _activation_module(self.activation)
        if act is not None:
            core.add(act)
        return core

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        sh, sw = self.subsample
        eh, ew = self._effective_kernel()
        if self.border_mode == "same":
            ph, pw = (eh - 1) // 2, (ew - 1) // 2
        else:
            ph = pw = 0
        return (self.nb_filter,
                (h + 2 * ph - eh) // sh + 1,
                (w + 2 * pw - ew) // sw + 1)


class ZeroPadding1D(KerasLayer):
    def __init__(self, padding: int = 1, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.padding = padding

    def build(self, input_shape):
        p = self.padding
        return M.Sequential().add(L.Padding(1, -p, 2)).add(L.Padding(1, p, 2))

    def compute_output_shape(self, input_shape):
        steps, dim = input_shape
        return (steps + 2 * self.padding, dim)


class ZeroPadding3D(KerasLayer):
    def __init__(self, padding=(1, 1, 1), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.padding = tuple(padding) if not isinstance(padding, int) \
            else (padding,) * 3

    def build(self, input_shape):
        seq = M.Sequential()
        for axis, p in enumerate(self.padding):  # (C, D, H, W): pad D/H/W
            if p:
                seq.add(L.Padding(axis + 2, -p, 4))
                seq.add(L.Padding(axis + 2, p, 4))
        return seq if seq.modules else M.Identity()

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        pd, ph, pw = self.padding
        return (c, d + 2 * pd, h + 2 * ph, w + 2 * pw)


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((0, 0), (0, 0)), input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.cropping = tuple(tuple(c) for c in cropping)

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import Cropping2D as _C2D

        return _C2D(self.cropping[0], self.cropping[1])

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        (t, b), (l, r) = self.cropping
        return (c, h - t - b, w - l - r)


class UpSampling2D(KerasLayer):
    def __init__(self, size=(2, 2), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.size = _pair(size)

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import UpSampling2D as _U2D

        return _U2D(self.size)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c, h * self.size[0], w * self.size[1])


class LeakyReLU(KerasLayer):
    """keras.layers.advanced_activations.LeakyReLU (1.2.2 alpha=0.3)."""

    def __init__(self, alpha: float = 0.3, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.alpha = alpha

    def build(self, input_shape):
        return L.LeakyReLU(self.alpha)


class ELU(KerasLayer):
    def __init__(self, alpha: float = 1.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.alpha = alpha

    def build(self, input_shape):
        return L.ELU(self.alpha)


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta: float = 1.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.theta = theta

    def build(self, input_shape):
        return L.Threshold(self.theta, 0.0)


class Masking(KerasLayer):
    def __init__(self, mask_value: float = 0.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.mask_value = mask_value

    def build(self, input_shape):
        return L.Masking(self.mask_value)


class GaussianNoise(KerasLayer):
    def __init__(self, sigma: float = 0.1, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.sigma = sigma

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import GaussianNoise as _GN

        return _GN(self.sigma)


class GaussianDropout(KerasLayer):
    def __init__(self, p: float = 0.5, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import GaussianDropout as _GD

        return _GD(self.p)


class MaxoutDense(KerasLayer):
    """keras.layers.MaxoutDense — max over nb_feature affine pieces."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.output_dim = output_dim
        self.nb_feature = nb_feature

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import Maxout as _MX

        return _MX(int(input_shape[-1]), self.output_dim, self.nb_feature)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


def _triple(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


class Convolution3D(KerasLayer):
    """keras.layers.Convolution3D — NCDHW ("th") layout; kernel_dim1/2/3
    map to the volumetric (T, H, W) axes."""

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, activation=None,
                 border_mode: str = "valid", subsample=(1, 1, 1),
                 input_shape=None, bias=True, name=None):
        super().__init__(input_shape, name)
        self.nb_filter = nb_filter
        self.kdims = (kernel_dim1, kernel_dim2, kernel_dim3)
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = _triple(subsample)
        self.bias = bias

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.volumetric import VolumetricConvolution

        n_in = int(input_shape[0])
        pad = -1 if self.border_mode == "same" else 0
        k1, k2, k3 = self.kdims
        s1, s2, s3 = self.subsample
        core = M.Sequential()
        core.add(VolumetricConvolution(
            n_in, self.nb_filter, k1, k3, k2, s1, s3, s2,
            pad, pad, pad, with_bias=self.bias,
        ))
        act = _activation_module(self.activation)
        if act is not None:
            core.add(act)
        return core

    def compute_output_shape(self, input_shape):
        _, d1, d2, d3 = input_shape
        dims = []
        for size, k, s in zip((d1, d2, d3), self.kdims, self.subsample):
            if self.border_mode == "same":
                dims.append(-(-size // s))
            else:
                dims.append((size - k) // s + 1)
        return (self.nb_filter,) + tuple(dims)


class MaxPooling3D(KerasLayer):
    """keras.layers.MaxPooling3D — NCDHW."""

    _pool_cls_name = "VolumetricMaxPooling"

    def __init__(self, pool_size=(2, 2, 2), strides=None,
                 border_mode: str = "valid", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool_size = _triple(pool_size)
        self.strides = _triple(strides) if strides else self.pool_size
        self.border_mode = border_mode

    def build(self, input_shape):
        import bigdl_tpu_torch.nn.volumetric as V

        cls = getattr(V, self._pool_cls_name)
        k1, k2, k3 = self.pool_size
        s1, s2, s3 = self.strides
        pad = -1 if self.border_mode == "same" else 0
        return cls(k1, k3, k2, s1, s3, s2, pad, pad, pad)

    def compute_output_shape(self, input_shape):
        c = input_shape[0]
        dims = []
        for size, k, s in zip(input_shape[1:], self.pool_size,
                              self.strides):
            if self.border_mode == "same":
                dims.append(-(-size // s))
            else:
                dims.append((size - k) // s + 1)
        return (c,) + tuple(dims)


class AveragePooling3D(MaxPooling3D):
    _pool_cls_name = "VolumetricAveragePooling"


class Highway(KerasLayer):
    """keras.layers.core.Highway — gated identity-skip dense block."""

    def __init__(self, activation=None, input_shape=None, bias=True,
                 name=None):
        super().__init__(input_shape, name)
        self.activation = activation
        self.bias = bias

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import Highway as _HW

        return _HW(int(input_shape[-1]), with_bias=self.bias,
                   activation=_activation_module(self.activation))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


__all__ += [
    "Convolution1D", "MaxPooling1D", "AveragePooling1D",
    "GlobalMaxPooling1D", "GlobalAveragePooling1D", "AtrousConvolution2D",
    "ZeroPadding1D", "ZeroPadding3D", "Cropping2D", "UpSampling2D",
    "LeakyReLU", "ELU", "ThresholdedReLU", "Masking",
    "GaussianNoise", "GaussianDropout", "MaxoutDense",
    "Convolution3D", "MaxPooling3D", "AveragePooling3D", "Highway",
]
