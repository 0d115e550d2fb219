"""Keras-1.2.2 model importer: JSON configs and HDF5 weights.

Counterpart of ``bigdl_tpu/keras/converter.py``: ``model_from_json``
takes ``Sequential`` configs (a list of layer configs, optionally
headed by a ``Merge`` of Sequential branches) and functional ``Model``
configs (layers and inbound nodes wired into a ``Graph``), and
``load_weights_hdf5`` copies the weights of a Keras-1.2.2
``save_weights`` HDF5 file by layer name (Dense, the convolutions,
BatchNormalization, Embedding, Highway, and the recurrent cells with
their gate orders).  Both entry points take ``device=`` (the card
unless the caller asks for the CPU).  ``h5py`` is imported only by
``load_weights_hdf5``.

Keras dim ordering: the reference targets "th" (NCHW) ordering, which is
also the port's layout; "tf"-ordered convolution configs are refused.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.keras import layers as KL
from bigdl_tpu_torch.keras import models as KM


__all__ = [
    "KerasConversionException", "model_from_json",
    "model_from_json_path", "load_weights_hdf5",
]

class KerasConversionException(Exception):
    pass


def _tuple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _regularizer(spec):
    """Keras-1.2.2 regularizer config -> L1L2Regularizer.
    ``{"name": "WeightRegularizer"/"ActivityRegularizer", "l1": x,
    "l2": y}`` (activity regularizers have no analogue and are
    rejected)."""
    if not spec:
        return None
    from bigdl_tpu_torch.optim.regularizer import L1L2Regularizer

    name = spec.get("name", "WeightRegularizer")
    if "Activity" in name:
        raise KerasConversionException(
            "ActivityRegularizer has no bigdl analogue")
    return L1L2Regularizer(float(spec.get("l1", 0.0)),
                           float(spec.get("l2", 0.0)))


def _strip_batch(shape):
    if shape is None:
        return None
    return tuple(int(s) for s in shape[1:])


def _build_layer(class_name: str, cfg: dict) -> Optional[KL.KerasLayer]:
    """One Keras-1.2.2 layer config -> a keras-surface layer (or None for
    layers that vanish, e.g. InputLayer handled by the caller)."""
    name = cfg.get("name")
    input_shape = _strip_batch(cfg.get("batch_input_shape"))

    if class_name in ("InputLayer",):
        return KL.InputLayer(input_shape=input_shape, name=name)
    if class_name == "Dense":
        return KL.Dense(
            cfg["output_dim"],
            activation=cfg.get("activation"),
            input_shape=input_shape,
            bias=cfg.get("bias", True),
            W_regularizer=_regularizer(cfg.get("W_regularizer")),
            b_regularizer=_regularizer(cfg.get("b_regularizer")),
            name=name,
        )
    if class_name == "Activation":
        return KL.Activation(cfg["activation"], input_shape=input_shape,
                             name=name)
    if class_name == "Dropout":
        return KL.Dropout(cfg.get("p", 0.5), name=name)
    if class_name == "Flatten":
        return KL.Flatten(input_shape=input_shape, name=name)
    if class_name == "Reshape":
        return KL.Reshape(_tuple(cfg["target_shape"]),
                          input_shape=input_shape, name=name)
    if class_name == "Permute":
        return KL.Permute(_tuple(cfg["dims"]), input_shape=input_shape,
                          name=name)
    if class_name == "RepeatVector":
        return KL.RepeatVector(cfg["n"], input_shape=input_shape, name=name)
    if class_name == "Convolution2D":
        if cfg.get("dim_ordering", "th") == "tf":
            raise KerasConversionException(
                "tf dim_ordering Convolution2D configs are not supported; "
                "re-save the model with dim_ordering='th'"
            )
        sub = _tuple(cfg.get("subsample", (1, 1)))
        return KL.Convolution2D(
            cfg["nb_filter"], cfg["nb_row"], cfg["nb_col"],
            activation=cfg.get("activation"),
            border_mode=cfg.get("border_mode", "valid"),
            subsample=sub,
            input_shape=input_shape,
            bias=cfg.get("bias", True),
            W_regularizer=_regularizer(cfg.get("W_regularizer")),
            b_regularizer=_regularizer(cfg.get("b_regularizer")),
            name=name,
        )
    if class_name == "Convolution3D":
        if cfg.get("dim_ordering", "th") == "tf":
            raise KerasConversionException(
                "tf dim_ordering Convolution3D configs are not supported; "
                "re-save the model with dim_ordering='th'"
            )
        return KL.Convolution3D(
            cfg["nb_filter"], cfg["kernel_dim1"], cfg["kernel_dim2"],
            cfg["kernel_dim3"],
            activation=cfg.get("activation"),
            border_mode=cfg.get("border_mode", "valid"),
            subsample=_tuple(cfg.get("subsample", (1, 1, 1))),
            input_shape=input_shape,
            bias=cfg.get("bias", True),
            name=name,
        )
    if class_name in ("MaxPooling3D", "AveragePooling3D"):
        if cfg.get("dim_ordering", "th") == "tf":
            raise KerasConversionException(
                f"tf dim_ordering {class_name} unsupported")
        cls = getattr(KL, class_name)
        return cls(
            pool_size=_tuple(cfg.get("pool_size", (2, 2, 2))),
            strides=_tuple(cfg["strides"]) if cfg.get("strides") else None,
            border_mode=cfg.get("border_mode", "valid"),
            input_shape=input_shape,
            name=name,
        )
    if class_name == "Highway":
        return KL.Highway(
            activation=cfg.get("activation"),
            bias=cfg.get("bias", True),
            input_shape=input_shape,
            name=name,
        )
    if class_name == "AtrousConvolution2D":
        if cfg.get("dim_ordering", "th") == "tf":
            raise KerasConversionException(
                "tf dim_ordering AtrousConvolution2D unsupported")
        return KL.AtrousConvolution2D(
            cfg["nb_filter"], cfg["nb_row"], cfg["nb_col"],
            atrous_rate=_tuple(cfg.get("atrous_rate", (1, 1))),
            activation=cfg.get("activation"),
            border_mode=cfg.get("border_mode", "valid"),
            subsample=_tuple(cfg.get("subsample", (1, 1))),
            input_shape=input_shape,
            bias=cfg.get("bias", True),
            name=name,
        )
    if class_name == "Convolution1D":
        return KL.Convolution1D(
            cfg["nb_filter"], cfg["filter_length"],
            activation=cfg.get("activation"),
            border_mode=cfg.get("border_mode", "valid"),
            subsample_length=cfg.get("subsample_length", 1),
            input_shape=input_shape,
            bias=cfg.get("bias", True),
            name=name,
        )
    if class_name == "MaxPooling1D":
        return KL.MaxPooling1D(
            pool_length=cfg.get("pool_length", 2),
            stride=cfg.get("stride"),
            input_shape=input_shape, name=name,
        )
    if class_name == "AveragePooling1D":
        return KL.AveragePooling1D(
            pool_length=cfg.get("pool_length", 2),
            stride=cfg.get("stride"),
            input_shape=input_shape, name=name,
        )
    if class_name == "GlobalMaxPooling1D":
        return KL.GlobalMaxPooling1D(input_shape=input_shape, name=name)
    if class_name == "GlobalAveragePooling1D":
        return KL.GlobalAveragePooling1D(input_shape=input_shape, name=name)
    if class_name == "ZeroPadding1D":
        return KL.ZeroPadding1D(cfg.get("padding", 1),
                                input_shape=input_shape, name=name)
    if class_name == "ZeroPadding3D":
        return KL.ZeroPadding3D(_tuple(cfg.get("padding", (1, 1, 1))),
                                input_shape=input_shape, name=name)
    if class_name == "Cropping2D":
        return KL.Cropping2D(_tuple(cfg.get("cropping", ((0, 0), (0, 0)))),
                             input_shape=input_shape, name=name)
    if class_name == "UpSampling2D":
        return KL.UpSampling2D(_tuple(cfg.get("size", (2, 2))),
                               input_shape=input_shape, name=name)
    if class_name == "LeakyReLU":
        return KL.LeakyReLU(cfg.get("alpha", 0.3),
                            input_shape=input_shape, name=name)
    if class_name == "ELU":
        return KL.ELU(cfg.get("alpha", 1.0), input_shape=input_shape,
                      name=name)
    if class_name == "ThresholdedReLU":
        return KL.ThresholdedReLU(cfg.get("theta", 1.0),
                                  input_shape=input_shape, name=name)
    if class_name == "Masking":
        return KL.Masking(cfg.get("mask_value", 0.0),
                          input_shape=input_shape, name=name)
    if class_name == "MaxPooling2D":
        return KL.MaxPooling2D(
            pool_size=_tuple(cfg.get("pool_size", (2, 2))),
            strides=_tuple(cfg.get("strides")) if cfg.get("strides") else None,
            border_mode=cfg.get("border_mode", "valid"),
            input_shape=input_shape,
            name=name,
        )
    if class_name == "AveragePooling2D":
        return KL.AveragePooling2D(
            pool_size=_tuple(cfg.get("pool_size", (2, 2))),
            strides=_tuple(cfg.get("strides")) if cfg.get("strides") else None,
            border_mode=cfg.get("border_mode", "valid"),
            input_shape=input_shape,
            name=name,
        )
    if class_name == "GlobalAveragePooling2D":
        return KL.GlobalAveragePooling2D(input_shape=input_shape, name=name)
    if class_name == "GlobalMaxPooling2D":
        return KL.GlobalMaxPooling2D(input_shape=input_shape, name=name)
    if class_name == "ZeroPadding2D":
        return KL.ZeroPadding2D(
            padding=_tuple(cfg.get("padding", (1, 1))),
            input_shape=input_shape, name=name,
        )
    if class_name == "BatchNormalization":
        return KL.BatchNormalization(
            epsilon=cfg.get("epsilon", 1e-3),
            momentum=cfg.get("momentum", 0.99),
            axis=cfg.get("axis", 1),
            input_shape=input_shape,
            name=name,
        )
    if class_name == "Embedding":
        return KL.Embedding(
            cfg["input_dim"], cfg["output_dim"],
            input_shape=input_shape
            or ((cfg.get("input_length"),) if cfg.get("input_length")
                else None),
            name=name,
        )
    if class_name in ("LSTM", "GRU", "SimpleRNN"):
        cls = getattr(KL, class_name)
        kw = {}
        if class_name != "SimpleRNN":
            kw["inner_activation"] = cfg.get("inner_activation",
                                             "hard_sigmoid")
        if cfg.get("stateful"):
            # documented design decision (not an omission): stateful
            # recurrents carry hidden state ACROSS batches, which the
            # per-batch recurrence deliberately resets; failing
            # loudly beats silently training different semantics
            raise KerasConversionException(
                f"stateful {class_name} {name}: cross-batch state is not "
                "supported by the per-batch recurrence")
        return cls(
            cfg["output_dim"],
            activation=cfg.get("activation", "tanh"),
            return_sequences=cfg.get("return_sequences", False),
            go_backwards=cfg.get("go_backwards", False),
            input_shape=input_shape,
            dropout_W=cfg.get("dropout_W", 0.0) or 0.0,
            dropout_U=cfg.get("dropout_U", 0.0) or 0.0,
            W_regularizer=_regularizer(cfg.get("W_regularizer")),
            U_regularizer=_regularizer(cfg.get("U_regularizer")),
            b_regularizer=_regularizer(cfg.get("b_regularizer")),
            name=name,
            **kw,
        )
    if class_name == "Bidirectional":
        inner_spec = cfg.get("layer", {})
        inner = _build_layer(inner_spec.get("class_name"),
                             inner_spec.get("config", {}))
        return KL.Bidirectional(inner,
                                merge_mode=cfg.get("merge_mode", "concat"),
                                input_shape=input_shape, name=name)
    if class_name == "GaussianNoise":
        return KL.GaussianNoise(cfg.get("sigma", 0.1),
                                input_shape=input_shape, name=name)
    if class_name == "GaussianDropout":
        return KL.GaussianDropout(cfg.get("p", 0.5),
                                  input_shape=input_shape, name=name)
    if class_name == "MaxoutDense":
        return KL.MaxoutDense(cfg["output_dim"],
                              nb_feature=cfg.get("nb_feature", 4),
                              input_shape=input_shape, name=name)
    if class_name == "TimeDistributedDense":
        return KL.TimeDistributedDense(
            cfg["output_dim"], activation=cfg.get("activation"),
            input_shape=input_shape, name=name,
        )
    raise KerasConversionException(
        f"unsupported Keras layer class {class_name}"
    )


# ==========================================================================
# JSON entry points
# ==========================================================================


def model_from_json(json_str: str, device="cuda"):
    """Reference: keras.models.model_from_json over the BigDL converter.
    Returns a :class:`bigdl_tpu_torch.keras.models.Sequential` for
    Sequential configs, or a core :class:`bigdl_tpu_torch.nn.Graph` for
    functional Model configs, on ``device``."""
    dev = resolve_device(device)
    spec = json.loads(json_str)
    class_name = spec.get("class_name")
    if class_name == "Sequential":
        return _sequential_from_config(spec["config"], dev)
    if class_name == "Model":
        return _graph_from_config(spec["config"]).to(dev)
    raise KerasConversionException(f"unsupported model class {class_name}")


def _sequential_from_config(layer_specs: List[dict],
                            device) -> KM.Sequential:
    model = KM.Sequential(device=device)
    start = 0
    if layer_specs and layer_specs[0]["class_name"] == "Merge":
        # keras-1.2.2 Sequential([Merge([left, right], mode=...), ...]):
        # the branches are full sub-model configs; the merged table op
        # heads the core and the model takes a TABLE of inputs
        model = _merge_headed_sequential(layer_specs[0].get("config", {}),
                                         device)
        start = 1
    for ls in layer_specs[start:]:
        layer = _build_layer(ls["class_name"], ls.get("config", {}))
        if layer is not None:
            model.add(layer)
    return model


def _merge_headed_sequential(mcfg: dict, device) -> KM.Sequential:
    from bigdl_tpu_torch.nn import layers as KLY
    from bigdl_tpu_torch.nn import table_ops as T
    from bigdl_tpu_torch.nn.module import Sequential as CoreSeq

    branches = []
    for sub in mcfg.get("layers", []):
        if sub.get("class_name") != "Sequential":
            raise KerasConversionException(
                "Merge branches must be Sequential sub-models")
        branches.append(_sequential_from_config(sub["config"], device))
    if not branches:
        raise KerasConversionException("Merge with no branch models")
    mode = mcfg.get("mode", "concat")
    shapes = [tuple(b._shape) for b in branches]

    if mode == "concat":
        axis = mcfg.get("concat_axis", -1)
        if axis == -1:
            axis = len(shapes[0])  # last non-batch dim, 1-based below
        mod = T.JoinTable(dimension=axis + 1, n_input_dims=-1)
        out_shape = list(shapes[0])
        out_shape[axis - 1] = sum(s[axis - 1] for s in shapes)
        out_shape = tuple(out_shape)
    elif mode in ("sum", "ave", "max", "mul"):
        if mode == "ave":
            mod = CoreSeq().add(T.CAddTable()) \
                .add(KLY.MulConstant(1.0 / len(branches)))
        else:
            mod = {"sum": T.CAddTable, "max": T.CMaxTable,
                   "mul": T.CMulTable}[mode]()
        out_shape = shapes[0]
    elif mode in ("dot", "cos"):
        if len(branches) != 2:
            raise KerasConversionException(
                f"Merge mode {mode} needs exactly 2 branches")
        mod = T.DotProduct() if mode == "dot" else T.CosineDistance()
        out_shape = (1,)
    else:
        raise KerasConversionException(f"Merge mode {mode}")

    from bigdl_tpu_torch.nn.table_ops import ParallelTable

    pt = ParallelTable()
    for b in branches:
        pt.add(b.core)
    model = KM.Sequential(device=device)
    model.core.add(pt).add(mod.to(model.device))
    model._shape = tuple(out_shape)
    if mcfg.get("name"):
        model.core.set_name(mcfg["name"])
    return model


def _graph_from_config(cfg: dict):
    """Functional Model: wire built cores into an nn.Graph."""
    from bigdl_tpu_torch.nn.graph import Graph, Input as GInput
    from bigdl_tpu_torch.nn import table_ops as T

    nodes: Dict[str, object] = {}
    shapes: Dict[str, tuple] = {}
    input_nodes = []

    for ls in cfg.get("layers", []):
        cname = ls["class_name"]
        lcfg = ls.get("config", {})
        lname = ls.get("name") or lcfg.get("name")
        inbound = ls.get("inbound_nodes") or []
        in_names = [ref[0] for ref in inbound[0]] if inbound else []

        if cname == "InputLayer":
            node = GInput(lname)
            input_nodes.append(node)
            nodes[lname] = node
            shapes[lname] = _strip_batch(lcfg.get("batch_input_shape"))
            continue
        if cname == "Merge":
            mode = lcfg.get("mode", "concat")
            if mode == "concat":
                axis = lcfg.get("concat_axis", -1)
                in_shape = shapes[in_names[0]]
                if axis == -1:
                    axis = len(in_shape)  # last feature dim (no batch)
                mod = T.JoinTable(dimension=axis + 1, n_input_dims=-1)
                out_shape = list(in_shape)
                out_shape[axis - 1] = sum(
                    shapes[n][axis - 1] for n in in_names
                )
                out_shape = tuple(out_shape)
            elif mode in ("sum", "ave", "max", "mul"):
                if mode == "ave":
                    from bigdl_tpu_torch.nn import layers as KLY
                    from bigdl_tpu_torch.nn.module import Sequential

                    mod = Sequential().add(T.CAddTable()) \
                        .add(KLY.MulConstant(1.0 / len(in_names)))
                else:
                    mod = {"sum": T.CAddTable, "max": T.CMaxTable,
                           "mul": T.CMulTable}[mode]()
                out_shape = shapes[in_names[0]]
            elif mode in ("dot", "cos"):
                if len(in_names) != 2:
                    raise KerasConversionException(
                        f"Merge mode {mode} needs exactly 2 inputs")
                mod = T.DotProduct() if mode == "dot" \
                    else T.CosineDistance()
                out_shape = (1,)
            else:
                raise KerasConversionException(f"Merge mode {mode}")
            if lname:
                mod.set_name(lname)
            nodes[lname] = mod(*[nodes[n] for n in in_names])
            shapes[lname] = out_shape
            continue

        layer = _build_layer(cname, lcfg)
        if not in_names:
            # implicit input (rare in 1.2.2 functional configs)
            raise KerasConversionException(
                f"layer {lname} has no inbound nodes"
            )
        in_shape = shapes[in_names[0]]
        core = layer._built(in_shape)
        nodes[lname] = core(*[nodes[n] for n in in_names])
        shapes[lname] = layer.output_shape

    outputs = [nodes[ref[0]] for ref in cfg.get("output_layers", [])]
    return Graph(input_nodes, outputs)


def model_from_json_path(path: str, device="cuda"):
    with open(path) as f:
        return model_from_json(f.read(), device=device)


# ==========================================================================
# HDF5 weights
# ==========================================================================


def load_weights_hdf5(model, h5_path: str, by_name: bool = True):
    """Copy Keras-1.2.2 ``save_weights`` HDF5 weights into a converted
    model by layer name (reference: converter's weight loader)."""
    import h5py

    core = getattr(model, "core", model)
    modules = {m._name: m for m in _iter_modules(core) if m._name}

    with h5py.File(h5_path, "r") as f:
        grp = f["model_weights"] if "model_weights" in f else f
        layer_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in grp.attrs.get("layer_names", list(grp.keys()))
        ]
        for lname in layer_names:
            if lname not in grp:
                continue
            g = grp[lname]
            weight_names = [
                n.decode() if isinstance(n, bytes) else n
                for n in g.attrs.get("weight_names", list(g.keys()))
            ]
            if not weight_names:
                continue
            mod = modules.get(lname)
            if mod is None:
                if by_name:
                    continue
                raise KerasConversionException(f"no module named {lname}")
            arrays = [np.asarray(g[w]) for w in weight_names]
            _assign_weights(mod, lname, weight_names, arrays)
    return model


def _assign_weights(mod, lname, weight_names, arrays):
    from bigdl_tpu_torch.nn import layers as L
    from bigdl_tpu_torch.nn import recurrent as R
    from bigdl_tpu_torch.nn.module import Sequential

    # keras Dense+activation / Conv+activation become a Sequential in the
    # keras layer build; the parameterised core is the first child —
    # for recurrents that child is the Recurrent container whose cell
    # holds the parameters
    if isinstance(mod, Sequential):
        for child in mod.modules:
            if child.params():
                mod = child
                break
    if isinstance(mod, R.BiRecurrent):
        # keras Bidirectional saves forward_* then backward_* weights;
        # positional fallback: first half forward, second half backward
        pairs = list(zip(weight_names, arrays))
        fw = [(n, a) for n, a in pairs if "backward" not in n.lower()]
        bw = [(n, a) for n, a in pairs if "backward" in n.lower()]
        if not bw:
            half = len(pairs) // 2
            fw, bw = pairs[:half], pairs[half:]
        _assign_recurrent(mod.modules[0].modules[0], lname,
                          [n for n, _ in fw], [a for _, a in fw])
        _assign_recurrent(mod.modules[1].modules[0], lname,
                          [n for n, _ in bw], [a for _, a in bw])
        return
    if isinstance(mod, R.Recurrent):
        cell = mod.modules[0]
        return _assign_recurrent(cell, lname, weight_names, arrays)
    if isinstance(mod, R.TimeDistributed):
        inner = mod.modules[0]
        return _assign_weights(inner, lname, weight_names, arrays)
    if isinstance(mod, L.Linear):
        w = arrays[0]
        _put(mod, "weight", w.T)  # keras (in,out) -> (out,in)
        if len(arrays) > 1 and mod.bias is not None:
            _put(mod, "bias", arrays[1])
    elif isinstance(mod, L.SpatialConvolution):
        w = arrays[0]  # th: (nb_filter, in, rows, cols)
        _put(mod, "weight", w.reshape(tuple(mod.weight.shape)))
        if len(arrays) > 1 and mod.bias is not None:
            _put(mod, "bias", arrays[1])
    elif type(mod).__name__ == "VolumetricConvolution":
        w = arrays[0]  # th: (nb_filter, in, k1, k2, k3) == OIDHW
        _put(mod, "weight", w.reshape(tuple(mod.weight.shape)))
        if len(arrays) > 1 and mod.bias is not None:
            _put(mod, "bias", arrays[1])
    elif type(mod).__name__ == "Highway":
        # keras-1.2.2 trainable order: W, W_carry, b, b_carry; keras
        # stores (in, out) — transpose for the y = x W^T convention
        named = {}
        for n, a in zip(weight_names, arrays):
            tail = n.rsplit("/", 1)[-1]
            for suffix in ("W_carry", "b_carry", "W", "b"):
                if tail.endswith(suffix):
                    named.setdefault(suffix, a)
                    break
        if len(named) == len(arrays):
            _put(mod, "weight", named["W"].T)
            _put(mod, "carry_weight", named["W_carry"].T)
            if "b" in named:
                _put(mod, "bias", named["b"])
            if "b_carry" in named:
                _put(mod, "carry_bias", named["b_carry"])
        else:  # positional fallback
            _put(mod, "weight", arrays[0].T)
            _put(mod, "carry_weight", arrays[1].T)
            if len(arrays) > 2:
                _put(mod, "bias", arrays[2])
            if len(arrays) > 3:
                _put(mod, "carry_bias", arrays[3])
    elif isinstance(mod, (L.BatchNormalization,)):
        _put(mod, "weight", arrays[0])
        _put(mod, "bias", arrays[1])
        if len(arrays) > 2:
            _put(mod, "running_mean", arrays[2])
        if len(arrays) > 3:
            # keras 1.2.2 stores running_std for mode=0 pre-1.0 configs,
            # variance otherwise; both enter as the variance slot
            _put(mod, "running_var", arrays[3])
    elif isinstance(mod, L.LookupTable):
        _put(mod, "weight", arrays[0])
    else:
        raise KerasConversionException(
            f"weight import for {type(mod).__name__} (layer {lname}) "
            "not supported"
        )


def _assign_recurrent(cell, lname, weight_names, arrays):
    """Keras-1.2.2 recurrent weights -> cell params.

    consume_less='cpu' saves one array per gate tensor named
    ``<layer>_W_i`` / ``_U_i`` / ``_b_i`` (LSTM gates i/c/f/o, GRU
    z/r/h, SimpleRNN plain W/U/b); consume_less='gpu' saves packed
    W/U/b with keras gate order i,f,c,o (LSTM) / z,r,h (GRU).  Mapping
    is name-based with a positional fallback in the 1.2.2
    trainable_weights order (i,c,f,o / z,r,h)."""
    import re

    from bigdl_tpu_torch.nn import recurrent as R

    named = {}
    for wn, arr in zip(weight_names, arrays):
        tail = wn.split("/")[-1].split(":")[0]
        m = re.search(r"_(W|U|b)(?:_(i|f|c|o|z|r|h))?$", tail)
        if m:
            named[(m.group(1), m.group(2))] = arr

    def pick(kind, gate):
        if (kind, gate) in named:
            return named[(kind, gate)]
        raise KerasConversionException(
            f"layer {lname}: missing recurrent weight {kind}_{gate}")

    H = cell.hidden_size
    if isinstance(cell, R.LSTM):
        if len(arrays) == 12:
            if not named:  # positional: 1.2.2 order i, c, f, o
                gates = ["i", "c", "f", "o"]
                named.update({("W", g): arrays[3 * k] for k, g in
                              enumerate(gates)})
                named.update({("U", g): arrays[3 * k + 1] for k, g in
                              enumerate(gates)})
                named.update({("b", g): arrays[3 * k + 2] for k, g in
                              enumerate(gates)})
            # our packing: (i, f, g=c, o)
            _put(cell, "w", np.concatenate(
                [pick("W", g) for g in ("i", "f", "c", "o")], axis=1))
            _put(cell, "u", np.concatenate(
                [pick("U", g) for g in ("i", "f", "c", "o")], axis=1))
            _put(cell, "b", np.concatenate(
                [pick("b", g) for g in ("i", "f", "c", "o")]))
        elif len(arrays) == 3:  # gpu mode: packed i, f, c, o — ours too
            _put(cell, "w", arrays[0])
            _put(cell, "u", arrays[1])
            _put(cell, "b", arrays[2])
        else:
            raise KerasConversionException(
                f"layer {lname}: unexpected LSTM weight count "
                f"{len(arrays)}")
    elif isinstance(cell, R.GRU):
        if len(arrays) == 9:
            if not named:  # positional: 1.2.2 order z, r, h
                gates = ["z", "r", "h"]
                named.update({("W", g): arrays[3 * k] for k, g in
                              enumerate(gates)})
                named.update({("U", g): arrays[3 * k + 1] for k, g in
                              enumerate(gates)})
                named.update({("b", g): arrays[3 * k + 2] for k, g in
                              enumerate(gates)})
            # our packing: (r, z) + candidate h
            _put(cell, "w_rz", np.concatenate(
                [pick("W", "r"), pick("W", "z")], axis=1))
            _put(cell, "u_rz", np.concatenate(
                [pick("U", "r"), pick("U", "z")], axis=1))
            _put(cell, "b_rz", np.concatenate(
                [pick("b", "r"), pick("b", "z")]))
            _put(cell, "w_h", pick("W", "h"))
            _put(cell, "u_h", pick("U", "h"))
            _put(cell, "b_h", pick("b", "h"))
        elif len(arrays) == 3:  # gpu mode: packed z, r, h
            W, U, b = (np.asarray(a) for a in arrays)
            _put(cell, "w_rz",
                 np.concatenate([W[:, H:2 * H], W[:, :H]], axis=1))
            _put(cell, "u_rz",
                 np.concatenate([U[:, H:2 * H], U[:, :H]], axis=1))
            _put(cell, "b_rz", np.concatenate([b[H:2 * H], b[:H]]))
            _put(cell, "w_h", W[:, 2 * H:])
            _put(cell, "u_h", U[:, 2 * H:])
            _put(cell, "b_h", b[2 * H:])
        else:
            raise KerasConversionException(
                f"layer {lname}: unexpected GRU weight count {len(arrays)}")
    elif isinstance(cell, R.RnnCell):
        _put(cell, "w", arrays[0])
        _put(cell, "u", arrays[1])
        if len(arrays) > 2:
            _put(cell, "b", arrays[2])
    else:
        raise KerasConversionException(
            f"recurrent weight import for {type(cell).__name__} "
            f"(layer {lname}) not supported")


@torch.no_grad()
def _put(mod, name: str, value) -> None:
    """Copy ``value`` into ``mod``'s parameter or buffer ``name``, on its
    device and in its dtype; shapes must agree."""
    cur = getattr(mod, name)
    new = torch.as_tensor(np.asarray(value))
    if tuple(new.shape) != tuple(cur.shape):
        raise KerasConversionException(
            f"{type(mod).__name__}.{name}: shape {tuple(new.shape)} != "
            f"{tuple(cur.shape)}")
    cur.copy_(new.to(device=cur.device, dtype=cur.dtype))


def _iter_modules(m):
    """``m`` and its descendants, depth first."""
    return torch.nn.Module.modules(m)
