"""The module contract of the port, and its containers.

Counterpart of ``bigdl_tpu/nn/module.py``.  The JAX package keeps
parameters as a pytree and runs a pure ``apply(params, state, ...)``;
here a layer is a ``torch.nn.Module`` that owns its parameters and
buffers, and ``params()``/``set_params()`` and ``state()``/
``set_state()`` expose them as nested dicts under the JAX package's
names, so the trees of one package load into the other
(``bigdl_tpu_torch.utils.convert``).

Mode switches: torch's ``train()`` is the JAX package's ``training()``
(torch keeps its mode flag in the ``training`` attribute, so the name
cannot be a method here), and ``evaluate()`` is ``eval()``.

The stateful BigDL API (JAX :100-200) rides on autograd.
``update_output(input)`` runs the module with the graph kept and sets
``output`` (detached); ``update_grad_input``/``acc_grad_parameters``/
``backward`` take the gradient of that output through the kept graph
(``torch.autograd.grad`` over the parameters and the input), so a BN
layer's running statistics move once a step.  A ``backward`` on another
input than the last ``update_output``'s runs the forward again, with
the buffers saved and restored around it and the same dropout seed.
Parameter gradients accumulate in each parameter's ``.grad``;
``grad_params()`` reads them as a tree shaped like ``params()``.  An
integer input's gradient is ``None`` (JAX gives a ``float0`` array).
torch owns ``parameters()``: the BigDL ``(weights, gradients)`` pair is
``parameters_and_grads()`` (``ROADMAP.md`` queue 3).

Calling a module on graph nodes (``conv(input_node)``) wires it into a
``Graph`` (``nn/graph.py``) and returns its ``Node``, as the JAX
``AbstractModule.__call__`` does; a call on anything else is torch's
forward call.

Regularizers and freezing (JAX :291-305, :357-406): a layer built with
``w_regularizer``/``b_regularizer`` lists (parameter name, regularizer)
pairs, and ``regularization_loss`` sums their penalties over the module
and its children; a frozen module adds nothing.  ``freeze()`` freezes a
module and its descendants, ``freeze(name, ...)`` the descendants of
those names; the trainers zero a frozen parameter's gradient before the
clipper and keep the parameter as it was.  The JAX package's
``_Composite`` (``TransformerLM``, ``TransformerBlock``) has no
``modules`` list, so there a frozen child of a composite is not seen;
here every child is (``ROADMAP.md`` queue 3).
"""

from __future__ import annotations

import inspect
import os
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import RandomGenerator, fold_in
from bigdl_tpu_torch.tensor import unwrap


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))


# the graph each module's last ``update_output`` kept: module ->
# (the input as given, its leaves, the output).  Held beside the module,
# not on it, so that a deep copy or a pickle of the module never meets a
# non-leaf tensor
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _map_input(fn, x):
    """``fn`` over each tensor of an input (a tensor, or a table: a
    tuple or list of them, nested), the structure kept."""
    if isinstance(x, (tuple, list)):
        return type(x)(_map_input(fn, v) for v in x)
    return fn(x)


def _input_leaves(x) -> list:
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _input_leaves(v)]
    return [x]


def _same_input(a, b) -> bool:
    """Is ``b`` the input ``a`` was: the same object, or a table of the
    same objects."""
    if a is b:
        return True
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_same_input(u, v)
                                        for u, v in zip(a, b))
    return False


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree) -> list:
    """A tree's tensors in ``jax.tree.leaves`` order."""
    from bigdl_tpu_torch.utils.tree import leaves

    return leaves(tree)


def _unique(tensors) -> list:
    seen, out = set(), []
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _trainable(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class AbstractModule(torch.nn.Module):
    """Base of every layer: ``param_names`` lists the trainable tensors
    in declaration order (weight before bias), ``state_names`` the
    non-trained buffers (BN running statistics), as in the JAX
    package."""

    param_names: tuple = ()
    state_names: tuple = ()
    # a model whose forward takes ``rng_seed``, the seed of its dropout
    # masks for one step (the JAX ``apply(..., rng=key)``), says so here
    takes_rng_seed: bool = False
    # the constructor arguments a serialized spec records, under the
    # JAX package's names (its ``self._config``)
    config_names: tuple = ()
    # the layer's name (``set_name``): kept in specs, and the layer's
    # name in an exported Caffe net
    _name: Optional[str] = None
    # (parameter name, regularizer) pairs (``_set_regularizers``)
    _regularizers: tuple = ()
    _frozen: bool = False

    def __call__(self, *args, **kwargs):
        """Forward, or with graph nodes as the arguments (or none) a new
        ``Node`` of this module wired to them.  A ``Tensor`` facade
        argument (or a table of them) is unwrapped first."""
        if args and not isinstance(args[0], torch.Tensor):
            args = tuple(unwrap(a) for a in args)
        if kwargs or (args and isinstance(args[0], torch.Tensor)):
            return super().__call__(*args, **kwargs)
        from bigdl_tpu_torch.nn.graph import Node, _as_nodes

        nodes = _as_nodes(args)
        if not args or (nodes and all(isinstance(n, Node) for n in nodes)):
            return Node(self, nodes)
        return super().__call__(*args, **kwargs)

    def _set_param(self, name: str, value) -> None:
        """Register ``value`` (numpy array, tensor or None) as parameter
        ``name``.  Layers build on the host; the model moves to its
        device once it is whole."""
        if value is None:
            self.register_parameter(name, None)
            return
        value = _as_tensor(value)
        cur = self._parameters.get(name)
        if cur is not None:
            # a reset: draw into the live tensor, so that its device,
            # dtype and every reference to it are kept
            if tuple(cur.shape) == tuple(value.shape):
                with torch.no_grad():
                    cur.copy_(value.to(device=cur.device, dtype=cur.dtype))
                return
            value = value.to(device=cur.device, dtype=cur.dtype)
        self.register_parameter(name, torch.nn.Parameter(value))

    def params(self) -> Dict[str, Any]:
        """Nested dict of this module's parameters (None ones left out)."""
        out = {}
        for n in self.param_names:
            v = getattr(self, n, None)
            if v is not None:
                out[n] = v
        return out

    @torch.no_grad()
    def _copy_into(self, names, tree) -> None:
        for n in names:
            if n not in tree or tree[n] is None:
                continue
            cur = getattr(self, n, None)
            new = _as_tensor(tree[n])
            if cur is None:
                raise KeyError(f"{type(self).__name__} has no tensor {n!r}")
            if tuple(cur.shape) != tuple(new.shape):
                raise ValueError(
                    f"{type(self).__name__}.{n}: shape {tuple(new.shape)} "
                    f"!= {tuple(cur.shape)}")
            cur.copy_(new.to(device=cur.device, dtype=cur.dtype))

    def set_params(self, params: Dict[str, Any]) -> None:
        """Copy tensors into the existing parameters, keeping each one's
        device and dtype; shapes must agree."""
        self._copy_into(self.param_names, params)

    def state(self) -> Dict[str, Any]:
        """Nested dict of this module's buffers (the JAX ``state()``)."""
        out = {}
        for n in self.state_names:
            v = getattr(self, n, None)
            if v is not None:
                out[n] = v
        return out

    def set_state(self, state: Dict[str, Any]) -> None:
        """Copy tensors into the existing buffers, as ``set_params``."""
        self._copy_into(self.state_names, state)

    # ---- the stateful API (JAX :100-200) -----------------------------------
    # the last update_output's output (detached) and the last input
    # gradient, as the JAX package keeps them
    output = None
    grad_input = None
    _forward_count: int = 0
    _last_rng_seed: Optional[int] = None

    def _device(self) -> torch.device:
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        return torch.device("cpu")

    def _next_rng_seed(self) -> Optional[int]:
        """A model that takes a dropout seed gets one per call, from a
        per-module counter (the JAX ``_next_rng`` fold-in; other bits,
        ``ROADMAP.md`` queue 3)."""
        if not self.takes_rng_seed:
            return None
        self._forward_count += 1
        return fold_in(RandomGenerator.RNG.seed + 1013904223,
                       self._forward_count)

    def _forward_kept(self, input, rng_seed):
        """(the input's leaves, the output) of a forward with the graph
        kept: floating tensors of the input become fresh leaves that
        require a gradient, numpy arrays go to the module's device."""
        dev = self._device()

        def leaf(x):
            x = unwrap(x)
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x), device=dev)
            x = x.detach()
            return x.requires_grad_(True) if x.is_floating_point() else x

        x = _map_input(leaf, unwrap(input))
        kw = {} if rng_seed is None else {"rng_seed": rng_seed}
        with torch.enable_grad():
            out = self(x, **kw)
        return x, out

    def update_output(self, input):
        """The forward of the stateful API (JAX ``forward``/
        ``update_output``): runs the module (BN statistics move, as in a
        training step), keeps the graph for the backward and sets
        ``self.output`` (detached)."""
        self._last_rng_seed = self._next_rng_seed()
        x, out = self._forward_kept(input, self._last_rng_seed)
        _GRAPHS[self] = (input, x, out)
        self.output = _map_input(lambda t: t.detach(), out)
        return self.output

    updateOutput = update_output

    def _param_list(self) -> list:
        return _unique(_tree_leaves(self.params()))

    def _grads(self, input, grad_output, want_params: bool,
               want_input: bool):
        """(the parameters in ``_param_list`` order, their gradients, the
        input's gradient) of ``grad_output`` through the graph of
        ``input``."""
        kept = _GRAPHS.get(self)
        if kept is None or not _same_input(kept[0], input):
            # another input: run it again, the buffers and the dropout
            # seed as the last update_output had them
            saved = _clone_tree(self.state())
            try:
                x, out = self._forward_kept(input, self._last_rng_seed)
            finally:
                self.set_state(saved)
        else:
            _, x, out = kept
        params = self._param_list() if want_params else []
        wrt = [p for p in params if _trainable(p) and p.requires_grad]
        if want_input:
            wrt += [t for t in _input_leaves(x) if t.requires_grad]
        outs, gouts = [], []
        for o, g in zip(_input_leaves(out), _input_leaves(unwrap(
                grad_output))):
            if g is not None and isinstance(o, torch.Tensor) \
                    and o.requires_grad:
                outs.append(o)
                gouts.append(torch.as_tensor(g, device=o.device,
                                             dtype=o.dtype))
        got = torch.autograd.grad(outs, wrt, gouts, retain_graph=True,
                                  allow_unused=True) if outs and wrt \
            else [None] * len(wrt)
        by_id = {id(t): g for t, g in zip(wrt, got)}

        def grad_of(t):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                return None
            g = by_id.get(id(t))
            return torch.zeros_like(t) if g is None else g.detach()

        grad_p = [grad_of(p) for p in params]
        grad_x = _map_input(grad_of, x) if want_input else None
        return params, grad_p, grad_x

    @torch.no_grad()
    def _accumulate(self, params, grads) -> None:
        for p, g in zip(params, grads):
            if g is None:
                continue
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.add_(g)

    def update_grad_input(self, input, grad_output):
        """The input's gradient (JAX ``update_grad_input``): sets and
        returns ``self.grad_input`` and adds nothing to the parameters'
        gradients.  A table input gives a table; an integer tensor's
        entry is ``None``."""
        _, _, gx = self._grads(input, grad_output, False, True)
        self.grad_input = gx
        return gx

    updateGradInput = update_grad_input

    def acc_grad_parameters(self, input, grad_output) -> None:
        """Add the parameters' gradients of ``grad_output`` into their
        ``.grad`` (JAX ``acc_grad_parameters``)."""
        params, gp, _ = self._grads(input, grad_output, True, False)
        self._accumulate(params, gp)

    accGradParameters = acc_grad_parameters

    def backward(self, input, grad_output):
        """``update_grad_input`` and ``acc_grad_parameters`` in one pass
        through the graph; returns the input's gradient."""
        params, gp, gx = self._grads(input, grad_output, True, True)
        self._accumulate(params, gp)
        self.grad_input = gx
        return gx

    @torch.no_grad()
    def zero_grad_parameters(self) -> None:
        """Every parameter's gradient to zeros (torch's ``zero_grad``
        drops them instead)."""
        for p in self._param_list():
            if not _trainable(p):
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()

    zeroGradParameters = zero_grad_parameters

    def grad_params(self):
        """The accumulated gradients, a tree shaped like ``params()``
        (zeros where none has been accumulated; an integer tensor's
        leaf is a zero tensor of its own)."""
        def grad(p):
            if not _trainable(p):
                return torch.zeros_like(p)
            if p.grad is None:
                with torch.no_grad():
                    p.grad = torch.zeros_like(p)
            return p.grad

        return _tree_map(grad, self.params())

    @torch.no_grad()
    def update_parameters(self, learning_rate: float) -> None:
        """Plain SGD in place: ``w -= learning_rate * g`` (JAX
        ``update_parameters``)."""
        for p in self._param_list():
            if _trainable(p) and p.grad is not None:
                p.sub_(learning_rate * p.grad)

    updateParameters = update_parameters

    def parameters_and_grads(self):
        """The BigDL ``parameters()``: (weights, gradients), flat lists in
        ``jax.tree.leaves`` order, so index i names the same tensor in
        both packages."""
        grads = self.grad_params()
        return _tree_leaves(self.params()), _tree_leaves(grads)

    # ---- weights I/O ---------------------------------------------------------
    def _ordered_params(self) -> list:
        """(module, name) of each parameter in declaration order, weight
        before bias, children in ``add`` order: the reference's
        ``parameters()`` order, which the npz weight files keep (JAX
        :202)."""
        return [(self, n) for n in self.param_names
                if getattr(self, n, None) is not None]

    def get_weights(self) -> list:
        """The parameters as host numpy arrays, in ``_ordered_params``
        order."""
        return [getattr(m, n).detach().cpu().numpy()
                for m, n in self._ordered_params()]

    @torch.no_grad()
    def set_weights(self, weights):
        """Copy arrays into the parameters in ``get_weights`` order,
        keeping each one's device and dtype; counts and shapes must
        agree."""
        slots = self._ordered_params()
        if len(weights) != len(slots):
            raise ValueError(
                f"expected {len(slots)} weight arrays, got {len(weights)}")
        for (m, n), new in zip(slots, weights):
            old = getattr(m, n)
            # a copy: a JAX array reads as a read-only numpy array
            new = new if isinstance(new, torch.Tensor) else torch.from_numpy(
                np.array(new))
            if tuple(new.shape) != tuple(old.shape):
                raise ValueError(f"shape mismatch: {tuple(new.shape)} vs "
                                 f"{tuple(old.shape)}")
            old.copy_(new.to(device=old.device, dtype=old.dtype))
        return self

    def save_weights(self, path: str, over_write: bool = False) -> str:
        """The weights as an npz of keys ``"0"`` .. ``"n-1"`` in
        ``get_weights`` order, the JAX package's file (JAX :323)."""
        if not path.endswith(".npz"):
            path += ".npz"
        if not over_write and os.path.exists(path):
            raise FileExistsError(f"{path} exists; pass over_write=True")
        np.savez(path, **{str(i): w
                          for i, w in enumerate(self.get_weights())})
        return path

    def load_weights(self, path: str):
        """Restore ``save_weights``'s (or the JAX package's) npz."""
        with np.load(path) as data:
            weights = [data[str(i)] for i in range(len(data.files))]
        return self.set_weights(weights)

    saveWeights = save_weights
    loadWeights = load_weights

    def save(self, path: str, over_write: bool = False) -> str:
        """The module through the serializer (``save_module``: an npz
        spec, or the protobuf format for a ``.bigdl`` path); an
        existing file is refused without ``over_write``."""
        from bigdl_tpu_torch.utils.serializer import save_module

        if not over_write and os.path.exists(path):
            raise FileExistsError(
                f"{path} exists; pass over_write=True (reference "
                "overWrite semantics)")
        return save_module(self, path)

    saveModule = save

    # ---- evaluation, prediction, quantization --------------------------------
    def evaluate(self, dataset=None, methods=None, batch_size: int = 32,
                 device="cuda"):
        """No dataset: eval mode (the JAX package's ``evaluate()``),
        returns self.  With a dataset (a ``DataSet``, an ``(x, y)``
        tuple or ``Sample``s) and validation methods: their results
        over it on ``device`` (``evaluate_dataset``)."""
        self.eval()
        if dataset is None:
            return self
        if not methods:
            raise ValueError(
                "evaluate(dataset, methods): pass validation methods, "
                "e.g. [Top1Accuracy()]")
        from bigdl_tpu_torch.dataset import to_dataset
        from bigdl_tpu_torch.optim.evaluator import evaluate_dataset

        return evaluate_dataset(self, to_dataset(dataset, batch_size),
                                methods, device=device)

    def test(self, dataset, methods, batch_size: int = 32, device="cuda"):
        """The reference's ``model.test(dataset, methods)``."""
        return self.evaluate(dataset, methods, batch_size, device)

    def predict(self, features, batch_size: int = 32, device="cuda"):
        """Eval-mode outputs over ``features`` in batches, on the host."""
        from bigdl_tpu_torch.optim.evaluator import predict as _predict

        return _predict(self, features, batch_size, device)

    def predict_class(self, features, batch_size: int = 32, device="cuda"):
        """The 1-based class of each sample (argmax + 1)."""
        from bigdl_tpu_torch.optim.evaluator import predict_class as _pc

        return _pc(self, features, batch_size, device)

    predictClass = predict_class

    def quantize(self):
        """A copy with every Linear and conv swapped for its int8 twin
        (``nn/quantized.quantize``)."""
        from bigdl_tpu_torch.nn.quantized import quantize as _q

        return _q(self)

    def reset(self):
        """Draw the initial parameters again from ``RandomGenerator.RNG``;
        a layer without parameters has nothing to draw."""
        return self

    def grad_mask(self):
        """A tree shaped like ``params()``: 0.0 at a frozen module's
        parameters, 1.0 elsewhere (JAX :402)."""
        scale = 0.0 if self._frozen else 1.0
        return {n: scale for n in self.params()}

    def get_parameters_table(self) -> dict:
        """Each parameterised module's tensors by module name, children
        before their parents (the reference's ``getParametersTable()``)."""
        table = {}

        def walk(m):
            for child in m.children():
                if isinstance(child, AbstractModule):
                    walk(child)
            p = {n: getattr(m, n) for n in m.param_names
                 if getattr(m, n, None) is not None}
            if p:
                table[m.get_name()] = p

        walk(self)
        return table

    getParametersTable = get_parameters_table

    def inputs(self, *nodes):
        """This module as a graph ``Node`` wired to ``nodes`` (the
        reference's ``module.inputs(n1, n2)``)."""
        from bigdl_tpu_torch.nn.graph import Node, _as_nodes

        return Node(self, _as_nodes(nodes))

    def set_name(self, name: str):
        """Name the layer (kept in its serialized spec); returns self."""
        self._name = name
        return self

    setName = set_name

    def get_name(self) -> str:
        """The layer's name, or ``Class@id`` without one (JAX :281)."""
        return self._name or f"{type(self).__name__}@{id(self):x}"

    getName = get_name

    # ---- regularizers and freezing ----------------------------------------
    def _set_regularizers(self, args) -> None:
        """``args``: (constructor argument, regularizer or its spec dict
        or ``None``, the parameter names it covers) triples."""
        from bigdl_tpu_torch.optim.regularizer import regularizer_from_config

        pairs = []
        for arg, reg, names in args:
            reg = regularizer_from_config(reg)
            setattr(self, arg, reg)
            if reg is not None:
                pairs.extend((n, reg) for n in names)
        self._regularizers = tuple(pairs)

    def regularization_loss(self, params: Optional[dict] = None):
        """Σ of the regularizers' penalties over ``params`` (this
        module's ``params()`` tree, the live parameters by default) and
        the children's subtrees; 0.0 for a frozen module."""
        if self._frozen:
            return 0.0
        if params is None:
            params = self.params()
        loss = 0.0
        for name, reg in self._regularizers:
            if params.get(name) is not None:
                loss = loss + reg(params[name])
        for name, child in self._modules.items():
            if isinstance(child, AbstractModule):
                loss = loss + child.regularization_loss(
                    params.get(name, {}))
        return loss

    def _descendants(self):
        return [m for m in torch.nn.Module.modules(self)
                if m is not self and isinstance(m, AbstractModule)]

    def find_module(self, name: str) -> Optional["AbstractModule"]:
        """The first descendant named ``name`` (``set_name``), depth
        first, or ``None``."""
        for m in self._descendants():
            if m._name == name:
                return m
        return None

    def _set_frozen(self, frozen: bool, names) -> "AbstractModule":
        if not names:
            self._frozen = frozen
            for m in self._descendants():
                m._frozen = frozen
            return self
        verb = "freeze" if frozen else "unfreeze"
        for name in names:
            target = self.find_module(name)
            if target is None:
                raise ValueError(f"{verb}: no module named {name!r}")
            target._set_frozen(frozen, ())
        return self

    def freeze(self, *names) -> "AbstractModule":
        """Freeze this module and its descendants, or with ``names`` the
        named descendants and theirs: the trainers leave their
        parameters as they are, and their regularizers add nothing."""
        return self._set_frozen(True, names)

    def unfreeze(self, *names) -> "AbstractModule":
        return self._set_frozen(False, names)

    unFreeze = unfreeze

    def is_frozen(self) -> bool:
        return self._frozen

    def has_frozen(self) -> bool:
        """True when this module or a descendant is frozen."""
        return self._frozen or any(m._frozen for m in self._descendants())

    def frozen_parameters(self) -> set:
        """The ids of the parameters that belong to frozen modules (what
        JAX's ``grad_mask`` zeroes)."""
        if self._frozen:
            return {id(p) for p in self.parameters()}
        out = set()
        for child in self.children():
            if isinstance(child, AbstractModule):
                out |= child.frozen_parameters()
        return out

    def get_config(self) -> Dict[str, Any]:
        """The constructor arguments ``cls(**config)`` rebuilds this
        module from (JAX ``get_config``).  A class whose constructor
        needs an argument it does not record raises: its spec could not
        be rebuilt."""
        sig = inspect.signature(type(self).__init__)
        missing = [n for n, p in sig.parameters.items()
                   if n != "self" and p.default is inspect.Parameter.empty
                   and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                   and n not in self.config_names]
        if missing:
            raise NotImplementedError(
                f"{type(self).__name__} cannot be serialized: its "
                f"constructor arguments {missing} are not recorded "
                "(ROADMAP.md queue 1)")
        out = {}
        for n in self.config_names:
            v = getattr(self, n)
            out[n] = list(v) if isinstance(v, tuple) else v
        # a regularizer is recorded only where one is set, so the spec
        # of a layer without one stays the JAX package's
        for n in ("w_regularizer", "u_regularizer", "b_regularizer"):
            reg = getattr(self, n, None)
            if reg is not None:
                out[n] = reg.get_config()
        return out


class _Children(list):
    """A container's children in order (the JAX package's ``modules``
    list).  Calling it still gives torch's ``Module.modules()``.  An
    item assigned, deleted, appended or inserted re-registers the
    children by index, as a change to JAX's list changes the model
    (``model.modules[1] = new_head``)."""

    def __init__(self, owner: torch.nn.Module):
        super().__init__(owner._modules.values())
        self._owner = owner

    def __call__(self):
        return torch.nn.Module.modules(self._owner)

    def _sync(self):
        self._owner.modules = list(self)

    def __setitem__(self, index, value):
        super().__setitem__(index, value)
        self._sync()

    def __delitem__(self, index):
        super().__delitem__(index)
        self._sync()

    def append(self, module):
        super().append(module)
        self._sync()

    def insert(self, index, module):
        super().insert(index, module)
        self._sync()


class Composite(AbstractModule):
    """Module built from named children; params and state nest by child
    name (the JAX package's ``_Composite``)."""

    def _add_child(self, name: str, module: AbstractModule):
        self.add_module(name, module)
        return module

    def child(self, name: str) -> AbstractModule:
        return self._modules[name]

    def params(self):
        return {n: m.params() for n, m in self._modules.items()}

    def set_params(self, params):
        for n, m in self._modules.items():
            m.set_params(params.get(n, {}))

    def state(self):
        return {n: m.state() for n, m in self._modules.items()}

    def set_state(self, state):
        for n, m in self._modules.items():
            m.set_state(state.get(n, {}))

    def _ordered_params(self) -> list:
        return [slot for m in self._modules.values()
                for slot in m._ordered_params()]

    def reset(self):
        """Each child's ``reset``, in order (JAX ``Container.reset``)."""
        for m in self._modules.values():
            m.reset()
        return self

    def grad_mask(self):
        if self._frozen:
            return _tree_map(lambda _: 0.0, self.params())
        return {n: m.grad_mask() for n, m in self._modules.items()}


class Container(Composite):
    """Base container (JAX ``Container``, module.py:446): children are
    registered as ``"0"``, ``"1"``, ... in ``add`` order, so
    ``params()``/``state()`` nest by child index exactly as the JAX
    tree does.  ``modules`` reads the children as a list; assigning a
    list re-registers them by index (``model.modules = model.modules[:-1]``
    drops the tail, as ``bench.py`` does)."""

    def add(self, module: AbstractModule):
        self.add_module(str(len(self._modules)), module)
        return self

    @property
    def modules(self) -> _Children:
        return _Children(self)

    @modules.setter
    def modules(self, mods) -> None:
        mods = list(mods)
        self._modules.clear()
        for m in mods:
            self.add(m)

    @property
    def takes_rng_seed(self) -> bool:
        return any(m.takes_rng_seed for m in self._modules.values())

    @staticmethod
    def _call_child(i: int, m: AbstractModule, x, rng_seed: Optional[int]):
        """Child ``m``'s output; a child that takes a dropout seed gets
        ``fold_in(rng_seed, i)``, as the JAX containers hand child i
        ``fold_in(rng, i)``."""
        if not m.takes_rng_seed:
            return m(x)
        return m(x, rng_seed=None if rng_seed is None
                 else fold_in(rng_seed, i))


class Sequential(Container):
    """Feed-forward chain (JAX ``Sequential``, module.py:579); child i
    gets its dropout seed as ``Container._call_child`` hands it out."""

    def forward(self, x, rng_seed: Optional[int] = None):
        for i, m in enumerate(self._modules.values()):
            x = self._call_child(i, m, x, rng_seed)
        return x

    def to_graph(self, input_node=None):
        """This chain as a ``Graph`` of the same module objects (so the
        weights stay live), nested ``Sequential``s inlined and each
        ``Concat`` turned into its branches joined by a ``JoinTable`` of
        its dimension and name (JAX module.py:597-636): the node
        topology the Caffe exporter writes.  With ``input_node`` the
        chain is wired after it and its last node returned."""
        from bigdl_tpu_torch.nn.graph import Graph, Input
        from bigdl_tpu_torch.nn.table_ops import Concat, JoinTable

        root = input_node if input_node is not None else Input("data")

        def chain(seq, node):
            for m in seq.modules:
                if isinstance(m, Sequential):
                    node = chain(m, node)
                elif isinstance(m, Concat):
                    tails = [chain(b, node) if isinstance(b, Sequential)
                             else b(node) for b in m.modules]
                    join = JoinTable(m.dimension)
                    if m._name:
                        join.set_name(m._name)
                    node = join(*tails)
                else:
                    node = m(node)
            return node

        out = chain(self, root)
        if input_node is not None:
            return out
        g = Graph(root, out)
        if self._name:
            g.set_name(self._name)
        return g


# the jax.checkpoint_policies entries a JAX Remat spec may name
REMAT_POLICIES = (
    "checkpoint_dots", "checkpoint_dots_with_no_batch_dims",
    "dots_saveable", "dots_with_no_batch_dims_saveable",
    "everything_saveable", "nothing_saveable",
    "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names",
    "save_any_names_but_these", "save_anything_except_these_names",
    "save_from_both_policies", "save_only_these_names")


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


class Remat(Container):
    """Gradient checkpointing (JAX ``Remat``, module.py:523): the
    wrapped module's activations are not kept for the backward; it runs
    again from the wrapper's input (``torch.utils.checkpoint``,
    ``use_reentrant=False``).  Wraps exactly one module.  The child gets
    the wrapper's dropout seed as it is (JAX hands it ``rng``), and the
    mask comes from a generator made inside the call, so the recomputed
    forward draws the same one.  A recompute leaves the child's buffers
    (BN running statistics) as the first forward left them.  ``policy``
    names a ``jax.checkpoint_policies`` entry, kept in the spec: torch
    recomputes every activation whatever the policy, which gives the
    same values."""

    config_names = ("policy",)

    def __init__(self, module: Optional[AbstractModule] = None,
                 policy: Optional[str] = None):
        super().__init__()
        if policy and policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown jax.checkpoint_policies entry {policy!r}")
        self.policy = policy
        if module is not None:
            self.add(module)

    def add(self, module: AbstractModule):
        if self._modules:
            raise ValueError(
                "Remat wraps exactly one module; wrap a Sequential for "
                "multi-layer spans")
        return super().add(module)

    def forward(self, x, rng_seed: Optional[int] = None):
        if not self._modules:
            raise ValueError("Remat has no wrapped module; add() one")
        child = self._modules["0"]
        kw = {"rng_seed": rng_seed} if child.takes_rng_seed else {}
        if not torch.is_grad_enabled():
            return child(x, **kw)
        runs = []

        def run(inp):
            if not runs:
                runs.append(1)
                return child(inp, **kw)
            # the recompute in the backward: its buffer writes are undone
            kept = _clone_tree(child.state())
            out = child(inp, **kw)
            child.set_state(kept)
            return out

        from torch.utils.checkpoint import checkpoint

        return checkpoint(run, x, use_reentrant=False)

    def extra_repr(self):
        return f"policy={self.policy}" if self.policy else ""


class Identity(AbstractModule):
    """JAX ``Identity`` (module.py:641)."""

    def forward(self, x):
        return x


class Echo(AbstractModule):
    """Prints the input's shape at each forward and passes it on (JAX
    ``Echo``, module.py:648; a debugging aid)."""

    def forward(self, x):
        shape = tuple(x.shape) if hasattr(x, "shape") else None
        print(f"Echo[{self.get_name()}]: shape={shape}")
        return x


__all__ = ["AbstractModule", "Composite", "Container", "Sequential",
           "Remat", "Identity", "Echo"]
