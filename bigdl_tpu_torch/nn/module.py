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
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import fold_in
from bigdl_tpu_torch.tensor import unwrap


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))


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
        self.register_parameter(name, torch.nn.Parameter(_as_tensor(value)))

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

    def evaluate(self):
        """Eval mode (the JAX package's ``evaluate()``); returns self."""
        self.eval()
        return self

    def set_name(self, name: str):
        """Name the layer (kept in its serialized spec); returns self."""
        self._name = name
        return self

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
