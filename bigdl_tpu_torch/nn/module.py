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
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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


class _Children(list):
    """A container's children in order (the JAX package's ``modules``
    list).  Calling it still gives torch's ``Module.modules()``."""

    def __init__(self, owner: torch.nn.Module):
        super().__init__(owner._modules.values())
        self._owner = owner

    def __call__(self):
        return torch.nn.Module.modules(self._owner)


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


class Sequential(Container):
    """Feed-forward chain (JAX ``Sequential``, module.py:579)."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class Identity(AbstractModule):
    """JAX ``Identity`` (module.py:641)."""

    def forward(self, x):
        return x


__all__ = ["AbstractModule", "Composite", "Container", "Sequential",
           "Identity"]
