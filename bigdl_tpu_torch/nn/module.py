"""The module contract of the port.

Counterpart of ``bigdl_tpu/nn/module.py``.  The JAX package keeps
parameters as a pytree and runs a pure ``apply(params, ...)``; here a
layer is a ``torch.nn.Module`` that owns its parameters, and
``params()``/``set_params()`` expose them as nested dicts under the JAX
package's names, so the weights of one package load into the other
(``bigdl_tpu_torch.utils.convert``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


class AbstractModule(torch.nn.Module):
    """Base of every layer: ``param_names`` lists the trainable tensors
    in declaration order (weight before bias), as in the JAX package."""

    param_names: tuple = ()

    def _set_param(self, name: str, value) -> None:
        """Register ``value`` (numpy array, tensor or None) as parameter
        ``name``.  Layers build on the host; the model moves to its
        device once it is whole."""
        if value is None:
            self.register_parameter(name, None)
            return
        t = torch.as_tensor(np.asarray(value)) if not isinstance(
            value, torch.Tensor) else value
        self.register_parameter(name, torch.nn.Parameter(t))

    def params(self) -> Dict[str, Any]:
        """Nested dict of this module's parameters (None ones left out)."""
        out = {}
        for n in self.param_names:
            v = getattr(self, n, None)
            if v is not None:
                out[n] = v
        return out

    @torch.no_grad()
    def set_params(self, params: Dict[str, Any]) -> None:
        """Copy tensors into the existing parameters, keeping each one's
        device and dtype; shapes must agree."""
        for n in self.param_names:
            if n not in params or params[n] is None:
                continue
            cur = getattr(self, n, None)
            new = torch.as_tensor(params[n])
            if cur is None:
                raise KeyError(f"{type(self).__name__} has no parameter {n!r}")
            if tuple(cur.shape) != tuple(new.shape):
                raise ValueError(
                    f"{type(self).__name__}.{n}: shape {tuple(new.shape)} "
                    f"!= {tuple(cur.shape)}")
            cur.copy_(new.to(device=cur.device, dtype=cur.dtype))


class Composite(AbstractModule):
    """Module built from named children; params nest by child name (the
    JAX package's ``_Composite``)."""

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


__all__ = ["AbstractModule", "Composite"]
