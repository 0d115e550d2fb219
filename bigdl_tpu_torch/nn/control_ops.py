"""Control-flow ops: the switch and merge of a conditional, ``IfElse``,
``WhileLoop`` and the two markers of a ``DynamicGraph`` cycle.

Counterpart of ``bigdl_tpu/nn/control_ops.py`` (:41-183), with its
semantics:

* ``SwitchOps``/``MergeOps`` use select semantics: both branches run
  on the live tensor, and the ``MergeOps`` wired with the same
  predicate keeps the taken branch's result (``torch.where``, the
  predicate broadcast numpy-style as ``jnp.where`` does).  Gradients
  reach the taken branch only.
* ``IfElse`` runs one child, chosen by a host read of the predicate
  (JAX's ``lax.cond`` runs one branch too).  Module state does not
  cross it: JAX returns the state it was given (:113-116), so a
  branch's buffers (BN running statistics in training mode) are put
  back as they were after the branch runs.
* ``WhileLoop`` is forward only, as JAX's ``lax.while_loop`` is
  (:122-160): the loop runs on the host, and a backward pass through
  its output raises, where ``jax.grad`` of a while loop raises.
  ``DynamicGraph`` with ``max_iterations`` is the differentiable loop.
* ``LoopCondition`` and ``NextIteration`` pass their input through;
  ``DynamicGraph`` (``nn/graph.py``) reads the first as the loop's
  condition and carries the second's feedback value between
  iterations (``Node.feedback_from``).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.common import fold_in
from bigdl_tpu_torch.nn.module import AbstractModule, Container


def _as_bool(pred, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The predicate as a bool tensor (nonzero is true, as in
    ``jnp.where``), on ``like``'s device."""
    p = pred if isinstance(pred, torch.Tensor) else torch.as_tensor(pred)
    if like is not None and p.device != like.device:
        p = p.to(like.device)
    return p if p.dtype == torch.bool else p != 0


def _host_bool(pred) -> bool:
    """One host read of a scalar predicate."""
    p = _as_bool(pred)
    if p.numel() != 1:
        raise ValueError(f"predicate must be a scalar, got shape "
                         f"{tuple(p.shape)}")
    return bool(p.reshape(()))


def buffers_of(module: torch.nn.Module) -> list:
    """(owner, name, tensor) of every buffer under ``module``: what
    ``restore_buffers`` binds back.  The port's layers bind new buffer
    tensors when they update them, so keeping the old tensors keeps
    their values."""
    return [(m, n, b) for m in module.modules()
            for n, b in m._buffers.items() if b is not None]


def restore_buffers(kept: list) -> None:
    for m, n, b in kept:
        if m._buffers.get(n) is not b:
            m._buffers[n] = b


class SwitchOps(AbstractModule):
    """TF ``Switch``: ``(data, pred)`` -> ``(data, data)``; element 1
    feeds the false branch, element 2 the true branch (select
    semantics: both run)."""

    def forward(self, input):
        data, pred = input
        return (data, data)


class MergeOps(AbstractModule):
    """TF ``Merge`` under select semantics: ``(false_data, true_data,
    pred)`` -> ``where(pred, true_data, false_data)``.  The TF loader
    wires the controlling Switch's predicate in."""

    def forward(self, input):
        false_data, true_data, pred = input
        return torch.where(_as_bool(pred, true_data), true_data, false_data)


class IfElse(Container):
    """``(pred, data)`` -> ``then_module(data)`` when ``pred`` else
    ``else_module(data)``; one branch runs.  Both branches get the
    dropout seed ``fold_in(rng_seed, 0)``, as JAX hands both
    ``fold_in(rng, 0)``.  The branches' buffers are left as they were."""

    def __init__(self, then_module: Optional[AbstractModule] = None,
                 else_module: Optional[AbstractModule] = None):
        super().__init__()
        if then_module is not None:
            self.add(then_module)
        if else_module is not None:
            self.add(else_module)

    def forward(self, input, rng_seed: Optional[int] = None):
        pred, data = input
        then_m, else_m = self._modules["0"], self._modules["1"]
        m = then_m if _host_bool(pred) else else_m
        kept = buffers_of(self)
        seed = None if rng_seed is None else fold_in(rng_seed, 0)
        out = m(data, rng_seed=seed) if m.takes_rng_seed else m(data)
        restore_buffers(kept)
        return out

    def extra_repr(self):
        return "then, else"


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class _ForwardOnly(torch.autograd.Function):
    """Identity on ``out`` that ties it to ``deps`` (the loop's inputs
    and parameters that take gradients) and raises in the backward."""

    @staticmethod
    def forward(ctx, out, *deps):
        return out.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "WhileLoop is forward only: reverse-mode differentiation of "
            "an unbounded while loop is undefined (JAX's lax.while_loop "
            "refuses it too); use DynamicGraph with max_iterations")


class WhileLoop(Container):
    """``while cond_module(carry): carry = body_module(carry)``, on the
    host, from the input carry.  ``cond_module`` returns a scalar;
    ``body_module`` a carry of the same structure.  The children run
    without a dropout seed (JAX passes ``rng=None``) and their buffers
    are left as they were.  Forward only: a backward pass through the
    output raises."""

    def __init__(self, cond_module: Optional[AbstractModule] = None,
                 body_module: Optional[AbstractModule] = None):
        super().__init__()
        if cond_module is not None:
            self.add(cond_module)
        if body_module is not None:
            self.add(body_module)

    def forward(self, input):
        cond_m, body_m = self._modules["0"], self._modules["1"]
        kept = buffers_of(self)
        with torch.no_grad():
            carry = input
            while _host_bool(cond_m(carry)):
                carry = body_m(carry)
        restore_buffers(kept)
        if not torch.is_grad_enabled():
            return carry
        deps = [t for t in _leaves(input) + list(self.parameters())
                if t.requires_grad]
        if not deps:
            return carry
        return _map(lambda t: _ForwardOnly.apply(t, *deps)
                    if t.is_floating_point() else t, carry)

    def extra_repr(self):
        return "cond, body"


class LoopCondition(AbstractModule):
    """TF ``LoopCond``: passes its scalar input through; the enclosing
    ``DynamicGraph`` stops iterating once it is false."""

    def forward(self, input):
        return input


class NextIteration(AbstractModule):
    """TF ``NextIteration``, the feedback edge of a cycle: wired after
    its initial value, with its feedback source attached by
    ``node.feedback_from(src)``.  Iteration 0 emits the initial value;
    iteration t > 0 the source's value from iteration t - 1."""

    def forward(self, input):
        return input


__all__ = ["SwitchOps", "MergeOps", "IfElse", "WhileLoop", "LoopCondition",
           "NextIteration"]
