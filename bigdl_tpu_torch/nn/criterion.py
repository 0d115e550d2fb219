"""Criterions: negative log-likelihood, cross-entropy, mean squared
error and the per-step wrapper of sequence models.

Counterpart of ``bigdl_tpu/nn/criterion.py``: ``ClassNLLCriterion``
(:61), ``CrossEntropyCriterion`` (:100), ``MSECriterion`` (:115) and
``TimeDistributedCriterion`` (:347).  Class targets are
**1-based**; ``size_average`` divides by the summed target weights;
targets equal to ``padding_value`` weigh zero.  ``loss(input, target)``
is the pure scalar loss; gradients come from autograd.
"""

from __future__ import annotations

import numpy as np
import torch


class AbstractCriterion:
    def __init__(self):
        self.output = None

    def loss(self, input, target):
        raise NotImplementedError

    def forward(self, input, target):
        self.output = self.loss(input, target)
        return self.output

    __call__ = forward

    def __repr__(self):
        return type(self).__name__


class ClassNLLCriterion(AbstractCriterion):
    """NLL over log-probabilities (or probabilities when
    ``log_prob_as_input=False``) and 1-based targets."""

    def __init__(self, weights=None, size_average: bool = True,
                 log_prob_as_input: bool = True, padding_value: int = -1):
        super().__init__()
        self.weights = None if weights is None else np.asarray(weights,
                                                               np.float32)
        self.size_average = size_average
        self.log_prob_as_input = log_prob_as_input
        self.padding_value = padding_value

    def loss(self, input, target):
        logp = input if self.log_prob_as_input else torch.log(input + 1e-8)
        target = torch.as_tensor(target, device=logp.device)
        t = target.reshape(-1).to(torch.int32)
        logp2 = logp.reshape(-1, logp.shape[-1])
        valid = t != self.padding_value
        idx = torch.clamp(t - 1, 0, logp2.shape[-1] - 1).long()
        picked = torch.gather(logp2, 1, idx[:, None])[:, 0]
        if self.weights is not None:
            w = torch.as_tensor(self.weights, device=logp.device)[idx]
        else:
            w = torch.ones_like(picked)
        w = torch.where(valid, w, torch.zeros_like(w))
        total = -torch.sum(w * picked)
        if self.size_average:
            total = total / torch.clamp_min(torch.sum(w), 1e-8)
        return total


class CrossEntropyCriterion(AbstractCriterion):
    """Log-softmax + ``ClassNLLCriterion`` on raw logits."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self._nll = ClassNLLCriterion(weights=weights,
                                      size_average=size_average)

    def loss(self, input, target):
        return self._nll.loss(torch.log_softmax(input, dim=-1), target)


class MSECriterion(AbstractCriterion):
    """Mean (or, without ``size_average``, summed) squared error."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, input, target):
        d = input - torch.as_tensor(target, device=input.device)
        return torch.mean(d * d) if self.size_average else torch.sum(d * d)


class TimeDistributedCriterion(AbstractCriterion):
    """The inner criterion over every timestep: the time dim (1-based
    ``dimension``, default 2, i.e. (batch, time, ...)) is folded into
    the batch, the per-step losses are summed, and ``size_average``
    divides by the number of steps.  An averaging inner criterion
    already gives (1/T)·Σ_t, so it is scaled back by T when
    ``size_average`` is off (JAX :347-370)."""

    def __init__(self, critrn, size_average: bool = False,
                 dimension: int = 2):
        super().__init__()
        self.criterion = critrn
        self.size_average = size_average
        self.dimension = dimension

    def loss(self, input, target):
        d = self.dimension - 1
        nstep = input.shape[d]
        target = torch.as_tensor(target, device=input.device)
        if d == 1:
            input = input.reshape((-1,) + tuple(input.shape[2:]))
            target = target.reshape((-1,) + tuple(target.shape[2:]))
        inner = self.criterion.loss(input, target)
        if getattr(self.criterion, "size_average", False):
            return inner if self.size_average else inner * nstep
        return inner / nstep if self.size_average else inner


__all__ = ["AbstractCriterion", "ClassNLLCriterion", "CrossEntropyCriterion",
           "MSECriterion",
           "TimeDistributedCriterion"]
