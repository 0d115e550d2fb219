"""Criterions: every loss of the JAX package.

Counterpart of ``bigdl_tpu/nn/criterion.py``: ``ClassNLLCriterion``
(:61), ``CrossEntropyCriterion`` (:100), ``MSECriterion`` (:115),
``TimeDistributedCriterion`` (:347) and the rest (:127-636), each cited
by line in its docstring.  Class targets are **1-based**; for
``ClassNLLCriterion`` ``size_average`` divides by the summed target
weights and targets equal to ``padding_value`` weigh zero.
``loss(input, target)`` is the pure scalar loss on tensors, a table
input or target being a tuple; gradients come from autograd.  Each
formula is JAX's, written out where a torch loss differs (the BCE
family's ``log(p + 1e-12)``, JAX's approximate class simplex).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _input_tensors(x):
    """The input with its numpy arrays as tensors, a table kept a table."""
    from bigdl_tpu_torch.nn.module import _map_input
    from bigdl_tpu_torch.tensor import unwrap

    return _map_input(lambda t: torch.as_tensor(t) if isinstance(
        t, np.ndarray) else t, unwrap(x))


def _grad_leaf(t):
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach()
    return t.requires_grad_(True) if t.is_floating_point() else t


class AbstractCriterion:
    def __init__(self):
        self.output = None
        self.grad_input = None

    def loss(self, input, target):
        raise NotImplementedError

    def forward(self, input, target):
        """The loss; a ``Tensor`` facade argument is unwrapped."""
        from bigdl_tpu_torch.tensor import unwrap

        self.output = self.loss(_input_tensors(input), unwrap(target))
        return self.output

    __call__ = forward
    updateOutput = forward

    def backward(self, input, target):
        """The loss's gradient in its input (JAX ``backward``, the
        ``jax.grad`` of ``loss``), as ``self.grad_input``: a table input
        gives a table, an integer tensor's entry is ``None``.  The
        gradient is taken on a detached copy of the input, so no graph
        that made the input is touched."""
        from bigdl_tpu_torch.nn.module import _input_leaves, _map_input
        from bigdl_tpu_torch.tensor import unwrap

        x = _map_input(_grad_leaf, _input_tensors(input))
        wrt = [t for t in _input_leaves(x)
               if isinstance(t, torch.Tensor) and t.requires_grad]
        with torch.enable_grad():
            loss = self.loss(x, unwrap(target))
        got = torch.autograd.grad(loss, wrt, allow_unused=True) \
            if wrt and loss.requires_grad else [None] * len(wrt)
        by_id = {id(t): g for t, g in zip(wrt, got)}

        def grad_of(t):
            if not (isinstance(t, torch.Tensor) and t.requires_grad):
                return None
            g = by_id.get(id(t))
            return torch.zeros_like(t) if g is None else g

        self.grad_input = _map_input(grad_of, x)
        return self.grad_input

    updateGradInput = backward

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


# ---- the rest of the JAX criterions (JAX :127-636) --------------------------
def _like(target, x):
    """``target`` as a tensor on x's device (a tensor passes through)."""
    return torch.as_tensor(target, device=x.device)


def _reduce(v, size_average: bool):
    return torch.mean(v) if size_average else torch.sum(v)


def _maximum(x, v: float):
    """``jnp.maximum(x, v)``: a tie splits the gradient half and half,
    where ``clamp_min`` gives it all to x."""
    return torch.maximum(x, x.new_tensor(v))


def _weights(weights):
    return None if weights is None else np.asarray(weights, np.float32)


def _bce(p, t, weights, size_average, eps=1e-12):
    """``-(t·log(p + eps) + (1 - t)·log(1 - p + eps))``, weighted and
    reduced: JAX's ``log(p + 1e-12)`` (torch's BCE clamps the log at
    -100 instead, which differs at p = 0 and p = 1)."""
    v = -(t * torch.log(p + eps) + (1.0 - t) * torch.log(1.0 - p + eps))
    if weights is not None:
        v = v * torch.as_tensor(weights, device=p.device)
    return _reduce(v, size_average)


class AbsCriterion(AbstractCriterion):
    """Mean (or summed) |x - t| (JAX :127)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, input, target):
        return _reduce(torch.abs(input - _like(target, input)),
                       self.size_average)


class SmoothL1Criterion(AbstractCriterion):
    """``0.5·d²`` below |d| = 1, ``|d| - 0.5`` above (JAX :138)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, input, target):
        d = torch.abs(input - _like(target, input))
        return _reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                       self.size_average)


class BCECriterion(AbstractCriterion):
    """Binary cross-entropy on probabilities (JAX :152), the log taken
    of ``p + 1e-12`` as JAX does (``_bce``)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def loss(self, input, target):
        return _bce(input, _like(target, input), self.weights,
                    self.size_average)


class BCECriterionWithLogits(AbstractCriterion):
    """Sigmoid + BCE in the stable form ``max(x, 0) - x·t +
    log1p(exp(-|x|))`` (JAX :172)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, input, target):
        t = _like(target, input)
        v = _maximum(input, 0.0) - input * t + torch.log1p(
            torch.exp(-torch.abs(input)))
        return _reduce(v, self.size_average)


class MultiLabelSoftMarginCriterion(AbstractCriterion):
    """``_bce`` of ``sigmoid(x)`` (JAX :186)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def loss(self, input, target):
        return _bce(torch.sigmoid(input), _like(target, input),
                    self.weights, self.size_average)


class MarginCriterion(AbstractCriterion):
    """Hinge ``max(0, margin - x·t)`` on ±1 targets, squared with
    ``squared`` (JAX :206)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared=False):
        super().__init__()
        self.margin, self.size_average, self.squared = (margin, size_average,
                                                        squared)

    def loss(self, input, target):
        v = _maximum(self.margin - input * _like(target, input), 0.0)
        return _reduce(v * v if self.squared else v, self.size_average)


class HingeEmbeddingCriterion(AbstractCriterion):
    """x where t > 0, else ``max(0, margin - x)`` (JAX :222)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin, self.size_average = margin, size_average

    def loss(self, input, target):
        v = torch.where(_like(target, input) > 0, input,
                        _maximum(self.margin - input, 0.0))
        return _reduce(v, self.size_average)


class DistKLDivCriterion(AbstractCriterion):
    """``t·(log(t + 1e-12) - x)`` where t > 0 (x log-probabilities, t
    probabilities) (JAX :238)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, input, target):
        t = _like(target, input)
        v = torch.where(t > 0, t * (torch.log(t + 1e-12) - input),
                        torch.zeros_like(input))
        return _reduce(v, self.size_average)


def _cos_rows(a, b):
    """Cosine of each last-dim row pair, the norms' product at least
    1e-12."""
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    return torch.sum(a * b, dim=-1) / _maximum(na * nb, 1e-12)


class CosineEmbeddingCriterion(AbstractCriterion):
    """``1 - cos`` where t > 0, else ``max(0, cos - margin)``, over the
    table (x1, x2) (JAX :252)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin, self.size_average = margin, size_average

    def loss(self, input, target):
        x1, x2 = input
        cos = _cos_rows(x1, x2)
        t = _like(target, x1).reshape(cos.shape)
        v = torch.where(t > 0, 1.0 - cos, _maximum(cos - self.margin, 0.0))
        return _reduce(v, self.size_average)


class SoftmaxWithCriterion(AbstractCriterion):
    """Caffe's SoftmaxWithLoss (JAX :271): log-softmax over dim 2 (the
    channels of NCHW), NLL of the 1-based targets, ``ignore_label``
    targets weighing zero; ``normalize_mode`` VALID divides by the
    counted targets (at least 1), FULL by all, BATCH_SIZE by N, any
    other (NONE) by nothing."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode="VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def loss(self, input, target):
        logp = torch.log_softmax(torch.movedim(input, 1, -1), dim=-1)
        t = _like(target, input).to(torch.int64).reshape(logp.shape[:-1])
        idx = torch.clamp(t - 1, 0, logp.shape[-1] - 1)
        picked = torch.gather(logp, -1, idx[..., None])[..., 0]
        if self.ignore_label is not None:
            mask = (t != self.ignore_label).to(logp.dtype)
        else:
            mask = torch.ones_like(picked)
        total = -torch.sum(picked * mask)
        if self.normalize_mode == "VALID":
            return total / _maximum(torch.sum(mask), 1.0)
        if self.normalize_mode == "FULL":
            return total / picked.numel()
        if self.normalize_mode == "BATCH_SIZE":
            return total / input.shape[0]
        return total


class MultiCriterion(AbstractCriterion):
    """Weighted sum of criterions on the same (input, target) (JAX
    :303)."""

    def __init__(self):
        super().__init__()
        self.criterions = []
        self.weights = []

    def add(self, criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def loss(self, input, target):
        total = 0.0
        for c, w in zip(self.criterions, self.weights):
            total = total + w * c.loss(input, target)
        return total


class ParallelCriterion(MultiCriterion):
    """Criterion i on table entry i of input and target, weighted and
    summed; ``repeat_target`` gives each the whole target (JAX :324)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.repeat_target = repeat_target

    def loss(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.weights)):
            t = target if self.repeat_target else target[i]
            total = total + w * c.loss(input[i], t)
        return total


class ClassSimplexCriterion(AbstractCriterion):
    """MSE against the simplex embedding of the 1-based class (JAX
    :372), with JAX's own approximate simplex (``_build_simplex``)."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        self._simplex = self._build_simplex(n_classes)

    @staticmethod
    def _build_simplex(n):
        """JAX's construction, step for step: row k + 1 is the mean of
        rows 0..k with its k-th entry kept, then rows 1.. are scaled to
        unit norm."""
        a = np.zeros((n, n), dtype=np.float32)
        for k in range(n - 1):
            a[k, k] = 1.0
            s = np.sum(a[: k + 1, :], axis=0) / (k + 1)
            a[k + 1, :] = s
            a[k + 1, k] = s[k]
        for k in range(1, n):
            a[k] = a[k] / max(np.linalg.norm(a[k]), 1e-8)
        return a

    def loss(self, input, target):
        idx = _like(target, input).to(torch.int64).reshape(-1) - 1
        d = input - torch.as_tensor(self._simplex, device=input.device)[idx]
        return torch.mean(d * d)


class L1Cost(AbstractCriterion):
    """Σ |x|; the target is not read (JAX :405)."""

    def loss(self, input, target):
        return torch.sum(torch.abs(input))


class MarginRankingCriterion(AbstractCriterion):
    """``max(0, -t·(x1 - x2) + margin)`` over the table (x1, x2), t = ±1
    (JAX :412)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin, self.size_average = margin, size_average

    def loss(self, input, target):
        x1, x2 = input
        t = target
        if hasattr(target, "reshape"):
            t = _like(target, x1).reshape(x1.shape)
        v = _maximum(-t * (x1 - x2) + self.margin, 0.0)
        return _reduce(v, self.size_average)


class MultiMarginCriterion(AbstractCriterion):
    """Multi-class hinge on 1-based targets (JAX :428): Σ over the other
    classes of ``max(0, margin - x[t] + x[j])`` (squared at p = 2,
    weighted by the target's class weight), over the class count."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        self.p, self.margin, self.size_average = p, margin, size_average
        self.weights = _weights(weights)

    def loss(self, input, target):
        x = input.reshape(-1, input.shape[-1])
        t = _like(target, x).to(torch.int64).reshape(-1) - 1
        correct = torch.gather(x, 1, t[:, None])
        v = _maximum(self.margin - correct + x, 0.0)
        if self.p == 2:
            v = v * v
        if self.weights is not None:
            v = v * torch.as_tensor(self.weights, device=x.device)[t][:, None]
        mask = torch.ones_like(v).scatter(1, t[:, None], 0.0)
        per_sample = torch.sum(v * mask, dim=1) / x.shape[-1]
        return _reduce(per_sample, self.size_average)


class CosineDistanceCriterion(AbstractCriterion):
    """``1 - cos(x, t)`` per row (JAX :454)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, input, target):
        return _reduce(1.0 - _cos_rows(input, _like(target, input)),
                       self.size_average)


class DiceCoefficientCriterion(AbstractCriterion):
    """``1 - 2·Σxy / (Σx + Σy + epsilon)`` per sample (JAX :472)."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.size_average = size_average
        self.epsilon = epsilon

    def loss(self, input, target):
        x = input.reshape(input.shape[0], -1)
        y = _like(target, x).reshape(input.shape[0], -1).to(x.dtype)
        inter = torch.sum(x * y, dim=1)
        denom = torch.sum(x, dim=1) + torch.sum(y, dim=1) + self.epsilon
        return _reduce(1.0 - 2.0 * inter / denom, self.size_average)


class SoftMarginCriterion(AbstractCriterion):
    """``log(1 + exp(-t·x))`` on ±1 targets (JAX :490), as
    ``logaddexp(-t·x, 0)`` (``jax.nn.softplus``; ``F.softplus`` turns
    linear above 20)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, input, target):
        z = -input * _like(target, input)
        return _reduce(torch.logaddexp(z, z.new_zeros(())),
                       self.size_average)


class MultiLabelMarginCriterion(AbstractCriterion):
    """Multi-label hinge (JAX :505): each row's targets are 1-based
    classes, and the list ends at the first 0 (a nonzero entry after it
    is ignored); row loss Σ_{j∉T} Σ_{i∈T} max(0, 1 - (x[t_i] - x[j]))
    / C."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def loss(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = _like(target, x)
        t = (t if t.dim() == 2 else t[None]).to(torch.int64)
        n, c = x.shape
        valid = torch.cumprod((t > 0).to(torch.int64), dim=1).bool()
        idx = torch.clamp(t - 1, 0, c - 1)
        # member[n, j] = 1 when class j is one of row n's targets
        member = torch.zeros((n, c), dtype=x.dtype, device=x.device)
        member = member.scatter_reduce(1, idx, valid.to(x.dtype), "amax")
        picked = torch.gather(x, 1, idx)                  # x[t_i]
        hinge = _maximum(1.0 - picked[:, :, None] + x[:, None, :], 0.0)
        mask = valid[:, :, None].to(x.dtype) * (1.0 - member)[:, None, :]
        per_row = torch.sum(hinge * mask, dim=(1, 2)) / c
        return _reduce(per_row, self.size_average)


class GaussianCriterion(AbstractCriterion):
    """Σ of the negative log-likelihood of t under N(mean,
    exp(log_var)), the input the table (mean, log_var) (JAX :540)."""

    def loss(self, input, target):
        mean, log_var = input
        t = _like(target, mean)
        return torch.sum(0.5 * (math.log(2 * math.pi) + log_var
                                + (t - mean) ** 2 / torch.exp(log_var)))


class KLDCriterion(AbstractCriterion):
    """Σ KL(N(mean, exp(log_var)) ‖ N(0, 1)) over the table (mean,
    log_var); the target is not read (JAX :555)."""

    def loss(self, input, target):
        mean, log_var = input
        return torch.sum(-0.5 * (1.0 + log_var - mean ** 2
                                 - torch.exp(log_var)))


class L1HingeEmbeddingCriterion(AbstractCriterion):
    """d = ‖x1 - x2‖₁ over the table (x1, x2): the mean of d where
    t > 0, else of ``max(0, margin - d)`` (JAX :567)."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def loss(self, input, target):
        x1, x2 = input
        d = torch.sum(torch.abs(x1 - x2), dim=-1)
        t = _like(target, x1).reshape(d.shape)
        return torch.mean(torch.where(t > 0, d,
                                      _maximum(self.margin - d, 0.0)))


class PoissonCriterion(AbstractCriterion):
    """Mean of ``x - t·log(max(x, 1e-7))`` (JAX :585)."""

    def loss(self, input, target):
        t = _like(target, input).reshape(input.shape)
        return torch.mean(input - t * torch.log(_maximum(input, 1e-7)))


class CosineProximityCriterion(AbstractCriterion):
    """``-mean(l2norm(x) · l2norm(t))`` over all elements, Keras's
    cosine_proximity (JAX :595); the norms as ``rsqrt(Σ + 1e-12)``, so
    an all-zero row has a finite gradient."""

    def loss(self, input, target):
        t = _like(target, input).reshape(input.shape)
        xn = input * torch.rsqrt(
            torch.sum(input * input, dim=-1, keepdim=True) + 1e-12)
        tn = t * torch.rsqrt(torch.sum(t * t, dim=-1, keepdim=True) + 1e-12)
        return -torch.mean(xn * tn)


class MeanAbsolutePercentageCriterion(AbstractCriterion):
    """``100 · mean(|t - x| / max(|t|, 1e-7))`` (JAX :616)."""

    def loss(self, input, target):
        t = _like(target, input).reshape(input.shape)
        return 100.0 * torch.mean(torch.abs(t - input)
                                  / _maximum(torch.abs(t), 1e-7))


class MeanSquaredLogarithmicCriterion(AbstractCriterion):
    """Mean of ``(log(max(t, 1e-7) + 1) - log(max(x, 1e-7) + 1))²``
    (JAX :627)."""

    def loss(self, input, target):
        t = _like(target, input).reshape(input.shape)
        lp = torch.log(_maximum(input, 1e-7) + 1.0)
        lt = torch.log(_maximum(t, 1e-7) + 1.0)
        return torch.mean((lt - lp) ** 2)


__all__ = ["AbstractCriterion", "ClassNLLCriterion", "CrossEntropyCriterion",
           "MSECriterion", "TimeDistributedCriterion", "AbsCriterion",
           "SmoothL1Criterion", "BCECriterion", "BCECriterionWithLogits",
           "MultiLabelSoftMarginCriterion", "MarginCriterion",
           "HingeEmbeddingCriterion", "DistKLDivCriterion",
           "CosineEmbeddingCriterion", "SoftmaxWithCriterion",
           "MultiCriterion", "ParallelCriterion", "ClassSimplexCriterion",
           "L1Cost", "MarginRankingCriterion", "MultiMarginCriterion",
           "CosineDistanceCriterion", "DiceCoefficientCriterion",
           "SoftMarginCriterion", "MultiLabelMarginCriterion",
           "GaussianCriterion", "KLDCriterion", "L1HingeEmbeddingCriterion",
           "PoissonCriterion", "CosineProximityCriterion",
           "MeanAbsolutePercentageCriterion",
           "MeanSquaredLogarithmicCriterion"]
