"""Optimization methods and learning-rate schedules.

Counterpart of ``bigdl_tpu/optim/optim_method.py``: ``OptimMethod``
(:241, ``init_state``), ``SGD`` (:438) and the schedules ``Default``
(:59), ``MultiStep`` (:92), ``Warmup`` (:143) and
``SequentialSchedule`` (:155).

``step(grads, params, state) -> (new_params, new_state)`` is pure, as
in the JAX package, over lists of tensors (the model's parameters in
``named_parameters`` order).  The counters in the state (``neval``,
``epoch``) are 0-d f32 tensors on the parameters' device, so the rate
of a schedule is computed on the device and a step never waits for
the host.
"""

from __future__ import annotations

from typing import List, Optional

import torch


class LearningRateSchedule:
    def rate(self, lr0, state):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval · learningrate_decay), the reference default."""

    def rate(self, lr0, state):
        return lr0 / (1.0 + state["neval"] * state["lr_decay"])


class MultiStep(LearningRateSchedule):
    """Decay by ``gamma`` at each iteration milestone."""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def rate(self, lr0, state):
        n = state["neval"]
        k = sum((n >= float(s)).float() for s in self.step_sizes)
        return lr0 * self.gamma ** torch.as_tensor(k, dtype=torch.float32,
                                                   device=n.device)


class Warmup(LearningRateSchedule):
    """Linear ramp: lr0 + neval · delta."""

    def __init__(self, delta: float):
        self.delta = delta

    def rate(self, lr0, state):
        return lr0 + state["neval"] * self.delta


class SequentialSchedule(LearningRateSchedule):
    """Run schedule i for its ``max_iteration`` steps, then hand over to
    the next with ``neval`` offset by the steps before it."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.schedules = []  # (schedule, duration)
        self.iteration_per_epoch = iteration_per_epoch

    def add(self, schedule: LearningRateSchedule, max_iteration: int):
        self.schedules.append((schedule, max_iteration))
        return self

    def rate(self, lr0, state):
        n = state["neval"]
        rate = None
        offset = 0.0
        for sched, dur in self.schedules:
            sub = dict(state)
            sub["neval"] = torch.clamp_min(n - offset, 0.0)
            r = torch.as_tensor(sched.rate(lr0, sub), dtype=torch.float32,
                                device=n.device)
            rate = r if rate is None else torch.where(n >= offset, r, rate)
            offset += dur
        return rate if rate is not None else lr0


def _scalar(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


class OptimMethod:
    """Base class: a pure ``step`` over lists of tensors, and the state
    table it carries between steps."""

    def __init__(self):
        self.state = None

    def init_state(self, params: List[torch.Tensor]) -> dict:
        dev = params[0].device if params else torch.device("cpu")
        return {
            "neval": _scalar(0.0, dev),
            "epoch": _scalar(0.0, dev),
            "lr_decay": _scalar(getattr(self, "learningrate_decay", 0.0),
                                dev),
            "lr_scale": _scalar(1.0, dev),
            **self._extra_state(params),
        }

    def _extra_state(self, params) -> dict:
        return {}

    def current_rate(self, state):
        sched = getattr(self, "learningrate_schedule", None) or Default()
        return sched.rate(self.learningrate, state)

    def step(self, grads, params, state):
        raise NotImplementedError


class SGD(OptimMethod):
    """SGD with momentum, dampening, Nesterov, weight decay and a
    learning-rate schedule (JAX ``SGD``)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learningrate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("nesterov requires momentum > 0 and "
                             "dampening = 0 (reference check)")
        self.nesterov = nesterov
        self.learningrate_schedule = learningrate_schedule

    def _extra_state(self, params):
        if self.momentum > 0:
            return {"velocity": [torch.zeros_like(p) for p in params]}
        return {}

    def step(self, grads, params, state):
        lr = self.current_rate(state)
        wd, mom, damp = self.weightdecay, self.momentum, self.dampening
        g = [gg + wd * p for gg, p in zip(grads, params)] if wd > 0 \
            else list(grads)
        new_state = dict(state)
        if mom > 0:
            v = [mom * vv + (1.0 - damp) * gg
                 for vv, gg in zip(state["velocity"], g)]
            new_state["velocity"] = v
            g = [gg + mom * vv for gg, vv in zip(g, v)] if self.nesterov \
                else v
        new_params = [p - lr * gg for p, gg in zip(params, g)]
        new_state["neval"] = state["neval"] + 1.0
        return new_params, new_state


__all__ = ["LearningRateSchedule", "Default", "MultiStep", "Warmup",
           "SequentialSchedule", "OptimMethod", "SGD"]
