"""Optimization methods and learning-rate schedules.

Counterpart of ``bigdl_tpu/optim/optim_method.py``: ``OptimMethod``
(:241, ``init_state``), ``SGD`` (:438) and the schedules ``Default``
(:59), ``Poly`` (:69), ``MultiStep`` (:92), ``Warmup`` (:143),
``SequentialSchedule`` (:155) and ``Plateau`` (:184).

``step(grads, params, state) -> (new_params, new_state)`` is pure, as
in the JAX package, over lists of tensors (the model's parameters in
the JAX package's leaf order, ``utils/tree.py``).  The counters in the
state (``neval``, ``epoch``) are 0-d f32 tensors on the parameters'
device, so the rate of a schedule is computed on the device and a step
never waits for the host.

Checkpoint support (JAX :292-400): ``get_state_arrays`` flattens the
state to the JAX package's ``/``-joined npz keys, a per-parameter list
through ``param_tree`` (the trainer's parameter tree, each leaf the
list position of that parameter), so ``velocity/0/bias`` names the
same array in both packages; ``load_state_arrays`` gives the nested
dict back, which a trainer turns into its list when it starts;
``save``/``load`` write and rebuild a whole method.
"""

from __future__ import annotations

import json
import pickle
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils import tree as T


class LearningRateSchedule:
    def rate(self, lr0, state):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval · learningrate_decay), the reference default."""

    def rate(self, lr0, state):
        return lr0 / (1.0 + state["neval"] * state["lr_decay"])


class Poly(LearningRateSchedule):
    """lr0 · (1 − min(neval / max_iteration, 1)) ** power (JAX :69-78,
    the Inception recipe's decay)."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def rate(self, lr0, state):
        frac = torch.clamp_max(state["neval"] / self.max_iteration, 1.0)
        return lr0 * (1.0 - frac) ** self.power


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


class Plateau(LearningRateSchedule):
    """Lower the rate by ``factor`` when the monitored validation score
    has not improved by ``epsilon`` for ``patience`` validations.  The
    decision is the host's (it follows validation results): the trainer
    calls ``on_score`` after each validation and writes the scale into
    the state's ``lr_scale``, which the step reads on the device."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min",
                 epsilon: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon = mode, epsilon
        self.cooldown, self.min_lr = cooldown, min_lr
        self._best = None
        self._wait = 0
        self._cooldown_left = 0
        self.scale = 1.0

    def on_score(self, value: float, lr0: float) -> float:
        improved = (
            self._best is None
            or (self.mode == "min" and value < self._best - self.epsilon)
            or (self.mode == "max" and value > self._best + self.epsilon))
        if improved:
            self._best = value
            self._wait = 0
        elif self._cooldown_left > 0:
            self._cooldown_left -= 1
        else:
            self._wait += 1
            if self._wait >= self.patience:
                self.scale = max(self.scale * self.factor,
                                 self.min_lr / max(lr0, 1e-12))
                self._wait = 0
                self._cooldown_left = self.cooldown
        return self.scale

    def rate(self, lr0, state):
        return lr0 * state["lr_scale"]


def _scalar(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


class OptimMethod:
    """Base class: a pure ``step`` over lists of tensors, and the state
    table it carries between steps."""

    def __init__(self):
        self.state = None
        # the parameter tree whose leaves are positions in a per-
        # parameter state list (set by the trainer that built the list)
        self.param_tree = None

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

    # ---- checkpoint support (JAX :292-400) ---------------------------------
    def get_state_arrays(self) -> dict:
        """The state as host arrays under ``/``-joined keys; an empty
        layer slot of a per-parameter tree is kept as
        ``<path>/__emptydict__``."""
        if self.state is None:
            return {}
        out = {}

        def walk(prefix, v):
            if isinstance(v, dict):
                if not v and prefix:
                    out[f"{prefix}/__emptydict__"] = np.zeros(0)
                for k, sub in v.items():
                    walk(f"{prefix}/{k}" if prefix else k, sub)
            elif isinstance(v, (list, tuple)):
                if self.param_tree is None:
                    raise ValueError(
                        f"state entry {prefix!r} is a list but the method "
                        "has no param_tree to name its entries")
                for path, i in T.leaves_with_paths(self.param_tree):
                    out["/".join((prefix,) + path)] = _host(v[i])
                for path in T.empty_paths(self.param_tree):
                    out["/".join((prefix,) + path + ("__emptydict__",))] = \
                        np.zeros(0)
            else:
                out[prefix] = _host(v)

        walk("", self.state)
        return out

    @staticmethod
    def _unflatten_state(arrays: dict) -> dict:
        state: dict = {}
        for key, v in arrays.items():
            parts = key.split("/")
            d = state
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            if parts[-1] == "__emptydict__":
                continue
            d[parts[-1]] = torch.from_numpy(np.array(v, copy=True))
        return state

    def load_state_arrays(self, arrays: dict) -> None:
        """State from ``get_state_arrays``' keys (either package's):
        CPU tensors, per-parameter entries as nested dicts."""
        self.state = self._unflatten_state(arrays)

    _CONTAINER_KEYS = ("__class__", "__hyper__", "__hyper_skipped__",
                       "__meta__")

    def save(self, path: str) -> None:
        """The method's hyperparameters (pickled; ones that cannot be
        are listed and skipped) and its state table, in one npz."""
        hyper, skipped = {}, []
        for k, v in vars(self).items():
            if k == "state":
                continue
            try:
                pickle.dumps(v)
                hyper[k] = v
            except Exception:  # noqa: BLE001 - any unpicklable attribute
                skipped.append(k)
        np.savez(path, __class__=type(self).__name__,
                 __hyper__=np.frombuffer(pickle.dumps(hyper),
                                         dtype=np.uint8).copy(),
                 __hyper_skipped__=np.asarray(skipped, dtype=object),
                 **self.get_state_arrays())

    @staticmethod
    def load(path: str) -> "OptimMethod":
        """Rebuild a method written by ``save``.  A checkpoint's
        ``.optim.npz`` holds no hyperparameters and raises, as does a
        file whose hyperparameters could not be pickled."""
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path, allow_pickle=True)
        if "__class__" not in data.files:
            if "__meta__" in data.files:
                name = json.loads(bytes(data["__meta__"]).decode())["class"]
                raise ValueError(
                    f"{path} is a checkpoint's optimizer state (class "
                    f"{name}, no hyperparameters): build the method and "
                    "use load_checkpoint or load_state_arrays")
            raise ValueError(f"{path} is not an OptimMethod.save file")
        skipped = [str(s) for s in data["__hyper_skipped__"].tolist()]
        if skipped:
            raise ValueError(f"{path}: hyperparameters {skipped} could not "
                             "be pickled at save time")

        def subclasses(cls):
            out = {}
            for sub in cls.__subclasses__():
                out[sub.__name__] = sub
                out.update(subclasses(sub))
            return out

        name = str(data["__class__"])
        klass = subclasses(OptimMethod).get(name)
        if klass is None:
            raise ValueError(f"unknown OptimMethod class {name!r}")
        obj = klass.__new__(klass)
        vars(obj).update(pickle.loads(data["__hyper__"].tobytes()))
        state = OptimMethod._unflatten_state(
            {k: data[k] for k in data.files
             if k not in OptimMethod._CONTAINER_KEYS})
        obj.state = state or None
        return obj


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


__all__ = ["LearningRateSchedule", "Default", "Poly", "MultiStep", "Warmup",
           "SequentialSchedule", "Plateau", "OptimMethod", "SGD"]
