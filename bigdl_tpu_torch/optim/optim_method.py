"""Optimization methods and learning-rate schedules.

Counterpart of ``bigdl_tpu/optim/optim_method.py``: ``OptimMethod``
(:241, ``init_state``), ``SGD`` (:438), ``Adam`` (:488), ``Adagrad``
(:528), ``Adadelta`` (:553), ``Adamax`` (:591), ``RMSprop`` (:622),
``Ftrl`` (:649), ``LBFGS`` (:717), ``LarsSGD`` (:852) and the schedules
``Default`` (:59), ``Poly`` (:69), ``Step`` (:81), ``MultiStep`` (:92),
``Exponential`` (:106), ``EpochDecay`` (:124), ``Warmup`` (:143),
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


class Step(LearningRateSchedule):
    """lr0 · gamma ** floor(neval / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def rate(self, lr0, state):
        return lr0 * self.gamma ** torch.floor(state["neval"]
                                               / self.step_size)


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


class Exponential(LearningRateSchedule):
    """lr0 · decay_rate ** (neval / decay_step), the exponent floored
    with ``stair_case``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def rate(self, lr0, state):
        e = state["neval"] / self.decay_step
        if self.stair_case:
            e = torch.floor(e)
        return lr0 * self.decay_rate ** e


class EpochDecay(LearningRateSchedule):
    """lr0 · 0.1 ** decay_fn(epoch), the host function tabulated for
    epochs 0-999 and the table indexed on the device by the state's
    epoch, clipped to 999 (JAX :124-140)."""

    _EPOCHS = 1000

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def rate(self, lr0, state):
        values = getattr(self, "_values", None)
        if values is None:
            values = self._values = tuple(
                0.1 ** float(self.decay_fn(e)) for e in range(self._EPOCHS))
        epoch = state["epoch"]
        table = torch.tensor(values, dtype=torch.float32,
                             device=epoch.device)
        return lr0 * table[torch.clamp(epoch.long(), 0, self._EPOCHS - 1)]


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

    def per_param_keys(self) -> frozenset:
        """The state entries that hold one tensor per parameter (a list
        in ``init_state``'s result), read off a one-element template."""
        return frozenset(k for k, v in self._extra_state(
            [torch.zeros(1)]).items() if isinstance(v, list))

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


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _dot(a, b):
    """Σ over the tensors of Σ a·b (a 0-d tensor)."""
    return sum(torch.sum(x * y) for x, y in zip(a, b))


class Adam(OptimMethod):
    """Adam with bias correction (JAX :488)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.learningrate_schedule = None

    def _extra_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def step(self, grads, params, state):
        lr = self.current_rate(state)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = state["neval"] + 1.0
        m = [b1 * mm + (1 - b1) * g for mm, g in zip(state["m"], grads)]
        v = [b2 * vv + (1 - b2) * g * g for vv, g in zip(state["v"], grads)]
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        new_p = [p - lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
                 for p, mm, vv in zip(params, m, v)]
        return new_p, {**state, "m": m, "v": v, "neval": t}


class Adagrad(OptimMethod):
    """Adagrad with weight decay (JAX :528)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay
        self.learningrate_schedule = None

    def _extra_state(self, params):
        return {"accum": _zeros(params)}

    def step(self, grads, params, state):
        lr = self.current_rate(state)
        wd = self.weightdecay
        g = [gg + wd * p for gg, p in zip(grads, params)] if wd > 0 \
            else list(grads)
        accum = [a + gg * gg for a, gg in zip(state["accum"], g)]
        new_p = [p - lr * gg / (torch.sqrt(a) + 1e-10)
                 for p, gg, a in zip(params, g, accum)]
        return new_p, {**state, "accum": accum,
                       "neval": state["neval"] + 1.0}


class Adadelta(OptimMethod):
    """Adadelta (JAX :553); its rate is fixed at 1."""

    def __init__(self, decayrate: float = 0.9, epsilon: float = 1e-10):
        super().__init__()
        self.learningrate = 1.0
        self.learningrate_decay = 0.0
        self.decayrate, self.epsilon = decayrate, epsilon
        self.learningrate_schedule = None

    def _extra_state(self, params):
        return {"accum_g": _zeros(params), "accum_dx": _zeros(params)}

    def step(self, grads, params, state):
        rho, eps = self.decayrate, self.epsilon
        ag = [rho * a + (1 - rho) * g * g
              for a, g in zip(state["accum_g"], grads)]
        dx = [-torch.sqrt(adx + eps) / torch.sqrt(a + eps) * g
              for adx, a, g in zip(state["accum_dx"], ag, grads)]
        adx = [rho * a + (1 - rho) * d * d
               for a, d in zip(state["accum_dx"], dx)]
        return [p + d for p, d in zip(params, dx)], {
            **state, "accum_g": ag, "accum_dx": adx,
            "neval": state["neval"] + 1.0}


class Adamax(OptimMethod):
    """Adamax (JAX :591).  Its default ``epsilon`` of 1e-38 is an f32
    subnormal: torch keeps it, while XLA on the CPU flushes it to 0, so
    where a gradient is exactly 0 from the start this gives a zero
    update and the JAX package 0/0 = NaN (``ROADMAP.md`` queue 3)."""

    def __init__(self, learningrate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = 0.0
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.learningrate_schedule = None

    def _extra_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def step(self, grads, params, state):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = state["neval"] + 1.0
        m = [b1 * mm + (1 - b1) * g for mm, g in zip(state["m"], grads)]
        u = [torch.maximum(b2 * uu, torch.abs(g) + eps)
             for uu, g in zip(state["u"], grads)]
        scale = self.learningrate / (1 - b1 ** t)
        new_p = [p - scale * mm / uu for p, mm, uu in zip(params, m, u)]
        return new_p, {**state, "m": m, "u": u, "neval": t}


class RMSprop(OptimMethod):
    """RMSprop (JAX :622)."""

    def __init__(self, learningrate: float = 1e-2,
                 learningrate_decay: float = 0.0, decayrate: float = 0.99,
                 epsilon: float = 1e-8):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.decayrate, self.epsilon = decayrate, epsilon
        self.learningrate_schedule = None

    def _extra_state(self, params):
        return {"accum": _zeros(params)}

    def step(self, grads, params, state):
        lr = self.current_rate(state)
        dr, eps = self.decayrate, self.epsilon
        accum = [dr * a + (1 - dr) * g * g
                 for a, g in zip(state["accum"], grads)]
        new_p = [p - lr * g / (torch.sqrt(a) + eps)
                 for p, g, a in zip(params, grads, accum)]
        return new_p, {**state, "accum": accum,
                       "neval": state["neval"] + 1.0}


class Ftrl(OptimMethod):
    """FTRL-proximal for sparse and wide models (JAX :649)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 l2_shrinkage_regularization_strength: float = 0.0):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = 0.0
        self.lr_power = learningrate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength
        self.learningrate_schedule = None

    def _extra_state(self, params):
        return {"accum": [torch.full_like(p, self.init_accum)
                          for p in params],
                "linear": _zeros(params)}

    def step(self, grads, params, state):
        lr, lr_power = self.learningrate, self.lr_power
        l1, l2, shrink = self.l1, self.l2, self.l2_shrinkage
        new_p, accums, linears = [], [], []
        for g, p, accum, lin in zip(grads, params, state["accum"],
                                    state["linear"]):
            g_shrink = g + 2 * shrink * p if shrink > 0 else g
            accum_new = accum + g * g
            sigma = (accum_new ** -lr_power - accum ** -lr_power) / lr
            linear = lin + g_shrink - sigma * p
            quad = accum_new ** -lr_power / lr + 2 * l2
            new_p.append(torch.where(
                torch.abs(linear) > l1,
                -(linear - torch.sign(linear) * l1) / quad,
                torch.zeros_like(linear)))
            accums.append(accum_new)
            linears.append(linear)
        return new_p, {**state, "accum": accums, "linear": linears,
                       "neval": state["neval"] + 1.0}


class LBFGS(OptimMethod):
    """Limited-memory BFGS with a fixed step of ``learningrate`` (no
    line search), the two-loop recursion over a history of
    ``ncorrection`` pairs kept as stacked tensors (JAX :717).  The
    history is capped at 16, with a warning when the cap engages, as
    in the JAX package.  ``DistriOptimizer`` runs it at world 1 only
    (``ROADMAP.md`` queue 3)."""

    _NCORRECTION_CAP = 16

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tolfun: float = 1e-5, tolx: float = 1e-9,
                 ncorrection: int = 16, learningrate: float = 1.0,
                 verbose: bool = False, linesearch=None):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = 0.0
        self.max_iter = max_iter
        self.tolfun, self.tolx = tolfun, tolx
        if ncorrection > self._NCORRECTION_CAP:
            import warnings

            warnings.warn(
                f"LBFGS ncorrection={ncorrection} capped at "
                f"{self._NCORRECTION_CAP} (history unrolls into the "
                "compiled step)", stacklevel=2)
        self.ncorrection = min(ncorrection, self._NCORRECTION_CAP)
        self.learningrate_schedule = None

    def _extra_state(self, params):
        m = self.ncorrection
        dev = params[0].device if params else torch.device("cpu")
        return {
            "s_hist": [torch.zeros((m,) + tuple(p.shape), dtype=p.dtype,
                                   device=p.device) for p in params],
            "y_hist": [torch.zeros((m,) + tuple(p.shape), dtype=p.dtype,
                                   device=p.device) for p in params],
            "rho": torch.zeros(m, dtype=torch.float32, device=dev),
            "prev_param": _zeros(params),
            "prev_grad": _zeros(params),
            "hist_len": _scalar(0.0, dev),
        }

    def step(self, grads, params, state):
        m = self.ncorrection
        t = state["neval"]
        # the history takes (s, y) of the previous step
        s = [p - pp for p, pp in zip(params, state["prev_param"])]
        y = [g - pg for g, pg in zip(grads, state["prev_grad"])]
        sy = _dot(s, y)
        valid = (t > 0) & (sy > 1e-10)

        def rolled(hist, new):
            return [torch.where(valid, torch.cat([h[1:], n[None]]), h)
                    for h, n in zip(hist, new)]

        s_hist = rolled(state["s_hist"], s)
        y_hist = rolled(state["y_hist"], y)
        rho = torch.where(valid, torch.cat(
            [state["rho"][1:], (1.0 / torch.clamp_min(sy, 1e-10))[None]]),
            state["rho"])
        hist_len = torch.where(valid,
                               torch.clamp_max(state["hist_len"] + 1, m),
                               state["hist_len"])
        zero = torch.zeros_like(hist_len)
        # the two-loop recursion
        q = list(grads)
        alphas = []
        for i in range(m - 1, -1, -1):
            live = (m - i) <= hist_len
            a_i = torch.where(live, rho[i] * _dot([h[i] for h in s_hist],
                                                  q), zero)
            q = [qq - a_i * yh[i] for qq, yh in zip(q, y_hist)]
            alphas.append((i, a_i, live))
        # the initial Hessian scale sy/yy of the newest pair
        yy = sum(torch.sum(yh[m - 1] ** 2) for yh in y_hist)
        sy_last = torch.where(rho[m - 1] > 0, 1.0 / rho[m - 1],
                              torch.ones_like(rho[m - 1]))
        gamma = torch.where(hist_len > 0,
                            sy_last / torch.clamp_min(yy, 1e-10),
                            torch.ones_like(hist_len))
        r = [gamma * qq for qq in q]
        for i, a_i, live in reversed(alphas):
            b_i = torch.where(live, rho[i] * _dot([h[i] for h in y_hist],
                                                  r), zero)
            r = [rr + (a_i - b_i) * sh[i] for rr, sh in zip(r, s_hist)]
        lr = self.learningrate
        new_p = [p - lr * rr for p, rr in zip(params, r)]
        return new_p, {**state, "s_hist": s_hist, "y_hist": y_hist,
                       # a copy: the trainer writes the parameters in place
                       "rho": rho, "prev_param": [p.clone() for p in params],
                       "prev_grad": list(grads), "hist_len": hist_len,
                       "neval": t + 1.0}


class LarsSGD(SGD):
    """Layer-wise adaptive-rate SGD (JAX :852): each gradient tensor is
    scaled by tc·‖w‖ / (‖g‖ + wd·‖w‖) before the SGD step.  On
    ``DistriOptimizer``'s flat shard that is one ratio per rank's
    shard, as in the JAX package."""

    def __init__(self, learningrate=1e-3, trust_coefficient=0.001, **kw):
        super().__init__(learningrate=learningrate, **kw)
        self.trust_coefficient = trust_coefficient

    def step(self, grads, params, state):
        tc, wd = self.trust_coefficient, self.weightdecay

        def scaled(g, p):
            w_norm = torch.linalg.vector_norm(p)
            g_norm = torch.linalg.vector_norm(g)
            trust = torch.where((w_norm > 0) & (g_norm > 0),
                                tc * w_norm / (g_norm + wd * w_norm + 1e-12),
                                torch.ones_like(w_norm))
            return g * trust

        return super().step([scaled(g, p) for g, p in zip(grads, params)],
                            params, state)


__all__ = ["LearningRateSchedule", "Default", "Poly", "Step", "MultiStep",
           "Exponential", "EpochDecay", "Warmup", "SequentialSchedule",
           "Plateau", "OptimMethod", "SGD", "Adam", "Adagrad", "Adadelta",
           "Adamax", "RMSprop", "Ftrl", "LBFGS", "LarsSGD"]
