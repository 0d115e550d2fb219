"""Deterministic fault injection: the chaos half of the resilience layer.

Counterpart of ``bigdl_tpu/resilience/faults.py`` (the whole module).
A plan in ``BIGDL_TORCH_FAULT_PLAN`` (``TrainConfig.fault_plan``)

    BIGDL_TORCH_FAULT_PLAN="step:3:raise,step:7:nan_grad,ckpt:1:truncate"

injects failures at exact, reproducible points:

* ``step:N:raise``: raise :class:`InjectedFault` (classified
  transient) before iteration ``neval == N`` puts its batch on the
  device;
* ``step:N:nan_grad``: replace iteration N's input batch with NaN, so
  the loss and gradients go non-finite (the non-finite guard's case);
* ``ckpt:K:truncate``: truncate the K-th checkpoint write's
  ``.model.npz`` to half its size (a torn write);
* ``ckpt:K:corrupt``: flip 64 bytes in the middle of the K-th write's
  ``.model.npz`` (bit rot the sha256 manifest must catch);
* ``ckpt:K:delete``: delete the K-th write's ``.model.npz``;
* ``ckpt:K:drop_optim``: delete the K-th write's ``.optim.npz``;
* ``publish:K:<action>``: the same four, applied to the K-th
  ``serving/rollout.publish_checkpoint``, which the rollout watcher's
  verify-before-swap gate must refuse.

Every fault fires once in an injector's life: a retry replays the same
``neval`` range from a checkpoint and must not trip the fault it is
recovering from.  The counters survive retries inside one process;
``Engine.reset()`` and :func:`reset_injector` start a fresh plan.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np

log = logging.getLogger("bigdl_tpu_torch.resilience")

_STEP_ACTIONS = ("raise", "nan_grad")
_CKPT_ACTIONS = ("truncate", "corrupt", "delete", "drop_optim")


class InjectedFault(RuntimeError):
    """A deliberately injected transient failure (retry-classified as
    transient — the whole point is to drive the recovery path)."""


@dataclasses.dataclass
class Fault:
    site: str      # "step" | "ckpt" | "publish"
    index: int     # step: the neval it fires at; ckpt/publish: 1-based
    action: str    # write (publish) count it fires on
    fired: bool = False


class FaultPlan:
    """Parsed, validated fault plan (see module docstring for syntax)."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults = list(faults or [])

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultPlan":
        faults = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) != 3:
                raise ValueError(
                    f"bad fault spec {part!r}: want site:index:action, "
                    f"e.g. 'step:3:raise' (full plan: {spec!r})")
            site, idx, action = fields
            if site not in ("step", "ckpt", "publish"):
                raise ValueError(
                    f"bad fault site {site!r} in {part!r}: "
                    "want 'step', 'ckpt' or 'publish'")
            try:
                index = int(idx)
            except ValueError:
                raise ValueError(
                    f"bad fault index {idx!r} in {part!r}: want an int")
            allowed = (_STEP_ACTIONS if site == "step"
                       else _CKPT_ACTIONS)
            if action not in allowed:
                raise ValueError(
                    f"bad fault action {action!r} for site {site!r} in "
                    f"{part!r}: want one of {allowed}")
            faults.append(Fault(site, index, action))
        return cls(faults)

    def __bool__(self):
        return bool(self.faults)


class FaultInjector:
    """Stateful executor of a :class:`FaultPlan`.

    Hook points: the optimizer step dispatch calls :meth:`on_step` with
    the iteration counter; ``write_checkpoint`` calls
    :meth:`on_checkpoint_write` after the files are durable (so the
    corruption models post-write damage the integrity manifest must
    catch, not a failed write).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._step_faults = [f for f in plan.faults if f.site == "step"]
        self._ckpt_faults = [f for f in plan.faults if f.site == "ckpt"]
        self._publish_faults = [f for f in plan.faults
                                if f.site == "publish"]
        self.ckpt_writes = 0
        self.publish_writes = 0

    @property
    def active(self) -> bool:
        return bool(self.plan)

    # ------------------------------------------------------------- step site
    def on_step(self, neval: int) -> Optional[str]:
        """Called before dispatching iteration ``neval``.  Raises
        :class:`InjectedFault` for a ``raise`` fault; returns the action
        name for batch-level faults (``nan_grad``) the caller applies;
        returns None when nothing fires."""
        for f in self._step_faults:
            if not f.fired and f.index == neval:
                f.fired = True
                log.warning("fault injection: %s at step %d", f.action,
                            neval)
                if f.action == "raise":
                    raise InjectedFault(
                        f"injected fault at training step {neval}")
                return f.action
        return None

    @staticmethod
    def poison_batch(inp):
        """``nan_grad``: the input batch (a numpy array or a CPU
        tensor) as an f32 numpy array of NaN, so the step's gradients
        (and loss) go non-finite."""
        a = np.asarray(inp, dtype=np.float32)
        return np.full_like(a, np.nan)

    # ------------------------------------------------------------- ckpt site
    def on_checkpoint_write(self, path_prefix: str):
        """Called after the ``path_prefix`` checkpoint pair (and its
        manifest) hit disk; applies any ckpt fault whose 1-based write
        index matches."""
        self.ckpt_writes += 1
        for f in self._ckpt_faults:
            if not f.fired and f.index == self.ckpt_writes:
                f.fired = True
                log.warning("fault injection: %s on checkpoint write #%d "
                            "(%s)", f.action, self.ckpt_writes, path_prefix)
                self._apply_ckpt_fault(f.action, path_prefix)

    def on_checkpoint_publish(self, path_prefix: str):
        """Called after a checkpoint is published into a rollout watch
        directory (files + manifest durable); applies any ``publish``
        fault whose 1-based publish index matches — post-write damage
        the watcher's verify-before-swap gate must catch."""
        self.publish_writes += 1
        for f in self._publish_faults:
            if not f.fired and f.index == self.publish_writes:
                f.fired = True
                log.warning("fault injection: %s on checkpoint publish "
                            "#%d (%s)", f.action, self.publish_writes,
                            path_prefix)
                self._apply_ckpt_fault(f.action, path_prefix)

    @staticmethod
    def _apply_ckpt_fault(action: str, path_prefix: str):
        model_path = path_prefix + ".model.npz"
        optim_path = path_prefix + ".optim.npz"
        if action == "truncate":
            size = os.path.getsize(model_path)
            os.truncate(model_path, size // 2)
        elif action == "corrupt":
            size = os.path.getsize(model_path)
            with open(model_path, "r+b") as fh:
                fh.seek(size // 2)
                chunk = bytearray(fh.read(64))
                fh.seek(size // 2)
                fh.write(bytes(b ^ 0xFF for b in chunk))
        elif action == "delete":
            os.remove(model_path)
        elif action == "drop_optim":
            if os.path.exists(optim_path):
                os.remove(optim_path)


# -------------------------------------------------------- process singleton
_injector: Optional[FaultInjector] = None
_plan_str: Optional[str] = None


def get_injector() -> FaultInjector:
    """The process-global injector, built from
    ``BIGDL_TORCH_FAULT_PLAN`` (read at each call, as ``Engine.init``
    reads it) and rebuilt whenever the plan string changes.  The
    fire-once state lives here, so it survives a trainer's retries
    within one plan."""
    global _injector, _plan_str
    from bigdl_tpu_torch.config import TrainConfig

    spec = TrainConfig.from_env().fault_plan or ""
    if _injector is None or spec != _plan_str:
        _plan_str = spec
        _injector = FaultInjector(FaultPlan.parse(spec))
    return _injector


def reset_injector():
    """Drop the global injector (fresh fire-once counters); the next
    :func:`get_injector` rebuilds from the current config."""
    global _injector, _plan_str
    _injector = None
    _plan_str = None


__all__ = ["Fault", "FaultInjector", "FaultPlan", "InjectedFault",
           "get_injector", "reset_injector"]
