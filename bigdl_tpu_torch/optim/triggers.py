"""Triggers: when to stop.

Counterpart of ``bigdl_tpu/optim/triggers.py`` (``Trigger``, :103): a
trigger is a predicate over the optimizer's state table (``epoch``,
``neval``, ``epoch_finished``).  ``neval`` is the number of the next
iteration (1 before the first step), as in the reference.
"""

from __future__ import annotations


class _TriggerBase:
    def __call__(self, state: dict) -> bool:
        raise NotImplementedError


class _EveryEpoch(_TriggerBase):
    def __init__(self):
        self._last = 0

    def __call__(self, state):
        e = state.get("epoch_finished", 0)
        if e > self._last:
            self._last = e
            return True
        return False


class _MaxEpoch(_TriggerBase):
    def __init__(self, m: int):
        self.m = m

    def __call__(self, state):
        return state.get("epoch", 1) > self.m


class _MaxIteration(_TriggerBase):
    def __init__(self, m: int):
        self.m = m

    def __call__(self, state):
        # neval > m after exactly m completed iterations
        return state.get("neval", 1) > self.m


class Trigger:
    """Factory namespace matching the reference's ``Trigger`` object."""

    @staticmethod
    def every_epoch():
        return _EveryEpoch()

    @staticmethod
    def max_epoch(m: int):
        return _MaxEpoch(m)

    @staticmethod
    def max_iteration(m: int):
        return _MaxIteration(m)

    everyEpoch = every_epoch
    maxEpoch = max_epoch
    maxIteration = max_iteration


__all__ = ["Trigger"]
