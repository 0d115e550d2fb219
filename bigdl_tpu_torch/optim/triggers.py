"""Triggers: when to stop and when to validate.

Counterpart of ``bigdl_tpu/optim/triggers.py`` (``Trigger``, :103): a
trigger is a predicate over the optimizer's state table (``epoch``,
``neval``, ``epoch_finished``, ``loss``, ``score``).  ``neval`` is the
number of the next iteration (1 before the first step), as in the
reference.  A trigger that reads ``state["loss"]`` says so with
``needs_loss``: the trainer then reads each step's loss before it asks
the trigger, instead of one step behind.
"""

from __future__ import annotations


class _TriggerBase:
    needs_loss = False

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


class _SeveralIteration(_TriggerBase):
    def __init__(self, interval: int):
        self.interval = interval

    def __call__(self, state):
        # neval is the next iteration: neval - 1 are done
        done = state.get("neval", 1) - 1
        return done > 0 and done % self.interval == 0


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


class _MinLoss(_TriggerBase):
    needs_loss = True

    def __init__(self, m: float):
        self.m = m

    def __call__(self, state):
        loss = state.get("loss")
        return loss is not None and loss < self.m


class _MaxScore(_TriggerBase):
    def __init__(self, m: float):
        self.m = m

    def __call__(self, state):
        score = state.get("score")
        return score is not None and score > self.m


class Trigger:
    """Factory namespace matching the reference's ``Trigger`` object."""

    @staticmethod
    def every_epoch():
        return _EveryEpoch()

    @staticmethod
    def several_iteration(interval: int):
        return _SeveralIteration(interval)

    @staticmethod
    def max_epoch(m: int):
        return _MaxEpoch(m)

    @staticmethod
    def max_iteration(m: int):
        return _MaxIteration(m)

    @staticmethod
    def min_loss(m: float):
        return _MinLoss(m)

    @staticmethod
    def max_score(m: float):
        return _MaxScore(m)

    everyEpoch = every_epoch
    severalIteration = several_iteration
    maxEpoch = max_epoch
    maxIteration = max_iteration
    minLoss = min_loss
    maxScore = max_score


__all__ = ["Trigger"]
