"""Virtual clock — deterministic time for the control-plane simulator.

Every policy object in the tree already takes an injectable ``clock``
callable (``AutoscaleController(clock=...)``, ``AlertEngine(clock=...)``,
the supervisor's injectable ``sleep``), precisely so policy branches
unit-test without wall time.  The simulator leans on that seam: ONE
:class:`VirtualClock` instance is handed to every real component, the
scenario timeline advances it tick by tick, and an hour of fleet
history costs microseconds — while staying exactly reproducible, which
is what turns a chaos scenario into a regression test.
"""

from __future__ import annotations


class VirtualClock:
    """Monotonic virtual time: ``now()`` reads, ``advance()`` moves.

    Passed as the ``clock=`` callable of the real policy objects
    (instances are themselves callable, so either ``clock=vc`` or
    ``clock=vc.now`` works)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    __call__ = now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` virtual seconds (never back —
        a scenario that rewinds time is a scenario bug, loudly)."""
        dt = float(dt)
        if dt < 0:
            raise ValueError(f"virtual time only advances, got {dt}")
        self._now += dt
        return self._now

    def sleep(self, dt: float):
        """Injectable stand-in for ``time.sleep`` (the supervisor's
        backoff sleeps advance virtual time instead of blocking)."""
        self.advance(max(0.0, float(dt)))

    def __repr__(self) -> str:
        return f"VirtualClock(t={self._now:.3f})"
