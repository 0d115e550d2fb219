"""One synthetic host: the scrape surface of a real process, in memory.

A :class:`SimHost` is everything the control plane can *see* of a real
training/serving process, with the process itself abstracted away:

* a real :class:`~bigdl_tpu_torch.obs.metrics.MetricsRegistry` holding the
  production families (``bigdl_serve_queue_depth``,
  ``bigdl_goodput_ratio``, the ``bigdl_request_latency_seconds`` e2e
  histogram, ``bigdl_heartbeat_age_seconds``) — ``metrics_text()`` is
  a genuine Prometheus exposition the real
  :func:`~bigdl_tpu_torch.obs.metrics.parse_prometheus` reader consumes;
* a ``/healthz`` payload carrying the exact keys
  ``obs/server.health_payload`` serves (status, host, pid, attempt,
  time, step, step_age_s, goodput_ratio, alerts, heartbeat) — what
  :func:`~bigdl_tpu_torch.resilience.autoscale.derive_signals` and the hang
  watchdog key on;
* its own REAL :class:`~bigdl_tpu_torch.obs.alerts.AlertEngine` over its own
  registry — the per-host topology production runs — evaluated on the
  virtual clock, with transitions collected for the exactly-once
  invariant.

Scenario hooks are plain attributes (``queue_depth``,
``goodput_ratio``, ``latency_e2e_s``, ``slow_factor``, ``stalled``,
``up``, ``partitioned``) the scenario engine mutates between ticks;
``tick()`` advances the step counter on the virtual clock and
republishes the gauges (with a small deterministic per-host jitter so
hysteresis has real noise to prove itself against).

The latency histogram is re-observed fresh each tick (a windowed view:
the family is cleared, then ``latency_samples`` observations land at
the current level), so a latency wave moves the scraped p99 crisply
instead of drowning in cumulative history.
"""

from __future__ import annotations

import random
from typing import List, Optional

from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs.alerts import AlertEngine
from bigdl_tpu_torch.obs.metrics import MetricsRegistry

# one decode/train step per this many virtual seconds, before the
# straggler slow_factor
DEFAULT_STEP_TIME_S = 0.1


class SimHost:
    """One synthetic host on the virtual clock."""

    def __init__(self, host_id: int, clock, seed: int = 0,
                 base_step_time_s: float = DEFAULT_STEP_TIME_S,
                 alert_rules: Optional[List[dict]] = None,
                 alert_sink: Optional[str] = None,
                 latency_samples: int = 20,
                 jitter: float = 0.03):
        self.host_id = int(host_id)
        self.clock = clock
        self.rng = random.Random((int(seed) << 20) ^ (host_id * 2654435761))
        self.base_step_time_s = float(base_step_time_s)
        self.latency_samples = int(latency_samples)
        self.jitter = float(jitter)

        # --- scenario-mutable state --------------------------------
        self.up = True               # down => connection refused
        self.partitioned = False     # => fetch times out (wall cost)
        self.stalled = False         # step stamp stops advancing
        self.clock_skew_s = 0.0      # /healthz clock offset (staleness)
        self.slow_factor = 1.0       # straggler multiplier on step time
        self.queue_depth = 0.0
        self.goodput_ratio = 0.95
        self.latency_e2e_s = 0.02

        # --- process-like state ------------------------------------
        self.attempt = 0
        self.started_at = clock.now()
        self._steps = 0.0
        self._last_step_wall: Optional[float] = None
        self.registry = MetricsRegistry()
        self.engine: Optional[AlertEngine] = None
        if alert_rules:
            self.engine = AlertEngine(alert_rules, registry=self.registry,
                                      sink=alert_sink, clock=clock)
        #: alert transitions this host emitted, in order (each dict is
        #: the engine's transition record plus ``host``)
        self.transitions: List[dict] = []
        self.sink_poisoned = False
        self._publish()

    # ---------------------------------------------------------- clock
    def tick(self, dt: float):
        """Advance one scenario tick of ``dt`` virtual seconds."""
        if self.up and not self.stalled:
            self._steps += dt / max(1e-9, self.base_step_time_s
                                    * self.slow_factor)
            self._last_step_wall = self.clock.now()
        if self.up:
            self._publish()

    def evaluate_alerts(self) -> List[dict]:
        """One alert-engine pass (no-op while down — a dead process
        evaluates nothing); transitions are collected for the
        exactly-once invariant."""
        if self.engine is None or not self.up:
            return []
        out = []
        for t in self.engine.evaluate():
            rec = dict(t, host=self.host_id)
            self.transitions.append(rec)
            out.append(rec)
        return out

    def restart(self):
        """Come back from a preemption/flap: a fresh process restarts
        its step counter and attempt index (the alert engine keeps its
        episode ordinals so transition pairing stays global)."""
        self.attempt += 1
        self._steps = 0.0
        self._last_step_wall = None
        self.started_at = self.clock.now()
        self.up = True

    # -------------------------------------------------------- surface
    def _jittered(self, v: float) -> float:
        if v <= 0 or self.jitter <= 0:
            return v
        return v * (1.0 + self.rng.uniform(-self.jitter, self.jitter))

    def _publish(self):
        reg = self.registry
        reg.gauge(names.SERVE_QUEUE_DEPTH,
                  "Requests waiting in the bounded admission queue"
                  ).set(self._jittered(self.queue_depth))
        reg.gauge(names.GOODPUT_RATIO,
                  "Productive step seconds over total accounted wall "
                  "seconds").set(min(1.0, max(
                      0.0, self._jittered(self.goodput_ratio))))
        age = self.step_age_s()
        if age is not None:
            reg.gauge(names.HEARTBEAT_AGE_SECONDS,
                      "Seconds since each peer's last heartbeat touch",
                      labels=("host",)).labels(host=self.host_id).set(age)
        hist = reg.histogram(
            names.REQUEST_LATENCY_SECONDS,
            "Request latency by engine and kind (ttft/per_token/e2e)",
            labels=("engine", "kind"))
        # windowed view: drop the previous tick's observations so the
        # scraped p99 tracks the CURRENT level (nearest-bucket
        # quantized), not the whole run's history
        hist.clear()
        fam_child = hist.labels(engine="lm", kind="e2e")
        for _ in range(self.latency_samples):
            fam_child.observe(self._jittered(self.latency_e2e_s))

    def step(self) -> Optional[int]:
        s = int(self._steps)
        return s if s >= 1 else None

    def step_age_s(self) -> Optional[float]:
        if self._last_step_wall is None:
            return None
        return round(self.clock.now() - self._last_step_wall, 6)

    def health(self) -> dict:
        """The ``/healthz`` JSON body — key-for-key the payload
        ``obs/server.health_payload`` serves."""
        step = self.step()
        status = "idle" if step is None else (
            "stalled" if self.stalled else "ok")
        now = self.clock.now()
        return {
            "status": status,
            "host": self.host_id,
            "pid": 40000 + self.host_id,
            "attempt": self.attempt,
            # a skewed host reports a skewed wall clock — the surface
            # the aggregator's staleness detection keys on
            "time": now + self.clock_skew_s,
            "port": 9000,
            "uptime_s": round(now - self.started_at, 6),
            "step": step,
            "step_age_s": self.step_age_s(),
            "goodput_ratio": round(self.goodput_ratio, 6),
            "alerts": (self.engine.active() if self.engine is not None
                       else []),
            "heartbeat": None,
            # continuous profiling plane: sim hosts run no sampler and
            # cut no bundles, but the contract keys must be present
            "prof_overhead": None,
            "bundles": 0,
        }

    def metrics_text(self) -> str:
        """The ``/metrics`` body: real Prometheus text exposition."""
        return self.registry.to_prometheus()

    def __repr__(self) -> str:
        flags = "".join(f for f, on in (
            ("D", not self.up), ("P", self.partitioned),
            ("S", self.stalled)) if on) or "ok"
        return (f"SimHost(h{self.host_id} {flags} step={self.step()} "
                f"q={self.queue_depth:.1f})")
