"""bigdl_tpu_torch.sim — fleet-scale control-plane simulator.

Every operational policy in the tree — autoscaling bands and
hysteresis, alert/SLO burn-rate rules, the hang watchdog, fleet
aggregation, straggler detection, serving p99 signals — exists for
fleets of hundreds of hosts, yet has only ever executed against 1–2
real processes.  This package validates the control plane at the scale
it will face without ever owning a pod: hundreds of **synthetic hosts
in one process**, each an in-memory ``/metrics`` + ``/healthz``
endpoint speaking the exact contract the real scrapers consume, driven
by deterministic chaos scenarios on a **virtual clock**, with the
REAL policy objects in the loop:

* :mod:`bigdl_tpu_torch.sim.clock` — the virtual clock every policy object
  is pointed at (``AutoscaleController(clock=...)``,
  ``AlertEngine(clock=...)``): a scenario hour costs microseconds;
* :mod:`bigdl_tpu_torch.sim.host` — :class:`~bigdl_tpu_torch.sim.host.SimHost`:
  one synthetic host — a real :class:`~bigdl_tpu_torch.obs.metrics.
  MetricsRegistry` publishing the production gauge/histogram families
  and a ``/healthz`` payload with the exact keys
  ``obs/server.health_payload`` serves, plus its own REAL
  :class:`~bigdl_tpu_torch.obs.alerts.AlertEngine` (the per-host topology
  production runs);
* :mod:`bigdl_tpu_torch.sim.fleet` — :class:`~bigdl_tpu_torch.sim.fleet.SimFleet`:
  the fetch router that stands in for HTTP — healthy hosts answer,
  partitioned hosts *time out* (costing real wall time, like a real
  partition), down hosts refuse;
* :mod:`bigdl_tpu_torch.sim.scenario` — declarative, loudly-validated chaos
  scenarios: diurnal traffic waves, correlated stragglers, cascading
  preemptions, network partitions, flapping hosts, latency waves, a
  poisoned alert sink;
* :mod:`bigdl_tpu_torch.sim.invariants` — the fleet-level properties every
  scenario must uphold: the autoscaler converges without flapping,
  alerts fire and resolve exactly once per episode, aggregation stays
  O(hosts) inside a wall-clock budget, scrape failures degrade
  conservatively, the supervisor never spends retry budget on a
  flapping (preemption-class) child;
* :mod:`bigdl_tpu_torch.sim.runner` — the tick loop wiring all of it to the
  real :class:`~bigdl_tpu_torch.resilience.autoscale.AutoscaleController`,
  :class:`~bigdl_tpu_torch.resilience.autoscale.EndpointScraper` and
  :class:`~bigdl_tpu_torch.obs.aggregate.FleetAggregator`.

``python -m bigdl_tpu_torch.sim`` runs the scenario matrix at
``FleetSimConfig.hosts`` (200) and the four serve scenarios, and
writes their verdicts to ``--out``.  Knobs:
``BIGDL_TORCH_FLEET_HOSTS`` / ``_SCENARIO`` / ``_TIME_COMPRESSION`` /
``_SEED`` (``config.fleet``).

Counterpart of ``bigdl_tpu/sim``: the same hosts, scenarios, tick loop
and invariants, over the port's ``obs``, ``resilience`` and ``serving``
policy objects; it makes no torch call of its own.
"""

from bigdl_tpu_torch.sim.clock import VirtualClock
from bigdl_tpu_torch.sim.fleet import SimFleet
from bigdl_tpu_torch.sim.host import SimHost
from bigdl_tpu_torch.sim.invariants import InvariantResult
from bigdl_tpu_torch.sim.runner import ScenarioResult, run_scenario
from bigdl_tpu_torch.sim.scenario import (
    BUILTIN_SCENARIOS,
    Scenario,
    load_scenario,
)
from bigdl_tpu_torch.sim.serve import (
    SERVE_SCENARIOS,
    ServeScenario,
    ServeScenarioResult,
    SimServeReplica,
    load_serve_scenario,
    run_serve_scenario,
)

__all__ = [
    "VirtualClock", "SimHost", "SimFleet", "Scenario",
    "BUILTIN_SCENARIOS", "load_scenario", "InvariantResult",
    "ScenarioResult", "run_scenario",
    "SERVE_SCENARIOS", "ServeScenario", "ServeScenarioResult",
    "SimServeReplica", "load_serve_scenario", "run_serve_scenario",
]
