"""The simulation loop — real control plane, synthetic fleet.

One :func:`run_scenario` call wires the REAL policy objects together
exactly as the supervisor does in production — an
:class:`~bigdl_tpu_torch.resilience.autoscale.EndpointScraper` (riding the
real :class:`~bigdl_tpu_torch.obs.aggregate.FleetAggregator` bounded-pool
concurrent scrape) feeding
:func:`~bigdl_tpu_torch.resilience.autoscale.derive_signals` inside a real
:class:`~bigdl_tpu_torch.resilience.autoscale.AutoscaleController`, with a
real per-host :class:`~bigdl_tpu_torch.obs.alerts.AlertEngine` on every
synthetic host — then drives them tick by tick through a chaos
scenario on the virtual clock:

1. the scenario mutates the fleet to its state at virtual ``t``
   (partitions, preemptions, waves, stragglers);
2. hosts advance their step counters and republish their gauges;
3. every host's alert engine evaluates (transitions collected with
   their episode ids);
4. the controller ticks — a non-dry-run decision is "executed" the way
   the supervisor would (``commit`` + ``on_launch``: new world, fresh
   warmup, cleared stamp memory) and recorded with its virtual
   timestamp;
5. the virtual clock advances one tick.

Decisions the controller makes are *fed back*: the traffic model
divides offered load by the committed world, so convergence claims are
about a closed loop, not an open-loop script.  After the run the
invariant checker (:mod:`bigdl_tpu_torch.sim.invariants`) turns the
observation bundle into per-scenario verdicts, and a
``fleet.scenario`` trace event banks them for ``obs/report.py``'s
fleet section.  :func:`run_matrix` runs a list of scenarios, in
worker processes when asked (``python -m bigdl_tpu_torch.sim
--jobs``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional

from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.sim.clock import VirtualClock
from bigdl_tpu_torch.sim.fleet import SimFleet
from bigdl_tpu_torch.sim.invariants import (
    InvariantResult,
    check_scenario,
    check_supervisor_flap,
    check_watchdog,
)
from bigdl_tpu_torch.sim.scenario import Scenario, load_scenario

# a path whose directory never exists: every sink append fails —
# the "poisoned alert sink" failure mode, counted not wedging
_POISONED_SINK = os.path.join(
    tempfile.gettempdir(),
    f"bigdl-sim-poisoned-sink-{os.getpid()}-does-not-exist",
    "sink.jsonl")


@dataclasses.dataclass
class ScenarioResult:
    """One scenario's outcome: observations + invariant verdicts."""

    name: str
    ok: bool
    hosts: int
    ticks: int
    duration_s: float
    wall_s: float
    final_world: int
    decisions: List[dict]
    transitions: int
    episodes: int
    sink_failures: int
    scrape_worst_s: Optional[float]
    scrape_mean_s: Optional[float]
    invariants: List[InvariantResult]
    #: debug bundles written during the run (0 when BIGDL_TORCH_BUNDLE_DIR
    #: is unset — the bundle invariant then reports "not exercised")
    bundles: int = 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["invariants"] = [dataclasses.asdict(r)
                           for r in self.invariants]
        return d

    def summary(self) -> str:
        inv = ", ".join(f"{r.name}={'ok' if r.ok else 'FAIL'}"
                        for r in self.invariants)
        return (f"scenario {self.name}: "
                f"{'PASS' if self.ok else 'FAIL'} "
                f"({self.hosts} hosts, {self.ticks} ticks, "
                f"{self.wall_s:.1f}s wall, world->{self.final_world}, "
                f"{len(self.decisions)} decision(s), "
                f"{self.episodes} episode(s)) [{inv}]")


class _RecordingScraper:
    """Wraps the real scraper to record per-cycle wall/ok/down."""

    def __init__(self, scraper, clock):
        self._scraper = scraper
        self._clock = clock
        self.cycles: List[dict] = []

    def __call__(self):
        t0 = time.perf_counter()
        scraped = self._scraper()
        ok = sum(1 for p in scraped if p.get("ok"))
        self.cycles.append({
            "t": self._clock.now(),
            "wall_s": time.perf_counter() - t0,
            "ok": ok, "down": len(scraped) - ok})
        return scraped


def _sink_failures_total() -> float:
    """Failed sink deliveries so far — the engine counts them on the
    PROCESS registry (``alerts._count_sink_failure``), so the runner
    measures the per-scenario delta of this."""
    from bigdl_tpu_torch import obs

    for fam in obs.get_registry().families():
        if fam.name == names.ALERT_SINK_FAILURES_TOTAL:
            return sum(child.value for _k, child in fam.child_items())
    return 0.0


def run_scenario(spec, hosts: Optional[int] = None,
                 seed: Optional[int] = None,
                 time_compression: Optional[float] = None,
                 partition_stall_s: float = 0.02,
                 scrape_timeout_s: float = 0.25,
                 extra_probes: bool = True) -> ScenarioResult:
    """Run one scenario end to end and check its invariants.

    ``hosts`` / ``seed`` / ``time_compression`` default from
    ``config.fleet`` (the ``BIGDL_TORCH_FLEET_*`` knobs).  When
    ``extra_probes`` is on, scenarios containing flap events also run
    the supervisor retry-budget and watchdog-classification probes."""
    from bigdl_tpu_torch.config import refresh_from_env
    from bigdl_tpu_torch.obs import alerts as alerts_mod
    from bigdl_tpu_torch.config import AutoscaleConfig
    from bigdl_tpu_torch.resilience.autoscale import (
        AutoscaleController,
        EndpointScraper,
    )

    from bigdl_tpu_torch.obs import bundle as bundle_mod

    fcfg = refresh_from_env().fleet
    # debug bundles: snapshot the inventory before the run so the
    # bundle invariant judges only THIS scenario's alert->bundle output
    bundle_dir = refresh_from_env().obs.bundle_dir
    pre_bundles = ({b["name"] for b in bundle_mod.inventory(bundle_dir)}
                   if bundle_dir else set())
    n_hosts = int(hosts) if hosts else int(fcfg.hosts)
    seed = int(fcfg.seed) if seed is None else int(seed)
    compression = (float(fcfg.time_compression)
                   if time_compression is None
                   else float(time_compression))

    sc: Scenario = load_scenario(spec, hosts=n_hosts, seed=seed,
                                 time_compression=compression)
    clock = VirtualClock()
    rules = (alerts_mod.load_rules(json.dumps(sc.alert_rules))
             if sc.alert_rules else None)
    fleet = SimFleet(n_hosts, clock, seed=seed, alert_rules=rules,
                     partition_stall_s=partition_stall_s)
    scraper = _RecordingScraper(
        EndpointScraper(peers=fleet.addrs, fetch=fleet.fetch,
                        timeout_s=scrape_timeout_s), clock)
    cfg = AutoscaleConfig(enabled=True, **sc.autoscale)
    controller = AutoscaleController(cfg=cfg, world=sc.start_world,
                                     scrape=scraper, clock=clock)

    decisions: List[dict] = []
    poisoned = False
    sink_failures0 = _sink_failures_total()
    t_wall0 = time.perf_counter()
    for _ in range(sc.n_ticks()):
        t = clock.now()
        sc.apply(fleet, t, controller.world)
        if not poisoned and sc.sink_poisoned(t):
            poisoned = True
            for h in fleet.hosts:
                if h.engine is not None:
                    h.engine.sink = _POISONED_SINK
        fleet.tick(sc.tick_s)
        fleet.evaluate_alerts()
        decision = controller.tick()
        if decision is not None and not decision.dry_run:
            # execute the way the supervisor would: adopt the world,
            # restart the warmup clock, drop the stamp memory
            controller.commit(decision)
            controller.on_launch()
            decisions.append({
                "t": t, "direction": decision.direction,
                "reason": decision.reason,
                "old_world": decision.old_world,
                "new_world": decision.new_world,
                "signals": decision.signals})
        clock.advance(sc.tick_s)
    wall_s = time.perf_counter() - t_wall0

    transitions = fleet.transitions
    new_bundles = ([b for b in bundle_mod.inventory(bundle_dir)
                    if b["name"] not in pre_bundles]
                   if bundle_dir else [])
    observed = {
        "decisions": decisions,
        "transitions": transitions,
        "scrape_cycles": scraper.cycles,
        "final_world": controller.world,
        "duration_s": sc.duration_s,
        "sink_failures": _sink_failures_total() - sink_failures0,
        "bundle_dir": bundle_dir,
        "bundles": new_bundles,
    }
    invariants = check_scenario(observed, sc.expect, cfg.cooldown_s)
    if extra_probes and any(ev["kind"] == "flap" for ev in sc.events):
        invariants.append(check_supervisor_flap())
        if n_hosts >= 2:
            invariants.append(check_watchdog(fleet, 0, 1))

    episodes = sum(1 for t in transitions if t["state"] == "firing")
    cycles = scraper.cycles
    result = ScenarioResult(
        name=sc.name,
        ok=all(r.ok for r in invariants),
        hosts=n_hosts,
        ticks=sc.n_ticks(),
        duration_s=sc.duration_s,
        wall_s=round(wall_s, 3),
        final_world=controller.world,
        decisions=decisions,
        transitions=len(transitions),
        episodes=episodes,
        sink_failures=int(observed["sink_failures"]),
        scrape_worst_s=(round(max(c["wall_s"] for c in cycles), 6)
                        if cycles else None),
        scrape_mean_s=(round(sum(c["wall_s"] for c in cycles)
                             / len(cycles), 6) if cycles else None),
        invariants=invariants,
        bundles=len(new_bundles),
    )
    from bigdl_tpu_torch import obs

    obs.get_tracer().event(
        "fleet.scenario", scenario=result.name, ok=result.ok,
        hosts=result.hosts, ticks=result.ticks,
        wall_s=result.wall_s, final_world=result.final_world,
        decisions=len(result.decisions), episodes=result.episodes,
        sink_failures=result.sink_failures, bundles=result.bundles,
        scrape_worst_s=result.scrape_worst_s,
        invariants={r.name: r.ok for r in result.invariants})
    return result


def _run_one(name, hosts, seed, compression, stall, bundles_dir):
    """One scenario in this process, the debug-bundle plane armed for
    ``alert_storm`` alone (as ``scripts/fleet_sim.py`` arms it); the
    run's trace and metrics flushed."""
    from bigdl_tpu_torch import obs

    if name == "alert_storm":
        os.environ["BIGDL_TORCH_BUNDLE_DIR"] = bundles_dir
        os.environ["BIGDL_TORCH_BUNDLE_RATE_LIMIT"] = "0"
    else:
        os.environ.pop("BIGDL_TORCH_BUNDLE_DIR", None)
    try:
        res = run_scenario(name, hosts=hosts, seed=seed,
                           time_compression=compression,
                           partition_stall_s=stall)
    finally:
        os.environ.pop("BIGDL_TORCH_BUNDLE_DIR", None)
    obs.flush()
    return res


def _run_in_worker(*args) -> dict:
    import logging

    # the poisoned-sink scenario logs a warning per failed delivery
    logging.getLogger("bigdl_tpu_torch.obs").setLevel(logging.ERROR)
    return _run_one(*args).to_dict()


def _from_dict(d: dict) -> ScenarioResult:
    return ScenarioResult(**dict(d, invariants=[
        InvariantResult(**r) for r in d["invariants"]]))


def run_matrix(names, hosts: int, seed: int, compression: float,
               partition_stall_s: float, bundles_dir: str,
               jobs: int = 1) -> List[ScenarioResult]:
    """Each scenario of ``names`` (``python -m bigdl_tpu_torch.sim``'s
    matrix), in order; with ``jobs`` > 1 in that many spawned worker
    processes at once.  Each scenario owns its fleet, clock and
    controller, and counts its sink failures and bundles as deltas, so a
    worker's result is the one a serial run gives, but for its wall
    seconds."""
    tasks = [(n, hosts, seed, compression, partition_stall_s, bundles_dir)
             for n in names]
    if jobs <= 1:
        return [_run_one(*t) for t in tasks]
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=jobs,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_run_in_worker, *t) for t in tasks]
        return [_from_dict(f.result()) for f in futures]
