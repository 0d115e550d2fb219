"""Autoscaling supervisor policy loop — signals in, world resizes out.

Counterpart of ``bigdl_tpu/resilience/autoscale.py``, with its signals,
rules and decisions.  A world-resize resume is trajectory-correct
(topology-tagged checkpoints, ``elastic.ensure_shard_layout``) and every
trainer has a live ``/metrics`` and ``/healthz``; this module is the
loop that *drives* a resize: restart-from-checkpoint as the consistency
mechanism, so a resize is a supervised restart at a new world size.
A port world of N is N processes, one GPU each.

The pieces:

* :class:`EndpointScraper` — reads the fleet: ``BIGDL_TORCH_OBS_PEERS`` when
  set (one scrape per peer via
  :meth:`~bigdl_tpu_torch.obs.aggregate.FleetAggregator.scrape_peer`),
  otherwise the supervised child's own endpoint resolved exactly like
  the hang watchdog (``BIGDL_TORCH_OBS_PORT`` / the port file the supervisor
  injects for port 0).  ``fetch`` is injectable so every policy branch
  unit-tests without sockets.
* :func:`derive_signals` — one scrape cycle -> the policy signal dict:
  ``step_time_s`` (from step-stamp deltas between successive scrapes,
  each stamp dated by ``/healthz``'s ``time - step_age_s``, a step
  stamped again by its newest stamp — no histogram parsing, works on
  any child; JAX dates it by the scrape, the one difference),
  ``queue_depth`` (the
  streaming tier's buffer depth / consumer lag gauges),
  ``goodput_ratio`` (worst host), ``alerts`` (active rule names),
  ``stragglers`` (hosts whose ``/healthz`` reads stalled),
  ``router_replicas`` (live backends from the
  ``bigdl_router_replicas{state="up"}`` gauge) and
  ``router_shed_rate`` (sheds/s from ``bigdl_router_shed_total``
  deltas between cycles — the serving data plane's load-pressure
  signal).
* declarative **rules** (:func:`load_rules`) — the same
  validated-loudly contract as the alert engine: each rule names a
  signal, a comparison, an action (``up``/``down``) and a ``for``
  hysteresis count; the default pack is derived from the
  ``BIGDL_TORCH_AUTOSCALE_*`` band knobs.
* :class:`AutoscaleController` — evaluates the rules every
  ``interval_s`` with warmup after each (re)launch, per-rule
  consecutive-breach hysteresis, a cooldown after any decision, and
  min/max world clamping, so flapping signals cannot thrash the world.
  Decisions are first-class telemetry:
  ``bigdl_autoscale_decisions_total{direction,reason}`` + an
  ``elastic.autoscale`` trace event each, and ``dry_run`` mode counts
  and traces without ever executing.

Execution lives in the supervisor (resilience/supervisor.py): a
decision SIGTERMs the child (graceful preemption -> emergency
checkpoint with the stream offset riding it -> ``EXIT_PREEMPTED``),
then relaunches with ``BIGDL_TORCH_AUTOSCALE_WORLD`` exported at the new
size; the child (a launcher of that many ranks) re-forms its world,
``elastic.restore_latest`` re-partitions the sharded optimizer state
and seeks the stream — exactly-once, counted in
``bigdl_resumes_total{resize}``.  A decision the cooldown or the world
bounds suppress is traced with the signals it saw, so a dry run at
fixed bounds still logs what the loop read.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, List, Optional
from bigdl_tpu_torch.obs import names

log = logging.getLogger("bigdl_tpu_torch.resilience")

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    "nonempty": lambda v, _t: bool(v),
}
_ACTIONS = ("up", "down")
SIGNALS = ("step_time_s", "queue_depth", "goodput_ratio", "alerts",
           "stragglers", "step", "world", "p99_latency_s",
           "router_replicas", "router_shed_rate")

# queue gauges: the streaming tier's buffer/lag (dataset/stream.py)
# AND the serving tier's request queue (serving/batcher.py) — the
# queue_depth signal is the max over all of them on any host
_QUEUE_METRICS = (names.STREAM_BUFFER_DEPTH, names.STREAM_LAG_RECORDS,
                  names.SERVE_QUEUE_DEPTH)

# the serving tier's e2e request-latency histogram, as exposed on
# /metrics (bucket samples carry their literal _bucket name)
_LATENCY_BUCKET = "bigdl_request_latency_seconds_bucket"


def _hist_p99(buckets: dict) -> Optional[float]:
    """p99 upper-bound from cumulative ``{le: count}`` buckets (the
    conservative nearest-bucket estimate — +Inf falls back to the
    largest finite bound, so a pathological tail still yields a
    finite, breachable signal)."""
    total = buckets.get(float("inf"), 0.0)
    if total <= 0:
        return None
    finite = sorted(b for b in buckets if b != float("inf"))
    target = 0.99 * total
    for le in finite:
        if buckets[le] >= target:
            return le
    return finite[-1] if finite else None


def _kept(signals: dict) -> dict:
    """The signals a decision records: the ones that hold a value."""
    return {k: v for k, v in signals.items() if v not in (None, [], {})}


@dataclasses.dataclass
class Decision:
    """One resize decision (already counted and traced when emitted)."""

    direction: str          # "up" | "down"
    reason: str             # rule name
    old_world: int
    new_world: int
    dry_run: bool = False
    signals: dict = dataclasses.field(default_factory=dict)

    @property
    def resize(self) -> str:
        return f"{self.old_world}to{self.new_world}"


def default_rules(cfg) -> List[dict]:
    """The rule pack the ``BIGDL_TORCH_AUTOSCALE_*`` band knobs describe.
    Order is priority: straggler eviction and queue pressure outrank
    the step-time band, the cost floor comes last."""
    rules = []
    if cfg.evict_stragglers:
        rules.append({"name": "straggler_evict", "signal": "stragglers",
                      "op": "nonempty", "action": "down", "for": 1})
    if cfg.queue_high > 0:
        rules.append({"name": "queue_high", "signal": "queue_depth",
                      "op": ">", "value": cfg.queue_high, "action": "up"})
    if cfg.queue_low > 0:
        rules.append({"name": "queue_low", "signal": "queue_depth",
                      "op": "<", "value": cfg.queue_low, "action": "down"})
    if cfg.p99_high > 0:
        rules.append({"name": "latency_p99_high",
                      "signal": "p99_latency_s", "op": ">",
                      "value": cfg.p99_high, "action": "up"})
    if cfg.p99_low > 0:
        rules.append({"name": "latency_p99_low",
                      "signal": "p99_latency_s", "op": "<",
                      "value": cfg.p99_low, "action": "down"})
    if cfg.step_time_high > 0:
        rules.append({"name": "step_time_high", "signal": "step_time_s",
                      "op": ">", "value": cfg.step_time_high,
                      "action": "up"})
    if cfg.step_time_low > 0:
        rules.append({"name": "step_time_low", "signal": "step_time_s",
                      "op": "<", "value": cfg.step_time_low,
                      "action": "down"})
    if cfg.goodput_floor > 0:
        rules.append({"name": "cost_goodput_floor",
                      "signal": "goodput_ratio", "op": "<",
                      "value": cfg.goodput_floor, "action": "down"})
    return rules


def load_rules(spec: Optional[str], cfg) -> List[dict]:
    """Resolve + validate the rule pack: inline JSON list, a JSON file
    path, or (None) the default pack from the band knobs.  Validation
    is loud — a malformed autoscaling rule silently ignored is a world
    that never scales."""
    if spec is None:
        raw = default_rules(cfg)
    else:
        text = spec
        if not spec.lstrip().startswith(("[", "{")):
            with open(spec, "r", encoding="utf-8") as fh:
                text = fh.read()
        raw = json.loads(text)
    if not isinstance(raw, list):
        raise ValueError(f"autoscale rules must be a JSON list, got "
                         f"{type(raw).__name__}")
    rules = []
    seen = set()
    for i, r in enumerate(raw):
        if not isinstance(r, dict):
            raise ValueError(f"autoscale rule #{i} is not an object: {r!r}")
        missing = [k for k in ("name", "signal", "op", "action")
                   if k not in r]
        if missing:
            raise ValueError(f"autoscale rule #{i} missing {missing}")
        if r["op"] not in _OPS:
            raise ValueError(f"autoscale rule {r['name']!r}: unknown op "
                             f"{r['op']!r} (one of {sorted(_OPS)})")
        if r["action"] not in _ACTIONS:
            raise ValueError(f"autoscale rule {r['name']!r}: action must "
                             f"be one of {_ACTIONS}, got {r['action']!r}")
        if r["signal"] not in SIGNALS:
            raise ValueError(f"autoscale rule {r['name']!r}: unknown "
                             f"signal {r['signal']!r} (one of {SIGNALS})")
        if r["op"] != "nonempty" and "value" not in r:
            raise ValueError(f"autoscale rule {r['name']!r}: op "
                             f"{r['op']!r} needs a 'value'")
        if r["name"] in seen:
            raise ValueError(f"duplicate autoscale rule name "
                             f"{r['name']!r}")
        seen.add(r["name"])
        out = dict(r)
        out["for"] = max(1, int(r.get("for", cfg.hysteresis)))
        if "value" in out:
            out["value"] = float(out["value"])
        rules.append(out)
    return rules


class EndpointScraper:
    """One scrape cycle over the fleet: a list of
    ``{addr, ok, health, metrics}`` dicts (the
    ``FleetAggregator.scrape_peer`` shape).  Peers mode when ``peers``
    is set; otherwise the single supervised child found via
    ``port``/``port_file`` (the hang-watchdog resolution contract —
    port 0 resolves through the port file once the child writes it)."""

    def __init__(self, peers=None, port: Optional[int] = None,
                 port_file: Optional[str] = None, fetch=None,
                 timeout_s: float = 2.0):
        from bigdl_tpu_torch.obs.aggregate import FleetAggregator

        if isinstance(peers, str):
            peers = [p.strip() for p in peers.split(",") if p.strip()]
        self.peers = list(peers or [])
        self.port = int(port) if port else None
        self.port_file = port_file
        self._agg = FleetAggregator(peers=[], fetch=fetch,
                                    timeout_s=timeout_s)

    def _resolve_port(self) -> Optional[int]:
        if self.port:
            return self.port
        if self.port_file and os.path.isfile(self.port_file):
            try:
                with open(self.port_file, encoding="utf-8") as fh:
                    self.port = int(fh.read().strip() or 0) or None
            except (OSError, ValueError):
                self.port = None
        return self.port

    def __call__(self) -> List[dict]:
        addrs = list(self.peers)
        if not addrs:
            port = self._resolve_port()
            if not port:
                return []
            addrs = [f"127.0.0.1:{port}"]
        # concurrent bounded-pool scrape: N partitioned peers cost
        # ceil(N/pool) timeouts per cycle, not N (and the cycle wall is
        # published as bigdl_fleet_scrape_seconds)
        return self._agg.scrape_peers(addrs)


def derive_signals(scraped: List[dict], prev_steps: dict,
                   world: int,
                   prev_counters: Optional[dict] = None) -> dict:
    """One scrape cycle -> the policy signal dict.  ``prev_steps``
    ({addr: (step, wall_time)}) is the controller's memory between
    cycles — step time derives from the stamp deltas, so any child that
    stamps ``note_step`` is measurable without histogram parsing.
    ``prev_counters`` ({addr: (shed_total, wall_time)}) is the same
    memory for counter deltas: ``router_shed_rate`` (sheds/s summed
    across routers) derives from ``bigdl_router_shed_total`` between
    cycles, and ``router_replicas`` counts the fleet's live backends
    from the ``bigdl_router_replicas{state="up"}`` gauge.  Conservative:
    a signal that cannot be derived is absent, and an absent signal
    never breaches a rule."""
    sig = {"world": world, "alerts": [], "stragglers": []}
    step_times, depths, ratios, steps, p99s = [], [], [], [], []
    replicas_up, shed_rates = [], []
    for peer in scraped:
        if not peer.get("ok"):
            continue
        lat_buckets: dict = {}
        shed_total = None
        h = peer.get("health") or {}
        addr = peer.get("addr", "?")
        step, now = h.get("step"), h.get("time")
        if step is not None:
            steps.append(int(step))
        # the step stamp's own wall time where /healthz gives its age
        # (JAX reads the scrape's time, and moves its memory on a scrape
        # that saw no new step: with scrapes faster than steps it reads
        # the scrape interval as the step time)
        age = h.get("step_age_s")
        stamp = now if now is None or age is None \
            else float(now) - float(age)
        if step is not None and stamp is not None:
            last = prev_steps.get(addr)
            # a step stamped again dates from its newest stamp: a resume
            # stamps the restored step before it trains that step, and
            # the restore's seconds are no step's
            if last is None or int(step) != last[0] or age is None \
                    or float(stamp) > last[1]:
                prev_steps[addr] = (int(step), float(stamp))
            if last is not None and int(step) > last[0]:
                step_times.append(
                    (float(stamp) - last[1]) / (int(step) - last[0]))
        if h.get("goodput_ratio") is not None:
            ratios.append(float(h["goodput_ratio"]))
        for a in h.get("alerts") or []:
            rule = a.get("rule")
            if rule and rule not in sig["alerts"]:
                sig["alerts"].append(rule)
        if h.get("status") == "stalled":
            sig["stragglers"].append(h.get("host", addr))
        for s in (peer.get("metrics") or {}).get("samples", []):
            if s.get("name") in _QUEUE_METRICS:
                depths.append(float(s.get("value", 0.0)))
            elif s.get("name") == names.ROUTER_REPLICAS and \
                    (s.get("labels") or {}).get("state") == "up":
                replicas_up.append(float(s.get("value", 0.0)))
            elif s.get("name") == names.ROUTER_SHED_TOTAL:
                shed_total = (shed_total or 0.0) + float(
                    s.get("value", 0.0))
            elif s.get("name") == _LATENCY_BUCKET and \
                    (s.get("labels") or {}).get("kind") == "e2e":
                try:
                    le = float((s.get("labels") or {}).get("le", "nan"))
                except ValueError:
                    le = float("inf")  # "+Inf"
                lat_buckets[le] = lat_buckets.get(le, 0.0) + float(
                    s.get("value", 0.0))
        p99 = _hist_p99(lat_buckets)
        if p99 is not None:
            p99s.append(p99)
        if shed_total is not None and now is not None \
                and prev_counters is not None:
            last = prev_counters.get(addr)
            prev_counters[addr] = (shed_total, float(now))
            if last is not None and float(now) > last[1]:
                # max(0, Δ): a restarted router rewinds its counter —
                # that must read as quiet, not as a negative shed storm
                shed_rates.append(max(0.0, shed_total - last[0])
                                  / (float(now) - last[1]))
    if step_times:
        # the slowest host gates every synchronous collective
        sig["step_time_s"] = max(step_times)
    if depths:
        sig["queue_depth"] = max(depths)
    if ratios:
        sig["goodput_ratio"] = min(ratios)
    if steps:
        sig["step"] = max(steps)
    if p99s:
        # the worst host's tail gates the user-facing SLO
        sig["p99_latency_s"] = max(p99s)
    if replicas_up:
        sig["router_replicas"] = sum(replicas_up)
    if shed_rates:
        sig["router_shed_rate"] = sum(shed_rates)
    return sig


class AutoscaleController:
    """Evaluate the rules against live signals; emit clamped,
    hysteresis-gated, cooldown-paced :class:`Decision`\\ s.

    The controller owns the current ``world`` (what the supervisor
    exports as ``BIGDL_TORCH_AUTOSCALE_WORLD``); the supervisor calls
    :meth:`tick` from its child-wait poll loop, executes non-dry-run
    decisions by graceful stop-restart, and :meth:`commit`\\ s them.
    ``scrape`` and ``clock`` are injectable so every policy branch is a
    socket-free unit test."""

    def __init__(self, cfg=None, world: Optional[int] = None,
                 rules: Optional[List[dict]] = None,
                 scrape: Optional[Callable[[], List[dict]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if cfg is None:
            from bigdl_tpu_torch.config import refresh_from_env

            cfg = refresh_from_env().autoscale
        self.cfg = cfg
        self.rules = (load_rules(cfg.rules, cfg) if rules is None
                      else rules)
        if world is None:
            world = int(getattr(cfg, "world", 0) or 0) \
                or max(1, cfg.min_world)
        self.world = int(world)
        self._scrape = scrape
        self._scrape_injected = scrape is not None
        self._clock = clock
        self._streaks = {r["name"]: 0 for r in self.rules}
        self._prev_steps: dict = {}
        self._prev_counters: dict = {}
        self._launch_t = clock()
        self._last_eval: Optional[float] = None
        self._last_decision_t: Optional[float] = None
        self.decisions: List[Decision] = []

    @classmethod
    def from_config(cls, world: Optional[int] = None
                    ) -> "AutoscaleController":
        return cls(world=world)

    # ------------------------------------------------------- lifecycle
    def bind_endpoint(self, port: Optional[int] = None,
                      port_file: Optional[str] = None, peers=None):
        """Point the scraper at this launch's endpoint(s) (no-op when a
        scrape callable was injected at construction)."""
        if self._scrape_injected:
            return
        self._scrape = EndpointScraper(peers=peers, port=port,
                                       port_file=port_file)

    def on_launch(self):
        """A child (re)launched: restart the warmup clock, drop the
        step-stamp memory (a fresh process restarts its counters) and
        every breach streak."""
        self._launch_t = self._clock()
        self._prev_steps.clear()
        self._prev_counters.clear()
        for k in self._streaks:
            self._streaks[k] = 0

    def commit(self, decision: Decision):
        """The supervisor executed ``decision``: adopt the new world."""
        self.world = int(decision.new_world)

    # ------------------------------------------------------ evaluation
    def _propose(self, rule: dict) -> int:
        f = max(2, int(self.cfg.factor))
        if rule["action"] == "up":
            target = self.world * f
        else:
            target = max(1, self.world // f)
        return max(self.cfg.min_world, min(self.cfg.max_world, target))

    def _event(self, **attrs):
        from bigdl_tpu_torch import obs

        obs.get_tracer().event("elastic.autoscale", **attrs)

    def evaluate(self, signals: dict,
                 now: Optional[float] = None) -> Optional[Decision]:
        """One policy evaluation over a derived signal dict.  Returns a
        decision (already counted/traced) or None.  Dry-run decisions
        are returned flagged — the supervisor never executes them."""
        now = self._clock() if now is None else now
        candidate = None
        for rule in self.rules:
            val = signals.get(rule["signal"])
            breached = val is not None and _OPS[rule["op"]](
                val, rule.get("value"))
            self._streaks[rule["name"]] = \
                self._streaks[rule["name"]] + 1 if breached else 0
            if breached and self._streaks[rule["name"]] >= rule["for"] \
                    and candidate is None:
                candidate = rule
        if candidate is None:
            return None
        if self._last_decision_t is not None and \
                now - self._last_decision_t < self.cfg.cooldown_s:
            # hysteresis survived but the cooldown gate holds: a fresh
            # restart must pay for itself before the next decision —
            # this is what keeps an immediate reverse decision from
            # thrashing the world
            self._event(suppressed="cooldown", rule=candidate["name"],
                        remaining_s=round(
                            self.cfg.cooldown_s
                            - (now - self._last_decision_t), 3),
                        signals=_kept(signals))
            return None
        new_world = self._propose(candidate)
        if new_world == self.world:
            self._event(suppressed="at_bound", rule=candidate["name"],
                        world=self.world,
                        min_world=self.cfg.min_world,
                        max_world=self.cfg.max_world,
                        signals=_kept(signals))
            return None
        decision = Decision(
            direction=candidate["action"], reason=candidate["name"],
            old_world=self.world, new_world=new_world,
            dry_run=bool(self.cfg.dry_run), signals=_kept(signals))
        from bigdl_tpu_torch import obs

        obs.get_registry().counter(
            names.AUTOSCALE_DECISIONS_TOTAL,
            "Autoscale resize decisions, by direction and rule",
            labels=("direction", "reason")).labels(
            direction=decision.direction, reason=decision.reason).inc()
        self._event(direction=decision.direction, reason=decision.reason,
                    old_world=decision.old_world,
                    new_world=decision.new_world,
                    dry_run=decision.dry_run, signals=decision.signals)
        log.warning("autoscale: %s %d -> %d (%s%s) signals=%s",
                    decision.direction, decision.old_world,
                    decision.new_world, decision.reason,
                    ", DRY RUN" if decision.dry_run else "",
                    decision.signals)
        self._last_decision_t = now
        for k in self._streaks:
            self._streaks[k] = 0
        self.decisions.append(decision)
        return decision

    def tick(self, now: Optional[float] = None) -> Optional[Decision]:
        """The supervisor's poll hook: rate-limited to ``interval_s``,
        silent through the post-launch warmup, conservative on scrape
        failure (no data, no decision)."""
        now = self._clock() if now is None else now
        if now - self._launch_t < self.cfg.warmup_s:
            return None
        if self._last_eval is not None and \
                now - self._last_eval < self.cfg.interval_s:
            return None
        self._last_eval = now
        if self._scrape is None:
            return None
        try:
            scraped = self._scrape()
        except Exception:  # noqa: BLE001 — a scrape bug must not kill
            log.exception("autoscale: scrape failed")  # the supervisor
            return None
        if not scraped or not any(p.get("ok") for p in scraped):
            return None
        signals = derive_signals(scraped, self._prev_steps, self.world,
                                 self._prev_counters)
        return self.evaluate(signals, now)


__all__ = ["SIGNALS", "Decision", "default_rules", "load_rules",
           "EndpointScraper", "derive_signals", "AutoscaleController"]
