"""Declarative chaos scenarios on the virtual clock.

A scenario is a JSON-able dict — loadable inline, from a file, or by
builtin name (the same resolution contract as ``BIGDL_TORCH_ALERT_RULES`` /
``BIGDL_TORCH_AUTOSCALE_RULES``) and validated LOUDLY: a typo'd chaos
scenario that silently does nothing is a fleet "validated" against
clear skies.

Schema::

    {
      "name": "diurnal",
      "duration_s": 600, "tick_s": 5,          # virtual seconds
      "start_world": 1,
      "autoscale": {"queue_high": 64, ...},    # AutoscaleConfig overrides
      "alert_rules": [...],                    # per-host pack (alerts.py
                                               # schema, resolve_for ok)
      "events": [ {"kind": ..., "at_s": ..., "until_s": ...,
                   "hosts": {"fraction"|"count"|"ids": ...}, ...} ],
      "expect": {...}                          # invariant parameters
    }

Event kinds (every virtual-time field ends in ``_s`` so time
compression can find it):

=============  ========================================================
``traffic``    offered-load wave: ``base`` + ``amplitude`` · half-cosine
               over ``period_s``; per-host queue depth =
               offered / world · (n_hosts / up_hosts) — the negative
               feedback that makes autoscale convergence a real claim
``straggler``  selected hosts run ``factor``× slower (step-time signal)
``stall``      selected hosts stop stepping (``/healthz`` stalled)
``partition``  selected hosts time out on fetch (not 404 — the
               expensive failure)
``preempt``    cascading: selected hosts drop at ``at_s + i·stagger_s``
               for ``down_s`` each, then restart with reset counters
``flap``       selected hosts alternate up/down every ``period_s``/2
``latency``    selected hosts' e2e request latency moves to ``e2e_s``
``goodput``    selected hosts' goodput ratio moves to ``ratio``
``poison_sink``  from ``at_s`` on, every host's alert sink fails
=============  ========================================================

``expect`` keys parameterize the invariant checker
(:mod:`bigdl_tpu_torch.sim.invariants`); unknown keys are rejected — a typo'd
expectation silently passing is the exact failure class this subsystem
exists to remove.
"""

from __future__ import annotations

import copy
import json
import math
import random
from typing import Dict, Optional

from bigdl_tpu_torch.obs import names

EVENT_KINDS = ("traffic", "straggler", "stall", "partition", "preempt",
               "flap", "latency", "goodput", "poison_sink")

# per-kind required extra fields (beyond kind/at_s/until_s/hosts)
_EVENT_REQUIRED = {
    "traffic": ("base",),
    "straggler": ("factor",),
    "stall": (),
    "partition": (),
    "preempt": ("down_s",),
    "flap": ("period_s",),
    "latency": ("e2e_s",),
    "goodput": ("ratio",),
    "poison_sink": (),
}

_EXPECT_KEYS = frozenset({
    "max_decisions", "min_decisions", "reasons",
    "no_decisions_during_s", "quiet_tail_s", "final_world",
    "alert_episodes", "alerts_required", "all_resolved",
    "max_scrape_cycle_s", "min_sink_failures",
    "bundles_per_episode",
})

_AUTOSCALE_KEYS = frozenset({
    "min_world", "max_world", "factor", "interval_s", "warmup_s",
    "cooldown_s", "hysteresis", "step_time_high", "step_time_low",
    "queue_high", "queue_low", "goodput_floor", "evict_stragglers",
    "p99_high", "p99_low", "rules",
})


def _compress_times(obj, factor: float):
    """Divide every virtual duration by ``factor``, in place-ish
    (returns a new structure).  A field is a virtual duration iff its
    key ends in ``_s`` — the schema spells every time field that way —
    except ``tick_s``: the tick period is preserved, so compression
    runs the same scenario shape in fewer ticks."""
    if factor == 1.0:
        return obj

    def scale(v):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return v / factor
        if isinstance(v, list):
            return [scale(x) for x in v]
        if isinstance(v, dict):
            return {k: scale(x) for k, x in v.items()}
        return v

    def walk(v):
        if isinstance(v, dict):
            out = {}
            for k, x in v.items():
                if k.endswith("_s") and k != "tick_s":
                    out[k] = scale(x)
                else:
                    out[k] = walk(x)
            return out
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v

    return walk(obj)


def _fail(name: str, msg: str):
    raise ValueError(f"scenario {name!r}: {msg}")


class Scenario:
    """One validated, host-bound chaos scenario."""

    def __init__(self, raw: dict):
        if not isinstance(raw, dict):
            raise ValueError(
                f"a scenario must be a JSON object, got "
                f"{type(raw).__name__}")
        self.raw = copy.deepcopy(raw)
        name = self.raw.get("name")
        if not name:
            raise ValueError(f"scenario missing a name: {raw!r}")
        self.name = str(name)
        self.description = str(self.raw.get("description", ""))
        self.duration_s = float(self.raw.get("duration_s", 0.0))
        self.tick_s = float(self.raw.get("tick_s", 5.0))
        if self.duration_s <= 0 or self.tick_s <= 0:
            _fail(self.name, "duration_s and tick_s must be > 0")
        self.hosts = int(self.raw.get("hosts", 0))  # 0 = caller default
        self.start_world = int(self.raw.get("start_world", 1))
        self.base_latency_s = float(self.raw.get("base_latency_s", 0.02))
        self.base_goodput = float(self.raw.get("base_goodput", 0.95))

        self.autoscale = dict(self.raw.get("autoscale") or {})
        bad = set(self.autoscale) - _AUTOSCALE_KEYS
        if bad:
            _fail(self.name, f"unknown autoscale override(s) "
                             f"{sorted(bad)} (one of "
                             f"{sorted(_AUTOSCALE_KEYS)})")
        self.alert_rules = list(self.raw.get("alert_rules") or [])

        self.expect = dict(self.raw.get("expect") or {})
        bad = set(self.expect) - _EXPECT_KEYS
        if bad:
            _fail(self.name, f"unknown expect key(s) {sorted(bad)} "
                             f"(one of {sorted(_EXPECT_KEYS)})")

        self.events = []
        for i, ev in enumerate(list(self.raw.get("events") or [])):
            self.events.append(self._validate_event(i, ev))
        self._bound: Optional[int] = None

    # ------------------------------------------------------ validation
    def _validate_event(self, i: int, ev) -> dict:
        if not isinstance(ev, dict):
            _fail(self.name, f"event #{i} is not an object: {ev!r}")
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            _fail(self.name, f"event #{i}: unknown kind {kind!r} "
                             f"(one of {EVENT_KINDS})")
        out = dict(ev)
        out["at_s"] = float(ev.get("at_s", 0.0))
        out["until_s"] = float(ev.get("until_s", self.duration_s))
        if not 0.0 <= out["at_s"] < out["until_s"]:
            _fail(self.name, f"event #{i} ({kind}): need "
                             f"0 <= at_s < until_s, got "
                             f"[{out['at_s']}, {out['until_s']}]")
        for field in _EVENT_REQUIRED[kind]:
            if field not in ev:
                _fail(self.name, f"event #{i} ({kind}): missing "
                                 f"{field!r}")
        sel = ev.get("hosts")
        if sel is not None:
            if not isinstance(sel, dict) or len(sel) != 1 or \
                    next(iter(sel)) not in ("fraction", "count", "ids"):
                _fail(self.name,
                      f"event #{i} ({kind}): hosts selector must be "
                      f"exactly one of fraction/count/ids, got {sel!r}")
        out["hosts"] = sel
        out["_index"] = i
        return out

    # --------------------------------------------------------- binding
    def bind(self, n_hosts: int, seed: int = 0) -> "Scenario":
        """Resolve every event's host selector against a concrete
        fleet size, deterministically from ``seed``."""
        n = int(n_hosts)
        for ev in self.events:
            sel = ev["hosts"]
            if sel is None:
                ev["_ids"] = list(range(n))
                continue
            key, val = next(iter(sel.items()))
            if key == "ids":
                ids = sorted(int(x) for x in val)
                if ids and (ids[0] < 0 or ids[-1] >= n):
                    _fail(self.name,
                          f"event #{ev['_index']}: ids out of range "
                          f"for a {n}-host fleet: {ids}")
            else:
                k = (max(1, int(round(float(val) * n)))
                     if key == "fraction" else min(n, int(val)))
                rng = random.Random(
                    f"{seed}:{self.name}:{ev['_index']}")
                ids = sorted(rng.sample(range(n), k))
            ev["_ids"] = ids
        self._bound = n
        return self

    # ------------------------------------------------------- dynamics
    def _active(self, ev: dict, t: float) -> bool:
        return ev["at_s"] <= t < ev["until_s"]

    def offered(self, t: float) -> Optional[float]:
        """Offered load at virtual time ``t`` (None when no traffic
        event covers it)."""
        for ev in self.events:
            if ev["kind"] != "traffic" or not self._active(ev, t):
                continue
            base = float(ev["base"])
            amp = float(ev.get("amplitude", 0.0))
            if amp == 0.0:
                return base
            period = float(ev.get("period_s",
                                  ev["until_s"] - ev["at_s"]))
            phase = 2.0 * math.pi * (t - ev["at_s"]) / max(1e-9, period)
            return base + amp * 0.5 * (1.0 - math.cos(phase))
        return None

    def sink_poisoned(self, t: float) -> bool:
        return any(ev["kind"] == "poison_sink" and t >= ev["at_s"]
                   for ev in self.events)

    def apply(self, fleet, t: float, world: int):
        """Drive the fleet to this instant's scenario state (stateless
        recompute from the event windows, then edge-triggered up/down
        transitions so a returning host restarts like a fresh
        process)."""
        if self._bound is None or self._bound != len(fleet.hosts):
            raise RuntimeError(
                f"scenario {self.name!r} not bound to this fleet size "
                f"(bind({len(fleet.hosts)}) first)")
        hosts = fleet.hosts
        n = len(hosts)
        want_up = [True] * n
        for h in hosts:
            h.partitioned = False
            h.stalled = False
            h.slow_factor = 1.0
            h.latency_e2e_s = self.base_latency_s
            h.goodput_ratio = self.base_goodput
        for ev in self.events:
            kind = ev["kind"]
            if kind == "preempt":
                stagger = float(ev.get("stagger_s", 0.0))
                down = float(ev["down_s"])
                for idx, hid in enumerate(ev["_ids"]):
                    t0 = ev["at_s"] + idx * stagger
                    if t0 <= t < t0 + down:
                        want_up[hid] = False
                continue
            if not self._active(ev, t):
                continue
            if kind == "flap":
                half = max(1e-9, float(ev["period_s"]) / 2.0)
                if int((t - ev["at_s"]) // half) % 2 == 1:
                    for hid in ev["_ids"]:
                        want_up[hid] = False
            elif kind == "straggler":
                for hid in ev["_ids"]:
                    hosts[hid].slow_factor = float(ev["factor"])
            elif kind == "stall":
                for hid in ev["_ids"]:
                    hosts[hid].stalled = True
            elif kind == "partition":
                for hid in ev["_ids"]:
                    hosts[hid].partitioned = True
            elif kind == "latency":
                for hid in ev["_ids"]:
                    hosts[hid].latency_e2e_s = float(ev["e2e_s"])
            elif kind == "goodput":
                for hid in ev["_ids"]:
                    hosts[hid].goodput_ratio = float(ev["ratio"])
        # up/down edges AFTER all events voted
        for h, want in zip(hosts, want_up):
            if h.up and not want:
                h.up = False
            elif not h.up and want:
                h.restart()
        # traffic: the load the up hosts share, divided by the world
        # the controller bought — scale-ups drain the queue (negative
        # feedback), dead hosts pile their share onto the survivors
        offered = self.offered(t)
        if offered is not None:
            up = max(1, fleet.up_count)
            per_host = offered / max(1, int(world)) * (n / up)
            for h in hosts:
                h.queue_depth = per_host

    def n_ticks(self) -> int:
        return int(math.ceil(self.duration_s / self.tick_s))


# ------------------------------------------------------------ builtins
def _sim_autoscale(**over) -> dict:
    base = dict(min_world=1, max_world=8, factor=2, interval_s=5.0,
                warmup_s=10.0, cooldown_s=60.0, hysteresis=2)
    base.update(over)
    return base


def _queue_alert(value: float, name: str = "queue_backlog") -> dict:
    return {"name": name, "type": "threshold",
            "metric": names.SERVE_QUEUE_DEPTH, "op": ">",
            "value": value, "for": 2, "resolve_for": 2,
            "severity": "warning"}


def _goodput_alert(value: float = 0.5) -> dict:
    return {"name": "goodput_below_target", "type": "threshold",
            "metric": names.GOODPUT_RATIO, "op": "<", "value": value,
            "for": 2, "resolve_for": 2, "severity": "warning"}


BUILTIN_SCENARIOS: Dict[str, dict] = {
    # the capacity wave: traffic swells 20 -> ~1220 and back over the
    # day (the peak deliberately exceeds max-world capacity, so the
    # backlog alert gets real episodes); the controller must ride it up
    # and back down without a single up/down flap inside a cooldown
    # window
    "diurnal": {
        "name": "diurnal",
        "description": "diurnal traffic wave; autoscaler rides it up "
                       "and down without flapping",
        "duration_s": 600.0, "tick_s": 5.0, "start_world": 1,
        "autoscale": _sim_autoscale(queue_high=64.0, queue_low=8.0),
        "alert_rules": [_queue_alert(96.0)],
        "events": [
            {"kind": "traffic", "base": 20.0, "amplitude": 1200.0,
             "period_s": 600.0},
        ],
        "expect": {
            "max_decisions": 8, "min_decisions": 2,
            "reasons": ["queue_high", "queue_low"],
            "final_world": [2, 8],
            "alert_episodes": {"queue_backlog": [1, 4]},
            "alerts_required": ["queue_backlog"],
            "all_resolved": True,
        },
    },
    # correlated stragglers: 10% of hosts run 6x slow for five virtual
    # minutes — the slowest host gates the fleet step-time signal, the
    # per-host goodput alert fires exactly once per slow host
    "stragglers": {
        "name": "stragglers",
        "description": "correlated 6x stragglers on 10% of the fleet; "
                       "worst-host gating + one alert episode each",
        "duration_s": 600.0, "tick_s": 5.0, "start_world": 1,
        "autoscale": _sim_autoscale(step_time_high=0.35, max_world=2),
        "alert_rules": [_goodput_alert(0.5)],
        "events": [
            {"kind": "straggler", "at_s": 150.0, "until_s": 450.0,
             "hosts": {"fraction": 0.1}, "factor": 6.0},
            {"kind": "goodput", "at_s": 150.0, "until_s": 450.0,
             "hosts": {"fraction": 0.1}, "ratio": 0.3},
        ],
        "expect": {
            "max_decisions": 1, "min_decisions": 1,
            "reasons": ["step_time_high"],
            "final_world": [2, 2],
            "alert_episodes": {"goodput_below_target": [1, 1]},
            "alerts_required": ["goodput_below_target"],
            "all_resolved": True,
        },
    },
    # network partition: 30% of peers time out (not 404) for four
    # virtual minutes; absent signals must never breach a rule, and the
    # concurrent scrape must keep the cycle wall bounded
    "partition": {
        "name": "partition",
        "description": "30% of peers time out; conservative no-decision "
                       "degradation + bounded scrape cycles",
        "duration_s": 600.0, "tick_s": 5.0, "start_world": 1,
        "autoscale": _sim_autoscale(queue_high=64.0, queue_low=8.0),
        "alert_rules": [_queue_alert(64.0)],
        "events": [
            {"kind": "traffic", "base": 30.0},
            {"kind": "partition", "at_s": 150.0, "until_s": 400.0,
             "hosts": {"fraction": 0.3}},
        ],
        "expect": {
            "max_decisions": 0,
            "no_decisions_during_s": [[150.0, 400.0]],
            "final_world": [1, 1],
            "max_scrape_cycle_s": 1.0,
        },
    },
    # cascading preemptions: half the fleet drops in a 100s cascade,
    # each host down for two virtual minutes; survivors inherit the
    # load, breach once, the controller buys one doubling, the alert
    # resolves — exactly one episode per survivor
    "preemptions": {
        "name": "preemptions",
        "description": "cascading preemptions of 25% of the fleet; one "
                       "scale-up, one alert episode per survivor",
        "duration_s": 600.0, "tick_s": 5.0, "start_world": 1,
        "autoscale": _sim_autoscale(queue_high=64.0, queue_low=8.0),
        "alert_rules": [_queue_alert(60.0)],
        "events": [
            {"kind": "traffic", "base": 52.0},
            {"kind": "preempt", "at_s": 150.0,
             "hosts": {"fraction": 0.25}, "stagger_s": 2.0,
             "down_s": 120.0},
        ],
        "expect": {
            "max_decisions": 1, "min_decisions": 1,
            "reasons": ["queue_high"],
            "final_world": [2, 2],
            "alert_episodes": {"queue_backlog": [1, 2]},
            "alerts_required": ["queue_backlog"],
            "all_resolved": True,
        },
    },
    # flapping hosts + a poisoned alert sink: intermittent scrape
    # errors and failing sink deliveries must neither thrash the world
    # nor wedge/duplicate alert episodes
    "flapping": {
        "name": "flapping",
        "description": "flapping hosts + poisoned alert sink; no world "
                       "thrash, sink failures counted, episodes intact",
        "duration_s": 600.0, "tick_s": 5.0, "start_world": 1,
        "autoscale": _sim_autoscale(queue_high=64.0, queue_low=8.0),
        "alert_rules": [_goodput_alert(0.5)],
        "events": [
            {"kind": "traffic", "base": 30.0},
            {"kind": "flap", "at_s": 100.0, "until_s": 500.0,
             "hosts": {"count": 4}, "period_s": 40.0},
            {"kind": "goodput", "at_s": 200.0, "until_s": 280.0,
             "ratio": 0.3},
            {"kind": "poison_sink"},
        ],
        "expect": {
            "max_decisions": 0,
            "final_world": [1, 1],
            "alert_episodes": {"goodput_below_target": [1, 1]},
            "alerts_required": ["goodput_below_target"],
            "all_resolved": True,
            "min_sink_failures": 1,
        },
    },
    # alert storm: three separate fleet-wide goodput dips, so every
    # host's goodput alert fires three distinct episodes — and with
    # BIGDL_TORCH_BUNDLE_DIR set the alert->bundle path must cut exactly ONE
    # manifest-valid debug bundle per firing transition (none dropped,
    # none duplicated across racing transitions, none torn)
    "alert_storm": {
        "name": "alert_storm",
        "description": "three goodput-dip pulses; three alert episodes "
                       "per host, one debug bundle per episode",
        "duration_s": 600.0, "tick_s": 5.0, "start_world": 1,
        "autoscale": _sim_autoscale(queue_high=64.0, queue_low=8.0),
        "alert_rules": [_goodput_alert(0.5)],
        "events": [
            {"kind": "goodput", "at_s": 100.0, "until_s": 160.0,
             "ratio": 0.3},
            {"kind": "goodput", "at_s": 250.0, "until_s": 310.0,
             "ratio": 0.3},
            {"kind": "goodput", "at_s": 400.0, "until_s": 460.0,
             "ratio": 0.3},
        ],
        "expect": {
            "max_decisions": 0,
            "final_world": [1, 1],
            "alert_episodes": {"goodput_below_target": [3, 3]},
            "alerts_required": ["goodput_below_target"],
            "all_resolved": True,
            "bundles_per_episode": True,
        },
    },
    # serving latency wave: fleet-wide e2e p99 rises past the band,
    # the controller scales to its ceiling, the wave passes, it scales
    # back — the serving-signal (histogram-bucket) path at fleet scale
    "latency_wave": {
        "name": "latency_wave",
        "description": "fleet-wide p99 wave; latency band scales up to "
                       "the ceiling and back down after",
        "duration_s": 600.0, "tick_s": 5.0, "start_world": 1,
        "autoscale": _sim_autoscale(p99_high=0.25, p99_low=0.05,
                                    max_world=4),
        "events": [
            {"kind": "latency", "at_s": 150.0, "until_s": 450.0,
             "e2e_s": 0.6},
        ],
        "expect": {
            "max_decisions": 6, "min_decisions": 3,
            "reasons": ["latency_p99_high", "latency_p99_low"],
            "final_world": [1, 2],
        },
    },
}


def load_scenario(spec, hosts: int = 0, seed: int = 0,
                  time_compression: float = 1.0) -> Scenario:
    """Resolve + validate one scenario: a builtin name, inline JSON, a
    JSON file path, or an already-parsed dict; then compress its
    virtual timeline and bind its host selectors."""
    if isinstance(spec, Scenario):
        raw = spec.raw
    elif isinstance(spec, dict):
        raw = spec
    elif isinstance(spec, str):
        if spec in BUILTIN_SCENARIOS:
            raw = BUILTIN_SCENARIOS[spec]
        elif spec.lstrip().startswith(("{", "[")):
            raw = json.loads(spec)
        else:
            try:
                with open(spec, "r", encoding="utf-8") as fh:
                    raw = json.load(fh)
            except FileNotFoundError:
                raise ValueError(
                    f"unknown scenario {spec!r}: not a builtin "
                    f"({sorted(BUILTIN_SCENARIOS)}), not inline JSON, "
                    "and no such file") from None
    else:
        raise ValueError(f"cannot load a scenario from "
                         f"{type(spec).__name__}")
    factor = float(time_compression)
    if factor <= 0:
        raise ValueError(f"time_compression must be > 0, got {factor}")
    sc = Scenario(_compress_times(raw, factor))
    n = int(hosts) if hosts else (sc.hosts or 0)
    if n <= 0:
        raise ValueError(f"scenario {sc.name!r}: no host count (pass "
                         "hosts= or set it in the scenario)")
    return sc.bind(n, seed=seed)
