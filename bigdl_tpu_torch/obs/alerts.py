"""Declarative alert / SLO engine over the live metrics registry.

Counterpart of ``bigdl_tpu/obs/alerts.py``: the same rule types, default
pack, episodes and transition records.  The obs stack *measures* everything (goodput, numerics, stragglers,
checkpoint failures); nothing *decides* anything.  This module is the
decision half: a rule pack evaluated on the goodput window tick — the
host-side hook both optimizers already pay for, so alerting adds zero
new device syncs — with a firing/resolved lifecycle:

=============  =========================================================
rule type      fires when
=============  =========================================================
``threshold``  the metric's worst sample ``op`` value (e.g. goodput
               ratio below target, a peer heartbeat age past budget)
``absence``    the metric has no sample at all (a signal that should
               exist, doesn't)
``rate``       the counter moved by more than ``value`` since the last
               evaluation (non-finite spike, straggler flagged,
               checkpoint write failure)
``burn_rate``  the SLO error budget burns faster than ``threshold``×
               sustainable: ``(1 - ratio) / (1 - slo) >= threshold``
=============  =========================================================

Every rule carries ``for`` (consecutive breached evaluations before
firing — one flaky window is not a page), ``resolve_for`` (consecutive
*good* evaluations before resolving, default 1 — raising it keeps a
gauge that blips good for one window inside the SAME episode instead
of splitting it into two pages) and ``severity``.  Each firing opens a
new per-rule **episode**: a monotonically increasing id stamped on the
``firing`` transition and echoed on its matching ``resolved`` — the
fleet simulator's exactly-once-per-episode invariant pairs transitions
on it, and a sink consumer can dedupe on ``(rule, episode)``.  On a
fire/resolve transition the engine emits ``alert.firing`` /
``alert.resolved`` trace events, increments ``bigdl_alerts_total
{rule,severity}`` / ``bigdl_alerts_resolved_total{rule}``, mirrors
``bigdl_alert_active{rule}`` gauges (what ``/healthz`` and the fleet
aggregator read), and appends the transition to the optional
``BIGDL_TORCH_ALERT_SINK`` (JSONL file, or an http(s):// webhook POST).

Rules come from ``BIGDL_TORCH_ALERT_RULES`` — an inline JSON list or a path
to one — replacing the default pack below; everything is plain host
arithmetic over the registry, unit-testable with a synthetic clock.
"""

from __future__ import annotations

import itertools
import json
import logging
import operator
import threading
import time
from typing import Callable, List, Optional
from bigdl_tpu_torch.obs import names

log = logging.getLogger("bigdl_tpu_torch.obs")

RULE_TYPES = ("threshold", "absence", "rate", "burn_rate")
OPS = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
       ">=": operator.ge, "==": operator.eq, "!=": operator.ne}

_FIRED_META = (names.ALERTS_TOTAL,
               "Alert firing transitions, by rule and severity")
_RESOLVED_META = (names.ALERTS_RESOLVED_TOTAL,
                  "Alert resolved transitions, by rule")
_ACTIVE_META = (names.ALERT_ACTIVE,
                "1 while the rule is firing, 0 otherwise")


def burn_rate(ratio: Optional[float], slo: float) -> float:
    """SLO error-budget burn multiple.

    With an SLO of ``slo`` (e.g. goodput ratio >= 0.9) the error budget
    is ``1 - slo``; a window observing ``ratio`` burns it at
    ``(1 - ratio) / (1 - slo)`` times the sustainable rate — burn 1.0
    exactly exhausts the budget at the SLO boundary, 2.0 halves the
    time to exhaustion.  ``slo >= 1`` means zero budget: any shortfall
    is infinite burn."""
    if ratio is None:
        return 0.0
    bad = max(0.0, 1.0 - float(ratio))
    budget = 1.0 - float(slo)
    if budget <= 0.0:
        return float("inf") if bad > 0 else 0.0
    return bad / budget


def default_rules(heartbeat_timeout: float = 60.0) -> List[dict]:
    """The default pack: one rule per failure mode the earlier PRs can
    already *measure* but nothing *watched*."""
    return [
        {"name": "goodput_below_target", "type": "threshold",
         "metric": names.GOODPUT_RATIO, "op": "<", "value": 0.5,
         "for": 2, "severity": "warning"},
        {"name": "goodput_slo_burn", "type": "burn_rate",
         "metric": names.GOODPUT_WINDOW_RATIO, "slo": 0.5,
         "threshold": 1.5, "for": 2, "severity": "warning"},
        {"name": "nonfinite_spike", "type": "rate",
         "metric": names.NONFINITE_SKIPS_TOTAL, "op": ">", "value": 0,
         "for": 1, "severity": "critical"},
        {"name": "straggler_flagged", "type": "rate",
         "metric": names.STRAGGLER_STEPS_TOTAL, "op": ">", "value": 0,
         "for": 1, "severity": "warning"},
        {"name": "checkpoint_write_failure", "type": "rate",
         "metric": names.CHECKPOINT_WRITE_FAILURES_TOTAL, "op": ">",
         "value": 0, "for": 1, "severity": "critical"},
        {"name": "stale_peer_heartbeat", "type": "threshold",
         "metric": names.HEARTBEAT_AGE_SECONDS, "op": ">",
         "value": max(1.0, float(heartbeat_timeout)) * 0.5,
         "for": 1, "severity": "warning"},
        # overlapped step: the bucketed exchange should hide
        # most of the wire under backward — a sustained exposed-comm
        # share past half the budget means the buckets are too coarse
        # (or comm outruns backward entirely); inert on runs without
        # the overlap gauges (threshold rules never fire on absence)
        {"name": "exposed_comm_high", "type": "threshold",
         "metric": names.OVERLAP_EXPOSED_COMM_FRACTION, "op": ">",
         "value": 0.5, "for": 2, "severity": "warning"},
        # serving tier: the LM engine publishes the fraction
        # of recent requests completing within BIGDL_TORCH_SERVE_SLO_MS as a
        # ratio gauge; burning the 1% error budget at 2x+ sustainable
        # means the p99 SLO is on track to be blown — the serving
        # analogue of goodput_slo_burn.  Inert on non-serving runs
        # (burn_rate rules never fire on an absent metric)
        {"name": "serve_latency_slo_burn", "type": "burn_rate",
         "metric": names.SERVE_LATENCY_SLO_RATIO, "slo": 0.99,
         "threshold": 2.0, "for": 2, "severity": "warning"},
    ]


def load_rules(spec: Optional[str],
               heartbeat_timeout: float = 60.0) -> List[dict]:
    """Resolve ``BIGDL_TORCH_ALERT_RULES``: inline JSON (starts with ``[``)
    or a file path; None/empty = the default pack.  Every rule is
    validated loudly — a typo'd pack must fail at build, not silently
    never fire."""
    if not spec:
        rules = default_rules(heartbeat_timeout)
    else:
        text = spec if spec.lstrip()[:1] in ("[", "{") else \
            open(spec, encoding="utf-8").read()
        rules = json.loads(text)
    if not isinstance(rules, list):
        raise ValueError(f"alert rules must be a JSON list, got "
                         f"{type(rules).__name__}")
    for r in rules:
        kind = r.get("type", "threshold")
        if kind not in RULE_TYPES:
            raise ValueError(f"rule {r.get('name')!r}: unknown type "
                             f"{kind!r}; one of {RULE_TYPES}")
        if not r.get("name"):
            raise ValueError(f"alert rule missing a name: {r}")
        if not r.get("metric"):
            raise ValueError(f"rule {r['name']!r}: missing metric")
        if kind in ("threshold", "rate"):
            if r.get("op", ">") not in OPS:
                raise ValueError(f"rule {r['name']!r}: op {r.get('op')!r}"
                                 f" not in {sorted(OPS)}")
            if "value" not in r:
                raise ValueError(f"rule {r['name']!r}: missing value")
        if kind == "burn_rate" and "slo" not in r:
            raise ValueError(f"rule {r['name']!r}: burn_rate needs slo")
        r.setdefault("type", kind)
        r.setdefault("for", 1)
        r.setdefault("resolve_for", 1)
        if int(r["resolve_for"]) < 1:
            raise ValueError(f"rule {r['name']!r}: resolve_for must be "
                             f">= 1, got {r['resolve_for']!r}")
        r.setdefault("severity", "warning")
    return rules


# ------------------------------------------------------------- engine
class AlertEngine:
    """Evaluate a rule pack against a registry; track lifecycle."""

    # per-engine identity for the bundle dedupe key: (rule, episode)
    # alone collides across engines (the fleet sim runs one real
    # engine per synthetic host in one process)
    _UIDS = itertools.count()

    def __init__(self, rules: List[dict], registry=None,
                 sink: Optional[str] = None,
                 clock: Callable[[], float] = time.time):
        self.uid = next(AlertEngine._UIDS)
        self.rules = list(rules)
        self._registry = registry
        self.sink = sink
        self._clock = clock
        self._lock = threading.Lock()
        # `episode` is the per-rule firing ordinal: incremented when a
        # firing transition opens, echoed on the matching resolve —
        # the identity the exactly-once-per-episode invariant pairs on.
        # `good` is the consecutive-clean streak gating the resolve
        # (the symmetric half of the `for` firing debounce).
        self._state = {r["name"]: {"breaches": 0, "good": 0,
                                   "firing": False, "since": None,
                                   "value": None, "labels": None,
                                   "episode": 0}
                       for r in self.rules}
        # rate baselines are primed at engine build: counts that exist
        # NOW are history (an engine rebuilt mid-run must not re-page
        # old increments), while a counter that first *appears* later —
        # families register lazily on first increment — is a genuine
        # spike measured from zero, not swallowed as history
        self._prev_rate: dict = {}
        for r in self.rules:
            if r.get("type") == "rate":
                samples = self._samples(r["metric"], r.get("labels"))
                self._prev_rate[r["name"]] = sum(v for v, _ in samples)

    def registry(self):
        if self._registry is not None:
            return self._registry
        from bigdl_tpu_torch import obs

        return obs.get_registry()

    # ------------------------------------------------------ resolution
    def _samples(self, metric: str, want_labels: Optional[dict]):
        """[(value, labels)] for every child of ``metric`` whose labels
        contain ``want_labels`` (histograms contribute their count)."""
        out = []
        for fam in self.registry().families():
            if fam.name != metric:
                continue
            for key, child in fam.child_items():
                labels = dict(zip(fam.labelnames, key))
                if want_labels and any(labels.get(k) != str(v)
                                       for k, v in want_labels.items()):
                    continue
                value = (child.count if fam.kind == "histogram"
                         else child.value)
                out.append((float(value), labels))
        return out

    def _worst(self, metric, want_labels, op_name: str):
        """The sample most likely to breach: max for ``>``-ish ops, min
        for ``<``-ish."""
        samples = self._samples(metric, want_labels)
        if not samples:
            return None, None
        pick = min if op_name in ("<", "<=") else max
        return pick(samples, key=lambda s: s[0])

    # ------------------------------------------------------ evaluation
    def _breach(self, rule: dict):
        """-> (breached, value, labels) for one rule, one evaluation."""
        kind = rule["type"]
        metric = rule["metric"]
        want = rule.get("labels")
        if kind == "absence":
            samples = self._samples(metric, want)
            return (not samples), None, want
        if kind == "burn_rate":
            value, labels = self._worst(metric, want, "<")
            if value is None:
                return False, None, None
            burn = burn_rate(value, rule["slo"])
            return burn >= float(rule.get("threshold", 1.0)), \
                round(burn, 4), labels
        op = OPS[rule.get("op", ">")]
        if kind == "rate":
            samples = self._samples(metric, want)
            if not samples:
                return False, None, None
            total = sum(v for v, _ in samples)
            prev = self._prev_rate.get(rule["name"], 0.0)
            self._prev_rate[rule["name"]] = total
            delta = total - prev
            return op(delta, float(rule["value"])), delta, None
        value, labels = self._worst(metric, want, rule.get("op", ">"))
        if value is None:
            return False, None, None
        return op(value, float(rule["value"])), value, labels

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the transition records (one per
        rule that fired or resolved this pass)."""
        now = self._clock() if now is None else now
        transitions = []
        with self._lock:
            for rule in self.rules:
                st = self._state[rule["name"]]
                try:
                    breached, value, labels = self._breach(rule)
                except Exception:  # noqa: BLE001 — one bad rule must not
                    log.exception("alert rule %r evaluation failed",
                                  rule["name"])  # kill the pack
                    continue
                st["value"], st["labels"] = value, labels
                if breached:
                    st["breaches"] += 1
                    st["good"] = 0
                    if not st["firing"] and \
                            st["breaches"] >= int(rule.get("for", 1)):
                        st["firing"] = True
                        st["since"] = now
                        st["episode"] += 1
                        transitions.append(self._transition(
                            "firing", rule, st, now))
                else:
                    st["breaches"] = 0
                    st["good"] += 1
                    # resolve only after `resolve_for` consecutive good
                    # evaluations: a gauge that blips good for one
                    # window mid-incident stays inside the SAME episode
                    # instead of paging a second firing for it
                    if st["firing"] and st["good"] >= int(
                            rule.get("resolve_for", 1)):
                        st["firing"] = False
                        transitions.append(self._transition(
                            "resolved", rule, st, now))
                        st["since"] = None
        for t in transitions:
            self._emit(t)
        return transitions

    def _transition(self, state: str, rule: dict, st: dict,
                    now: float) -> dict:
        return {"state": state, "rule": rule["name"],
                "severity": rule["severity"], "type": rule["type"],
                "metric": rule["metric"], "value": st["value"],
                "labels": st["labels"], "ts": now,
                "since": st["since"], "episode": st["episode"]}

    def _emit(self, t: dict):
        from bigdl_tpu_torch import obs

        reg = self.registry()
        if t["state"] == "firing":
            reg.counter(*_FIRED_META,
                        labels=("rule", "severity")).labels(
                rule=t["rule"], severity=t["severity"]).inc()
            reg.gauge(*_ACTIVE_META, labels=("rule",)).labels(
                rule=t["rule"]).set(1.0)
            log.warning("ALERT firing: %s [%s] %s=%r %s", t["rule"],
                        t["severity"], t["metric"], t["value"],
                        t["labels"] or "")
        else:
            reg.counter(*_RESOLVED_META, labels=("rule",)).labels(
                rule=t["rule"]).inc()
            reg.gauge(*_ACTIVE_META, labels=("rule",)).labels(
                rule=t["rule"]).set(0.0)
            log.info("alert resolved: %s (%s=%r)", t["rule"],
                     t["metric"], t["value"])
        obs.get_tracer().event(f"alert.{t['state']}", rule=t["rule"],
                               severity=t["severity"],
                               metric=t["metric"], value=t["value"],
                               labels=t["labels"],
                               episode=t["episode"])
        if t["state"] == "firing":
            # black-box capture at the moment of trouble: one debug
            # bundle per (engine, rule, episode), rate-limited per
            # rule, only when BIGDL_TORCH_BUNDLE_DIR is set — and best
            # effort: a full disk must not break the page itself
            try:
                from bigdl_tpu_torch.obs import bundle

                bundle.on_alert_firing(t, engine_uid=self.uid)
            except Exception:  # noqa: BLE001 — bundling never blocks alerts
                log.exception("alert bundle capture failed for %s",
                              t["rule"])
        if self.sink:
            _sink_write(self.sink, t)

    def active(self) -> List[dict]:
        """The currently-firing alerts (what ``/healthz`` reports)."""
        with self._lock:
            out = []
            for rule in self.rules:
                st = self._state[rule["name"]]
                if st["firing"]:
                    out.append({"rule": rule["name"],
                                "severity": rule["severity"],
                                "metric": rule["metric"],
                                "value": st["value"],
                                "labels": st["labels"],
                                "since": st["since"],
                                "episode": st["episode"]})
            return out


def _count_sink_failure():
    from bigdl_tpu_torch import obs

    obs.get_registry().counter(
        names.ALERT_SINK_FAILURES_TOTAL,
        "Alert transitions the sink failed to accept (after the "
        "retry)").inc()


def _sink_write(sink: str, record: dict, timeout: Optional[float] = None):
    """Deliver one transition to the sink — JSONL append, or webhook
    POST for http(s):// targets.  Best-effort but BOUNDED: the POST
    carries a connect/read timeout (``BIGDL_TORCH_ALERT_SINK_TIMEOUT``) and
    one retry after the shared jittered backoff
    (:func:`~bigdl_tpu_torch.resilience.retry.backoff_delay` — the immediate
    hot re-POST this used to do just hit the same wedged receiver
    inside the same failure window), so a dead receiver costs the
    goodput window tick at most two timeouts + a sub-second backoff —
    and the loss is visible in ``bigdl_alert_sink_failures_total``,
    never only a log line."""
    payload = json.dumps(record, default=str)
    if sink.startswith(("http://", "https://")):
        if timeout is None:
            from bigdl_tpu_torch.config import ObsConfig

            timeout = ObsConfig.from_env().alert_sink_timeout
        import urllib.request

        from bigdl_tpu_torch.resilience.retry import backoff_delay

        last = None
        for attempt in range(1, 3):  # one retry, jittered backoff
            req = urllib.request.Request(
                sink, data=payload.encode("utf-8"),
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=timeout).close()
                return
            except Exception as e:  # noqa: BLE001 — counted below
                last = e
                if attempt < 2:
                    time.sleep(backoff_delay(attempt, base=0.1, cap=0.5))
        _count_sink_failure()
        log.warning("alert sink %s failed twice (timeout %.1fs): %s",
                    sink, timeout, last)
        return
    try:
        with open(sink, "a", encoding="utf-8") as fh:
            fh.write(payload + "\n")
    except Exception as e:  # noqa: BLE001
        _count_sink_failure()
        log.warning("alert sink %s failed: %s", sink, e)


# ---------------------------------------------------------- singleton
_lock = threading.Lock()
_engine: Optional[AlertEngine] = None
_engine_key = None


def get_engine() -> AlertEngine:
    """The process alert engine, built from the live config and rebuilt
    when the rule pack / sink changes."""
    global _engine, _engine_key
    from bigdl_tpu_torch.config import refresh_from_env

    cfg = refresh_from_env()
    key = (cfg.obs.alert_rules, cfg.obs.alert_sink,
           cfg.train.heartbeat_timeout)
    with _lock:
        if _engine is None or key != _engine_key:
            _engine_key = key
            _engine = AlertEngine(
                load_rules(cfg.obs.alert_rules, cfg.train.heartbeat_timeout),
                sink=cfg.obs.alert_sink)
        return _engine


def maybe_evaluate() -> List[dict]:
    """Best-effort evaluation tick — rides the goodput window tick
    inside the training loop, so it must never raise."""
    try:
        return get_engine().evaluate()
    except Exception:  # noqa: BLE001 — alerting must not break training
        log.exception("alert evaluation failed")
        return []


def reset_engine():
    """Test hook: drop the singleton; the next :func:`get_engine`
    rebuilds from the live config."""
    global _engine, _engine_key
    with _lock:
        _engine = None
        _engine_key = None


__all__ = ["RULE_TYPES", "OPS", "burn_rate", "default_rules", "load_rules",
           "AlertEngine", "get_engine", "maybe_evaluate", "reset_engine"]
