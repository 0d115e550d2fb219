"""Live weight rollout: verified hot swap and canary auto-rollback.

Counterpart of ``bigdl_tpu/serving/rollout.py``, in two halves:

* **engine side**: :class:`CheckpointWatcher` polls a watch directory
  for published checkpoint prefixes (``<version>.model.npz`` +
  ``<version>.manifest.json``).  Each candidate passes
  ``utils.serializer.verify_checkpoint`` before any serving state is
  touched: a torn, truncated or bit-flipped publish is counted
  (``bigdl_rollout_rejected_total{reason}``), stamped as a tracer event
  and never loaded.  A verified one is loaded off the decode path and
  handed to ``LMEngine.swap_weights`` (host to device on the watcher's
  thread, then a pointer flip between two decode steps);
* **router side**: :class:`CanaryController` puts a new version on a
  fraction of the replicas and watches two signals, the
  ``serve_latency_slo_burn`` alert and a token-divergence probe (the
  canary replays pinned prompts at temperature 0 against the
  incumbent).  Consecutive breaches (``for_count``) roll back,
  consecutive clean rounds (``hold_evals``) promote, and a cooldown
  after a rollback refuses new offers.  A rollback drains each canary
  first, so it drops no request.

The controller does no I/O: it drives injected callables
(``set_version`` / ``drain`` / ``undrain`` / ``alerts`` /
``measure_divergence``) on an injectable clock.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.config import RolloutConfig
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.serving import spans

log = logging.getLogger("bigdl_tpu_torch.rollout")

#: the router-tier alert the canary watches next to divergence
SLO_BURN_ALERT = "serve_latency_slo_burn"


# ----------------------------------------------------------------- helpers
def manifest_digest(path_prefix: str) -> Optional[str]:
    """Short sha256 of the checkpoint's manifest file.  The manifest
    records the size and sha256 of each file of the pair, so its digest
    pins the whole checkpoint (``/healthz`` shows it)."""
    p = path_prefix + ".manifest.json"
    if not os.path.exists(p):
        return None
    h = hashlib.sha256()
    with open(p, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:12]


def _reason_class(reason: str) -> str:
    """Collapse verify_checkpoint's free-form reason strings into the
    bounded label set ``bigdl_rollout_rejected_total`` carries."""
    r = (reason or "").lower()
    if "checksum" in r:
        return "checksum"
    if "size" in r:
        return "size"
    if "missing" in r:
        return "missing"
    if "interrupted" in r or "leftover" in r:
        return "torn"
    return "unreadable"


def token_divergence(reference: Sequence[int],
                     candidate: Sequence[int]) -> float:
    """Fraction of mismatched tokens between two decodes of the same
    pinned prompt (position-wise; a length difference counts every
    missing position as a mismatch).  0.0 = bit-equal, 1.0 = nothing
    agrees."""
    a = [int(t) for t in reference]
    b = [int(t) for t in candidate]
    n = max(len(a), len(b))
    if n == 0:
        return 0.0
    bad = sum(1 for x, y in zip(a, b) if x != y) + abs(len(a) - len(b))
    return bad / float(n)


def divergence_probe(canary_generate: Callable[[List[int], int],
                                               Sequence[int]],
                     incumbent_generate: Callable[[List[int], int],
                                                  Sequence[int]],
                     prompts: Sequence[Sequence[int]],
                     max_new_tokens: int) -> Callable[[], float]:
    """Build the canary's ``measure_divergence`` callable: replay every
    pinned prompt at temperature 0 through both versions and return the
    WORST per-prompt :func:`token_divergence` (max, not mean — one
    badly divergent prompt is a real regression even if the rest
    agree)."""
    pinned = [[int(t) for t in p] for p in prompts]
    n = int(max_new_tokens)

    def measure() -> float:
        worst = 0.0
        for p in pinned:
            ref = incumbent_generate(list(p), n)
            got = canary_generate(list(p), n)
            worst = max(worst, token_divergence(ref, got))
        return worst

    return measure


# ----------------------------------------------------------------- publish
def publish_checkpoint(module, directory: str, version: str) -> str:
    """Publish ``module``'s weights into a watch directory as one
    checkpoint prefix: ``<version>.model.npz`` first, then the manifest.
    The manifest lands last, so a watcher that sees one knows the pair
    before it is whole (a crash mid-publish leaves a manifest-less
    prefix the watcher ignores).  Then the fault injector's ``publish``
    site runs (``resilience/faults.py``): damage after the manifest,
    which the watcher's verify-before-swap gate must refuse."""
    from bigdl_tpu_torch.resilience.faults import get_injector
    from bigdl_tpu_torch.utils.serializer import save_module, write_manifest

    os.makedirs(directory, exist_ok=True)
    prefix = os.path.join(directory, str(version))
    save_module(module, prefix + ".model")
    write_manifest(prefix)
    get_injector().on_checkpoint_publish(prefix)
    return prefix


# ----------------------------------------------------------------- watcher
class CheckpointWatcher:
    """Engine-side half: poll a directory, verify, hot-swap.

    ``poll_once()`` is the whole policy (the background thread just
    calls it on a timer): walk the directory's checkpoint prefixes
    oldest-first, skip anything already seen, skip prefixes whose
    manifest has not landed yet (still publishing), reject-and-count
    anything that fails verification, and swap everything that
    passes — so a burst of publishes applies in order and the engine
    ends on the newest verified version."""

    def __init__(self, engine, watch_dir: Optional[str] = None, *,
                 poll_s: Optional[float] = None):
        cfg = RolloutConfig.from_env()
        self.engine = engine
        self.watch_dir = watch_dir or cfg.watch_dir
        if not self.watch_dir:
            raise ValueError(
                "CheckpointWatcher needs a watch directory "
                "(watch_dir= or BIGDL_TORCH_ROLLOUT_WATCH)")
        self.poll_s = float(cfg.poll_s if poll_s is None else poll_s)
        self._seen: set = set()
        self.rejected: Dict[str, str] = {}   # prefix -> verify reason
        self.swapped: List[str] = []         # versions, in swap order
        self._rejected_counter = obs.get_registry().counter(
            names.ROLLOUT_REJECTED_TOTAL,
            names.spec(names.ROLLOUT_REJECTED_TOTAL).doc,
            labels=("reason",))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> Optional[str]:
        """One watch pass; returns the last version swapped in (None if
        nothing new was applied)."""
        from bigdl_tpu_torch.utils.serializer import (
            checkpoint_prefixes, load_module, verify_checkpoint)

        try:
            prefixes = checkpoint_prefixes(self.watch_dir)
        except OSError:
            return None   # directory not created yet — nothing to do
        last = None
        for name in prefixes:
            prefix = os.path.join(self.watch_dir, name)
            if prefix in self._seen:
                continue
            if not os.path.exists(prefix + ".manifest.json"):
                # publish in progress: the manifest is written last, so
                # no manifest = the pair may still be landing.  Not
                # "seen" — the next poll re-checks.
                continue
            ok, reason = verify_checkpoint(prefix)
            if not ok:
                # counted, stamped, never loaded — serving state is
                # untouched by a bad publish
                self._seen.add(prefix)
                self.rejected[prefix] = reason
                self._rejected_counter.labels(
                    reason=_reason_class(reason)).inc()
                obs.get_tracer().event(spans.EVENT_ROLLOUT_REJECT,
                                       version=name, reason=reason)
                log.warning("rollout: refused checkpoint %s (%s)",
                            prefix, reason)
                continue
            module = load_module(prefix + ".model")
            self.engine.swap_weights(module.params(), version=name,
                                     manifest_sha=manifest_digest(prefix))
            self._seen.add(prefix)
            self.swapped.append(name)
            last = name
        return last

    # ------------------------------------------------------ thread plumbing
    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="bigdl-torch-rollout-watch", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — watcher must survive
                log.exception("rollout: watch pass failed")
            self._stop.wait(self.poll_s)

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def stats(self) -> dict:
        return {"watch_dir": self.watch_dir,
                "swapped": list(self.swapped),
                "rejected": dict(self.rejected),
                "engine_version": getattr(self.engine, "weight_version",
                                          None)}


# ------------------------------------------------------------------ canary
class CanaryController:
    """Router-side half: canary a version, watch, roll back or promote.

    States: ``idle`` (everything serves the incumbent) -> ``canary``
    (``offer()`` put the candidate on a fraction of replicas) -> back
    to ``idle`` via either a promote (``hold_evals`` consecutive clean
    ``evaluate()`` rounds -> candidate becomes the incumbent
    everywhere) or a rollback (``for_count`` consecutive breaches of
    either signal -> canaries drain, revert, undrain; a cooldown then
    refuses new offers so the same bad version cannot flap)."""

    def __init__(self, replicas: Sequence[str], *,
                 set_version: Callable[[str, str], None],
                 incumbent: str,
                 measure_divergence: Optional[Callable[[], float]] = None,
                 alerts: Optional[Callable[[], Sequence[str]]] = None,
                 drain: Optional[Callable[[str], None]] = None,
                 undrain: Optional[Callable[[str], None]] = None,
                 fraction: Optional[float] = None,
                 divergence_threshold: Optional[float] = None,
                 for_count: Optional[int] = None,
                 hold_evals: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        cfg = RolloutConfig.from_env()
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("CanaryController needs at least 1 replica")
        self._set_version = set_version
        self._measure = measure_divergence
        self._alerts = alerts
        self._drain = drain
        self._undrain = undrain
        self.fraction = float(cfg.canary_fraction if fraction is None
                              else fraction)
        self.divergence_threshold = float(
            cfg.divergence_threshold if divergence_threshold is None
            else divergence_threshold)
        self.for_count = max(1, int(cfg.for_count if for_count is None
                                    else for_count))
        self.hold_evals = max(1, int(cfg.hold_evals if hold_evals is None
                                     else hold_evals))
        self.cooldown_s = float(cfg.cooldown_s if cooldown_s is None
                                else cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.incumbent = str(incumbent)
        self.candidate: Optional[str] = None
        self.canaries: List[str] = []
        self._state = "idle"
        self._streaks = {"slo_burn": 0, "divergence": 0}
        self._clean_streak = 0
        self._last_rollback_t: Optional[float] = None
        self.rollbacks: List[dict] = []
        self.promotions: List[str] = []
        self.refused_offers = 0
        reg = obs.get_registry()
        self._div_gauge = reg.gauge(
            names.ROLLOUT_CANARY_DIVERGENCE,
            names.spec(names.ROLLOUT_CANARY_DIVERGENCE).doc)
        self._state_gauge = reg.gauge(
            names.ROLLOUT_CANARY_STATE,
            names.spec(names.ROLLOUT_CANARY_STATE).doc)
        self._rollback_counter = reg.counter(
            names.ROLLOUT_ROLLBACKS_TOTAL,
            names.spec(names.ROLLOUT_ROLLBACKS_TOTAL).doc,
            labels=("reason",))
        self._state_gauge.set(0)

    # ------------------------------------------------------------- offering
    def offer(self, version: str, now: Optional[float] = None) -> bool:
        """Offer a new version for canarying.  Refused (False) while a
        canary is already running or inside the post-rollback cooldown;
        on acceptance the candidate is applied to the canary fraction
        (at least one replica, deterministic pick: sorted-name prefix)
        and evaluation begins."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            if self._state != "idle":
                self.refused_offers += 1
                return False
            if (self._last_rollback_t is not None
                    and now - self._last_rollback_t < self.cooldown_s):
                self.refused_offers += 1
                log.warning("rollout: offer of %s refused — %0.1fs left "
                            "in rollback cooldown", version,
                            self.cooldown_s - (now - self._last_rollback_t))
                return False
            n = max(1, int(self.fraction * len(self.replicas)))
            self.canaries = sorted(self.replicas)[:n]
            self.candidate = str(version)
            self._state = "canary"
            self._streaks = {"slo_burn": 0, "divergence": 0}
            self._clean_streak = 0
        for name in self.canaries:
            self._set_version(name, str(version))
        self._state_gauge.set(1)
        self._decision_event("canary", str(version))
        return True

    # ----------------------------------------------------------- evaluation
    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation round.  Reads both signals, advances the
        breach/clean streaks, and fires a rollback or a promote when a
        streak crosses its threshold.  Returns what it saw."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            if self._state != "canary":
                return {"state": self._state}
        active = set(self._alerts() or ()) if self._alerts else set()
        burn = SLO_BURN_ALERT in active
        div = float(self._measure()) if self._measure else 0.0
        self._div_gauge.set(div)
        div_breach = div > self.divergence_threshold
        with self._lock:
            self._streaks["slo_burn"] = (
                self._streaks["slo_burn"] + 1 if burn else 0)
            self._streaks["divergence"] = (
                self._streaks["divergence"] + 1 if div_breach else 0)
            reason = next((r for r in ("slo_burn", "divergence")
                           if self._streaks[r] >= self.for_count), None)
            if reason is None:
                self._clean_streak = (0 if (burn or div_breach)
                                      else self._clean_streak + 1)
                promote = self._clean_streak >= self.hold_evals
            else:
                promote = False
        out = {"state": "canary", "slo_burn": burn, "divergence": div,
               "streaks": dict(self._streaks)}
        if reason is not None:
            self._rollback(reason, now)
            out.update(state="rollback", rollback=reason)
        elif promote:
            self._promote()
            out.update(state="promoted")
        return out

    def _rollback(self, reason: str, now: float):
        """Revert every canary to the incumbent, dropping nothing: each
        canary drains first (its in-flight requests checkpoint into
        version-pinned handoffs the router replays elsewhere), reverts,
        then rejoins placement."""
        with self._lock:
            version = self.candidate
            canaries = list(self.canaries)
            self._state = "rollback"
        self._state_gauge.set(2)
        for name in canaries:
            if self._drain is not None:
                self._drain(name)
            self._set_version(name, self.incumbent)
            if self._undrain is not None:
                self._undrain(name)
        self._rollback_counter.labels(reason=reason).inc()
        with self._lock:
            self.rollbacks.append({"version": version, "reason": reason,
                                   "t": now})
            self._last_rollback_t = now
            self.candidate = None
            self.canaries = []
            self._state = "idle"
        self._state_gauge.set(0)
        self._decision_event("rollback", version, reason=reason)
        log.warning("rollout: rolled back %s (%s), cooldown %.0fs",
                    version, reason, self.cooldown_s)

    def _promote(self):
        """Candidate held clean for ``hold_evals`` rounds: apply it to
        the rest of the fleet and make it the incumbent."""
        with self._lock:
            version = self.candidate
            rest = [n for n in self.replicas if n not in self.canaries]
        for name in rest:
            self._set_version(name, str(version))
        with self._lock:
            self.incumbent = str(version)
            self.candidate = None
            self.canaries = []
            self.promotions.append(str(version))
            self._state = "idle"
        self._state_gauge.set(0)
        self._decision_event("promote", version)
        log.info("rollout: promoted %s fleet-wide", version)

    def _decision_event(self, decision: str, version: Optional[str],
                        **kw):
        obs.get_tracer().event(spans.EVENT_ROLLOUT_DECISION,
                               decision=decision, version=version or "",
                               incumbent=self.incumbent, **kw)

    # -------------------------------------------------------------- reading
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "incumbent": self.incumbent,
                    "candidate": self.candidate,
                    "canaries": list(self.canaries),
                    "streaks": dict(self._streaks),
                    "clean_streak": self._clean_streak,
                    "rollbacks": len(self.rollbacks),
                    "promotions": list(self.promotions),
                    "refused_offers": self.refused_offers}


__all__ = ["CanaryController", "CheckpointWatcher", "SLO_BURN_ALERT",
           "divergence_probe", "manifest_digest", "publish_checkpoint",
           "token_divergence"]
