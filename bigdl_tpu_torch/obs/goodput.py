"""Goodput ledger — wall-clock accounting & bottleneck attribution.

Counterpart of ``bigdl_tpu/obs/goodput.py``, with its causes, shard
format and classification, so that either package's ``report`` and
``aggregate_goodput`` read the other's shards.  Elastic training
restarts; this module measures what that (and everything else)
*costs*.  Every interval of a training run's life is
classified into productive step time vs. a badput cause:

==================   ======================================================
cause                interval
==================   ======================================================
``step``             one resolved train step (the step's batch copy and
                     dispatch -> its observed loss, recorded where
                     the loss resolves, one step late when pipelined)
``compile``          the ``nvcc`` build of a CUDA kernel at its first
                     launch in the process (``ops/_cuda.py``); the port
                     has no jit, so this is the only compile it has
``checkpoint_save``  the synchronous part of a checkpoint write
``checkpoint_restore`` loading a checkpoint (resume, retry reload)
``data_wait``        the trainer blocked on the input pipeline
``eval``             validation triggered mid-run
``startup``          ledger birth -> the first dispatched step
``supervisor_backoff`` the restart supervisor sleeping between launches
``rework``           steps re-executed after a restart: a ``step`` whose
                     number is <= the pre-crash high-water mark (stamped
                     by the elastic resume path) is re-tagged ``rework``
==================   ======================================================

Records persist as per-attempt JSONL shards
(``goodput.h<host>.<pid>.a<attempt>.jsonl``) under ``BIGDL_TORCH_METRICS_DIR``
— host- and attempt-tagged like the metrics shards, flushed by
``obs.flush()`` and its atexit hook, so a crashed attempt still
lands its ledger — and :func:`aggregate_goodput` folds N shards into
ONE cross-restart, cross-host goodput ratio.  The pre-crash high-water
mark itself comes from the *previous attempt's shard*: ``stamp_resume``
scans the ledger directory (plus this process's in-memory records, for
the in-process retry path) for the max step ever reached, so replayed
steps between the restored step and that mark count as ``rework``.

The per-window bottleneck classifier
(:meth:`GoodputLedger._window_tick`, every ``BIGDL_TORCH_GOODPUT_WINDOW``
productive steps) attributes the window to ``input_bound`` /
``compute_bound`` / ``comm_bound`` / ``host_bound`` from the same
interval stream plus the static per-step wire bytes
(obs/collectives.py) and publishes the one-hot ``bigdl_bottleneck``
gauge + a ``goodput.bottleneck`` trace event.

Everything is host-side arithmetic stamped at span boundaries the
optimizers already time — zero new device syncs; with observability off
every call lands on the shared :data:`NULL_LEDGER` no-op.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional
from bigdl_tpu_torch.obs import names

log = logging.getLogger("bigdl_tpu_torch.obs")

# productive + badput causes, most-specific first: when intervals
# overlap (the first step's `step` record contains its compile; the
# startup window contains the restore), the elementary segment is
# charged to the HIGHEST-priority covering cause, so no second is ever
# double-counted and nesting resolves to the most specific explanation
PRIORITY = {
    "checkpoint_restore": 9,
    "checkpoint_save": 8,
    "compile": 7,
    "rework": 6,
    "eval": 5,
    "data_wait": 4,
    "supervisor_backoff": 3,
    "startup": 2,
    "step": 1,
}
CAUSES = tuple(PRIORITY)
BADPUT_CAUSES = tuple(c for c in CAUSES if c != "step")
BOTTLENECKS = ("input_bound", "compute_bound", "comm_bound", "host_bound")

_RATIO_META = (
    names.GOODPUT_RATIO,
    "Productive step seconds over total accounted wall seconds "
    "(this attempt)",
)
_BADPUT_META = (
    names.BADPUT_SECONDS_TOTAL,
    "Non-productive wall seconds, by cause (goodput ledger)",
)
_BOTTLENECK_META = (
    names.BOTTLENECK,
    "One-hot per-window bottleneck classification "
    "(input/compute/comm/host bound)",
)
_REWORK_META = (
    names.REWORK_STEPS_TOTAL,
    "Steps re-executed after a restart (restored step -> pre-crash "
    "high-water mark)",
)
_WINDOW_RATIO_META = (
    names.GOODPUT_WINDOW_RATIO,
    "Good share of the last classifier window's wall clock "
    "(1 - badput/wall; badput = input waits, compiles, checkpoints) "
    "— the live SLO burn-rate signal",
)


def _default_host_id() -> int:
    from bigdl_tpu_torch.obs.trace import _host_id

    return _host_id()


def _attempt_from_env() -> int:
    try:
        from bigdl_tpu_torch.config import TrainConfig

        return int(TrainConfig.from_env().elastic_attempt)
    except Exception:  # noqa: BLE001 — the ledger must never fail bring-up
        return 0


class NullLedger:
    """No-op ledger with the full :class:`GoodputLedger` surface — the
    disabled fast path (shared instance, no clock reads)."""

    __slots__ = ()
    enabled = False
    high_water = 0

    def record(self, kind, start_perf, dur_s, step=None, **attrs):
        pass

    def note_host_seconds(self, seconds):
        pass

    def set_comm_bytes_per_step(self, nbytes):
        pass

    def set_exposed_comm_bytes_per_step(self, nbytes):
        pass

    def set_high_water(self, step):
        pass

    def stamp_resume(self, restored_step=None):
        return 0

    def live_ratio(self):
        return None

    def publish(self, registry=None):
        pass

    def flush(self):
        return None

    def close(self):
        pass

    def records(self):
        return []


NULL_LEDGER = NullLedger()


class GoodputLedger:
    """Recording ledger bound to one output directory + attempt."""

    enabled = True

    def __init__(self, directory: Optional[str], host_id: int = None,
                 attempt: int = None):
        self.host_id = (_default_host_id() if host_id is None
                        else int(host_id))
        self.attempt = (_attempt_from_env() if attempt is None
                        else int(attempt))
        self.pid = os.getpid()
        self.directory = directory
        self.path = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self.path = os.path.join(
                directory,
                f"goodput.h{self.host_id}.{self.pid}.a{self.attempt}.jsonl")
        self._lock = threading.Lock()
        # wall + perf anchors, exactly like the tracer: records carry
        # wall time so cross-attempt/host aggregation has one axis
        self._epoch_wall = time.time()
        self._epoch_perf = time.perf_counter()
        self._records: List[dict] = []
        self._unflushed: List[dict] = []
        self.high_water = 0          # rework watermark (pre-crash max step)
        self._max_step_seen = 0
        self._saw_step = False
        self.comm_bytes_per_step = 0.0
        # bucketed overlap: the share of the static comm
        # budget NOT hidden under backward; None = no overlap model,
        # the classifier then charges the full budget
        self.exposed_comm_bytes_per_step = None
        # running productive/badput seconds — the O(1) live goodput
        # ratio the /healthz endpoint and the alert engine read between
        # full classifications (rework excluded: replay is badput)
        self._productive_s = 0.0
        self._badput_s = 0.0
        # windowed bottleneck classifier accumulators
        self._win_step_s = 0.0
        self._win_wait_s = 0.0
        self._win_host_s = 0.0
        self._win_badput_s = 0.0
        self._win_wall0 = self._epoch_perf
        self._win_steps = 0
        self._win_first_step = None
        self._published_badput: Dict[str, float] = {}
        self._append({"kind": "attempt_start", "wall": self._epoch_wall,
                      "start_perf": self._epoch_perf})

    # ------------------------------------------------------------ internals
    def _wall(self, perf_t: float) -> float:
        return self._epoch_wall + (perf_t - self._epoch_perf)

    def _append(self, rec: dict):
        rec.setdefault("host", self.host_id)
        rec.setdefault("pid", self.pid)
        rec.setdefault("attempt", self.attempt)
        with self._lock:
            self._records.append(rec)
            self._unflushed.append(rec)

    # ------------------------------------------------------------------ API
    def record(self, kind: str, start_perf: float, dur_s: float,
               step: Optional[int] = None, **attrs):
        """Account one wall-clock interval from a ``perf_counter()``
        start + duration (the trainer already holds both at every span
        boundary — no extra clock reads on the hot path)."""
        if kind not in PRIORITY:
            raise ValueError(f"unknown goodput cause {kind!r}; "
                             f"one of {CAUSES}")
        if kind == "step":
            if not self._saw_step:
                # everything from ledger birth to the first dispatched
                # step is startup badput (minus whatever more specific
                # intervals — compile, restore — the classifier carves
                # out of the window)
                self._saw_step = True
                startup_s = max(0.0, self._wall(start_perf)
                                - self._epoch_wall)
                self._append({"kind": "startup", "wall": self._epoch_wall,
                              "dur_s": round(startup_s, 9)})
                # the live counters hold each second once: the badput
                # recorded so far (a restore, a build) lies inside this
                # window (JAX adds both, so a resume's live ratio reads
                # 0 until its productive seconds outgrow the restore)
                extra = max(0.0, startup_s - self._badput_s)
                self._badput_s += extra
                self._win_badput_s = max(self._win_badput_s, startup_s)
            if step is not None and step <= self.high_water:
                kind = "rework"
            if step is not None:
                self._max_step_seen = max(self._max_step_seen, int(step))
        rec = {"kind": kind, "wall": self._wall(start_perf),
               "dur_s": round(float(dur_s), 9)}
        if step is not None:
            rec["step"] = int(step)
        if attrs:
            rec["attrs"] = attrs
        self._append(rec)
        if kind == "step":
            self._productive_s += float(dur_s)
        else:
            # every non-step cause — waits, compiles, checkpoints,
            # eval, backoff, rework replay — burns the live budget
            self._badput_s += float(dur_s)
        if kind in ("step", "rework"):
            self._win_step_s += float(dur_s)
            self._win_steps += 1
            if self._win_first_step is None:
                self._win_first_step = step
            self._maybe_window_tick(step)
        elif kind == "data_wait":
            self._win_wait_s += float(dur_s)
            self._win_badput_s += float(dur_s)
        else:
            self._win_badput_s += float(dur_s)

    def note_host_seconds(self, seconds: float):
        """Host-side per-step overhead (batch prep + device_put +
        dispatch bookkeeping) — feeds the ``host_bound`` share of the
        window classifier without becoming a wall-accounting cause (in
        pipelined steady state it overlaps device compute)."""
        self._win_host_s += max(0.0, float(seconds))

    def set_comm_bytes_per_step(self, nbytes: float):
        """Static per-step collective wire bytes (the DistriOptimizer
        footprint total) — the comm-seconds estimate is
        ``bytes / (BIGDL_TORCH_WIRE_GBPS * 1e9)``."""
        self.comm_bytes_per_step = float(nbytes)

    def set_exposed_comm_bytes_per_step(self, nbytes):
        """Bucketed-overlap model: with K exchange buckets,
        the first K-1 launches ride under the remaining backward — only
        this many bytes are EXPOSED wall time.  The window classifier's
        comm-seconds estimate then uses the exposed bytes, so hiding
        the wire actually moves the ``comm_bound`` verdict.  ``None``
        disables the model (monolithic exchange: everything exposed)."""
        self.exposed_comm_bytes_per_step = (
            None if nbytes is None else float(nbytes))

    def set_high_water(self, step: int):
        """Steps at or below this mark recorded from now on are
        ``rework`` (re-execution after a restart)."""
        self.high_water = max(self.high_water, int(step))

    def stamp_resume(self, restored_step: Optional[int] = None) -> int:
        """Called by the elastic resume paths after a checkpoint load:
        stamp the prior run's max step (from earlier attempts' shards
        in the ledger directory, and from this process's own records
        for the in-process retry path) as the rework high-water mark."""
        hw = self._max_step_seen
        if self.directory:
            try:
                hw = max(hw, prior_high_water(self.directory))
            except OSError:
                pass
        if hw:
            self.set_high_water(hw)
        self._append({"kind": "resume", "wall": time.time(),
                      "restored_step": restored_step,
                      "high_water": self.high_water})
        if hw:
            log.info("goodput: resume at step %s with pre-crash "
                     "high-water mark %d — replayed steps count as "
                     "rework badput", restored_step, self.high_water)
        return self.high_water

    def live_ratio(self) -> Optional[float]:
        """Cheap running goodput ratio for ``/healthz`` and the alert
        engine — O(1), no boundary sweep.  The startup window counts
        only its seconds no earlier badput covered (the one difference
        from JAX's).  Two live bounds exist:
        ``productive/elapsed`` over-counts under async pipelining (a
        dispatch→resolve step span absorbs the next batch's input
        wait), while ``1 - badput/elapsed`` over-counts unattributed
        gaps — so the tighter of the two is served.  The exact
        boundary-sweep classification still happens at publish/flush
        time (too expensive per scrape)."""
        elapsed = time.time() - self._epoch_wall
        if elapsed <= 0:
            return None
        bound_productive = self._productive_s / elapsed
        bound_badput = 1.0 - self._badput_s / elapsed
        return max(0.0, min(1.0, bound_productive, bound_badput))

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    # ----------------------------------------------------- window classifier
    def _maybe_window_tick(self, step):
        from bigdl_tpu_torch.config import ObsConfig

        cfg = ObsConfig.from_env()
        window = cfg.goodput_window
        if window <= 0 or self._win_steps < window:
            return
        step_s, wait_s = self._win_step_s, self._win_wait_s
        host_s, n = self._win_host_s, self._win_steps
        badput_s = self._win_badput_s
        first = self._win_first_step
        now_perf = time.perf_counter()
        win_wall = now_perf - self._win_wall0
        self._win_wall0 = now_perf
        self._win_step_s = self._win_wait_s = self._win_host_s = 0.0
        self._win_badput_s = 0.0
        self._win_steps = 0
        self._win_first_step = None
        comm_s = 0.0
        # the overlap model narrows the comm estimate to the EXPOSED
        # bytes (what backward cannot hide); monolithic runs charge the
        # full static budget as before
        comm_bytes = (self.comm_bytes_per_step
                      if self.exposed_comm_bytes_per_step is None
                      else self.exposed_comm_bytes_per_step)
        if cfg.wire_gbps > 0 and comm_bytes:
            comm_s = n * comm_bytes / (cfg.wire_gbps * 1e9)
        verdict = classify_bottleneck(step_s, wait_s, comm_s, host_s)
        from bigdl_tpu_torch import obs

        registry = obs.get_registry()
        gauge = registry.gauge(*_BOTTLENECK_META, labels=("class",))
        for label in BOTTLENECKS:
            gauge.labels(**{"class": label}).set(
                1.0 if label == verdict["label"] else 0.0)
        # live SLO signals for the alert engine and /healthz: the
        # window's own good share of wall clock (recovers the moment a
        # starved window ends) and the cheap cumulative ratio.  NOT
        # step/(step+wait): under async pipelining the dispatch→resolve
        # step span absorbs the next batch's wait, so that quotient
        # floors near 0.5 in a fully starved run — 1 - badput/wall
        # measures what actually burned the window
        if win_wall > 0:
            registry.gauge(*_WINDOW_RATIO_META).set(
                round(max(0.0, min(1.0, 1.0 - badput_s / win_wall)), 6))
        lr = self.live_ratio()
        if lr is not None:
            registry.gauge(*_RATIO_META).set(round(lr, 6))
        tracer = obs.get_tracer()
        if tracer.enabled:
            tracer.event("goodput.bottleneck", window=n,
                         first_step=first, step=step, **verdict)
            # the device-memory counter track rides the same periodic
            # host-side hook (each card's peak bytes over time)
            from bigdl_tpu_torch.obs.runtime import all_device_memory_stats

            hbm = all_device_memory_stats()
            if hbm:
                tracer.counter("hbm_peak_bytes", **{
                    f"d{i}": s.get("peak_bytes_in_use", 0)
                    for i, s in hbm.items()})
        # the alert engine rides the same tick: pure host arithmetic
        # over the registry, zero new device syncs (obs/alerts.py)
        from bigdl_tpu_torch.obs import alerts

        alerts.maybe_evaluate()

    # -------------------------------------------------------------- export
    def publish(self, registry=None):
        """Mirror this attempt's classification into the registry:
        the ``bigdl_goodput_ratio`` gauge, ``bigdl_badput_seconds_total
        {cause}`` (monotonic — repeated publishes only add deltas) and
        ``bigdl_rework_steps_total``."""
        if registry is None:
            from bigdl_tpu_torch import obs

            registry = obs.get_registry()
        summary = classify_records(self.records())
        if summary["total_s"] <= 0:
            return summary
        registry.gauge(*_RATIO_META).set(summary["goodput_ratio"])
        badput = registry.counter(*_BADPUT_META, labels=("cause",))
        for cause, secs in summary["badput_s"].items():
            prev = self._published_badput.get(cause, 0.0)
            if secs > prev:
                badput.labels(cause=cause).inc(secs - prev)
                self._published_badput[cause] = secs
        if summary["rework_steps"]:
            prev = self._published_badput.get("__rework_steps__", 0)
            delta = summary["rework_steps"] - prev
            if delta > 0:
                registry.counter(*_REWORK_META).inc(delta)
                self._published_badput["__rework_steps__"] = \
                    summary["rework_steps"]
        return summary

    def flush(self):
        """Append the unflushed records to the JSONL shard (crash-safe:
        at most the torn last line is lost, which the readers skip)."""
        if not self.path:
            return None
        with self._lock:
            pending, self._unflushed = self._unflushed, []
        if pending:
            try:
                with open(self.path, "a", encoding="utf-8") as fh:
                    for rec in pending:
                        fh.write(json.dumps(rec, default=str) + "\n")
            except OSError as e:  # a full shared volume must not kill
                log.warning("goodput shard write failed: %s", e)
        return self.path

    def close(self):
        self.flush()


# ------------------------------------------------------------ classification
def classify_bottleneck(step_s: float, wait_s: float, comm_s: float = 0.0,
                        host_s: float = 0.0, *,
                        input_threshold: float = 0.3,
                        comm_threshold: float = 0.4,
                        host_threshold: float = 0.3) -> dict:
    """Attribute one window to input / comm / host / compute.

    ``step_s`` is observed device-step wall time, ``wait_s`` the input
    stall next to it; ``comm_s`` the *estimated* collective share of
    ``step_s`` (static wire bytes / assumed bandwidth) and ``host_s``
    the host-overhead share.  Precedence mirrors how you would fix
    them: a starved input pipeline masks everything else, then the
    wire, then the host; what remains is the device."""
    total = step_s + wait_s
    input_frac = wait_s / total if total > 0 else 0.0
    comm_frac = min(1.0, comm_s / step_s) if step_s > 0 else 0.0
    host_frac = min(1.0, host_s / step_s) if step_s > 0 else 0.0
    if total <= 0:
        label = "compute_bound"
    elif input_frac >= input_threshold:
        label = "input_bound"
    elif comm_frac >= comm_threshold:
        label = "comm_bound"
    elif host_frac >= host_threshold:
        label = "host_bound"
    else:
        label = "compute_bound"
    return {"label": label,
            "input_fraction": round(input_frac, 4),
            "comm_fraction": round(comm_frac, 4),
            "host_fraction": round(host_frac, 4),
            "step_s": round(step_s, 6), "wait_s": round(wait_s, 6)}


def classify_records(records: List[dict]) -> dict:
    """Fold one shard's interval records into seconds-by-cause.

    A boundary sweep over the (possibly overlapping, possibly nested)
    intervals: each elementary segment between consecutive interval
    edges is charged to the highest-:data:`PRIORITY` cause covering it,
    so the first step's embedded compile counts as ``compile`` (not
    double-counted as step) and a restore inside the startup window
    counts as ``checkpoint_restore``.  Wall time inside the attempt
    span covered by NO interval lands in ``unknown_s`` — visible, never
    silently productive.  Marker records (``attempt_start``/``resume``)
    extend the span but carry no duration."""
    intervals = []
    span_lo, span_hi = None, None
    rework_steps = set()
    for rec in records:
        wall = rec.get("wall")
        if wall is None:
            continue
        wall = float(wall)
        dur = float(rec.get("dur_s", 0.0) or 0.0)
        kind = rec.get("kind")
        lo, hi = wall, wall + max(0.0, dur)
        span_lo = lo if span_lo is None else min(span_lo, lo)
        span_hi = hi if span_hi is None else max(span_hi, hi)
        if kind in PRIORITY and dur > 0:
            intervals.append((lo, hi, kind))
            if kind == "rework" and rec.get("step") is not None:
                rework_steps.add((rec.get("host", 0), int(rec["step"])))
    seconds = {c: 0.0 for c in CAUSES}
    steps = sum(1 for rec in records if rec.get("kind") == "step")
    if span_lo is None:
        return {"seconds": seconds, "total_s": 0.0, "productive_s": 0.0,
                "badput_s": {}, "unknown_s": 0.0, "goodput_ratio": None,
                "steps": 0, "rework_steps": 0}
    # boundary sweep: O(edges * intervals) — offline analysis over at
    # most a few thousand records per shard
    edges = sorted({e for lo, hi, _ in intervals for e in (lo, hi)}
                   | {span_lo, span_hi})
    covered = 0.0
    for a, b in zip(edges, edges[1:]):
        if b <= a:
            continue
        best = None
        for lo, hi, kind in intervals:
            if lo <= a and hi >= b:
                if best is None or PRIORITY[kind] > PRIORITY[best]:
                    best = kind
        if best is not None:
            seconds[best] += b - a
            covered += b - a
    total = span_hi - span_lo
    unknown = max(0.0, total - covered)
    productive = seconds["step"]
    badput = {c: round(s, 6) for c, s in seconds.items()
              if c != "step" and s > 0}
    return {
        "seconds": {c: round(s, 6) for c, s in seconds.items()},
        "total_s": round(total, 6),
        "productive_s": round(productive, 6),
        "badput_s": badput,
        "unknown_s": round(unknown, 6),
        "goodput_ratio": (productive / total) if total > 0 else None,
        "steps": steps,
        "rework_steps": len(rework_steps),
    }


# ------------------------------------------------------------ shard reading
def read_ledger_shards(directory: str) -> List[dict]:
    """Every ``goodput.*.jsonl`` shard under ``directory`` —
    ``[{path, host, pid, attempt, records}]``, torn tail lines skipped
    (a crashed attempt's partial shard still aggregates)."""
    shards = []
    if not directory or not os.path.isdir(directory):
        return shards
    for fn in sorted(os.listdir(directory)):
        if not (fn.startswith("goodput.") and fn.endswith(".jsonl")):
            continue
        recs = []
        with open(os.path.join(directory, fn), encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a crashed writer
                if isinstance(rec, dict):
                    recs.append(rec)
        if recs:
            first = recs[0]
            shards.append({"path": os.path.join(directory, fn),
                           "host": int(first.get("host", 0)),
                           "pid": int(first.get("pid", 0)),
                           "attempt": int(first.get("attempt", 0)),
                           "records": recs})
    return shards


def prior_high_water(directory: str) -> int:
    """The max step any ledger shard in ``directory`` ever recorded —
    the pre-crash high-water mark a resumed attempt reworks up to."""
    hw = 0
    for shard in read_ledger_shards(directory):
        for rec in shard["records"]:
            if rec.get("kind") in ("step", "rework") \
                    and rec.get("step") is not None:
                hw = max(hw, int(rec["step"]))
    return hw


def aggregate_goodput(directory: str) -> Optional[dict]:
    """Cross-attempt, cross-host goodput: classify every shard
    independently (each has its own wall-clock span, so two attempts'
    spans never overlap-cancel) and sum the seconds.  Returns None when
    the directory holds no ledger shards."""
    shards = read_ledger_shards(directory)
    if not shards:
        return None
    seconds = {c: 0.0 for c in CAUSES}
    total = productive = unknown = 0.0
    steps = rework_steps = 0
    per_attempt = []
    for shard in shards:
        s = classify_records(shard["records"])
        for c in CAUSES:
            seconds[c] += s["seconds"].get(c, 0.0)
        total += s["total_s"]
        productive += s["productive_s"]
        unknown += s["unknown_s"]
        steps += s["steps"]
        rework_steps += s["rework_steps"]
        per_attempt.append({
            "host": shard["host"], "attempt": shard["attempt"],
            "pid": shard["pid"], "total_s": s["total_s"],
            "goodput_ratio": s["goodput_ratio"], "steps": s["steps"]})
    badput = {c: round(s, 6) for c, s in seconds.items()
              if c != "step" and s > 0}
    return {
        "attempts": len({(s["host"], s["attempt"], s["pid"])
                         for s in shards}),
        "hosts": sorted({s["host"] for s in shards}),
        "total_s": round(total, 6),
        "productive_s": round(productive, 6),
        "badput_s": badput,
        "unknown_s": round(unknown, 6),
        "goodput_ratio": (productive / total) if total > 0 else None,
        "steps": steps,
        "rework_steps": rework_steps,
        "per_attempt": per_attempt,
    }


# ----------------------------------------------------------------- singleton
_lock = threading.Lock()
_ledger = NULL_LEDGER
_ledger_key = None


def get_ledger():
    """The process ledger — a recording :class:`GoodputLedger` when
    observability is active (shard under ``metrics_dir``, falling back
    to ``trace_dir``; in-memory only when neither is set), else the
    shared :data:`NULL_LEDGER`.  Rebuilt when the directory changes."""
    global _ledger, _ledger_key
    from bigdl_tpu_torch.config import refresh_from_env

    cfg = refresh_from_env().obs
    key = (cfg.active, cfg.metrics_dir or cfg.trace_dir,
           _attempt_from_env())
    with _lock:
        if key != _ledger_key:
            if _ledger is not NULL_LEDGER:
                try:
                    _ledger.close()
                except Exception:  # noqa: BLE001 — half-torn test dirs
                    pass
            _ledger_key = key
            _ledger = (GoodputLedger(key[1], attempt=key[2])
                       if key[0] else NULL_LEDGER)
        return _ledger


def reset_ledger():
    """Test hook: close and drop the singleton; the next
    :func:`get_ledger` rebuilds from the live config."""
    global _ledger, _ledger_key
    with _lock:
        if _ledger is not NULL_LEDGER:
            try:
                _ledger.close()
            except Exception:  # noqa: BLE001
                pass
        _ledger = NULL_LEDGER
        _ledger_key = None


__all__ = ["PRIORITY", "CAUSES", "BADPUT_CAUSES", "BOTTLENECKS",
           "NullLedger", "NULL_LEDGER", "GoodputLedger",
           "classify_bottleneck", "classify_records", "read_ledger_shards",
           "prior_high_water", "aggregate_goodput", "get_ledger",
           "reset_ledger"]
