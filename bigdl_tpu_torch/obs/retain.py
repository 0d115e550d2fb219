"""Downsampling retention store — bounded history for fleet metrics.

Counterpart of ``bigdl_tpu/obs/retain.py``, with its rings, budget and
JSONL format.  The live plane (``aggregate``/``rollup``) answers "what is the fleet
doing *now*"; nothing answers "what was it doing two minutes ago"
without re-running a report over JSONL shards.  This store keeps a
small, fixed-budget history of selected series so ``report --watch``
can render trend sparklines:

* three rings per series — ``raw`` (every ingested point), ``10s`` and
  ``1m`` downsamples — each a fixed-capacity deque
  (``BIGDL_TORCH_RETAIN_POINTS``), evictions counted in
  ``bigdl_retain_evictions_total{ring}``;
* downsampling folds the points inside one resolution bucket under the
  family's fleet aggregation policy (``obs/names.py``): ``max``/``min``
  keep the bucket's worst point, ``sum``/``last`` keep the newest —
  correct for cumulative counters, where last-in-bucket *is* the
  bucket's value;
* a hard series budget (``BIGDL_TORCH_RETAIN_SERIES``): past it, new series
  are rejected (memory stays fixed) rather than evicting history;
* torn-write-safe persistence: one JSONL line appended per ingest
  batch under ``BIGDL_TORCH_METRICS_DIR`` (``retain.jsonl``), replayed on
  load with a torn trailing line skipped — the same contract the trace
  shard reader honors.
"""

from __future__ import annotations

import collections
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.obs import names

log = logging.getLogger("bigdl_tpu_torch.obs")

#: (ring name, bucket seconds); raw keeps every point
RINGS: Tuple[Tuple[str, float], ...] = (("raw", 0.0), ("10s", 10.0),
                                        ("1m", 60.0))

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 24) -> str:
    """A unicode block sparkline of the newest ``width`` values
    (empty string for no data; a flat series renders mid-blocks)."""
    vals = [float(v) for v in values][-int(width):]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK_BLOCKS[3] * len(vals)
    span = hi - lo
    return "".join(
        _SPARK_BLOCKS[min(len(_SPARK_BLOCKS) - 1,
                          int((v - lo) / span * len(_SPARK_BLOCKS)))]
        for v in vals)


def _series_id(name: str, labels: Optional[dict]) -> str:
    if not labels:
        return name
    body = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{body}}}"


class RetentionStore:
    """Fixed-budget, policy-downsampled ring store for fleet series."""

    def __init__(self, max_series: Optional[int] = None,
                 points_per_ring: Optional[int] = None,
                 directory: Optional[str] = None, registry=None):
        from bigdl_tpu_torch.config import refresh_from_env

        cfg = refresh_from_env().obs
        self.max_series = (cfg.retain_series if max_series is None
                           else int(max_series))
        self.points = (cfg.retain_points if points_per_ring is None
                       else int(points_per_ring))
        self.directory = directory
        self._registry = registry
        # series id -> ring name -> deque of (t, value)
        self._series: Dict[str, Dict[str, collections.deque]] = {}
        self._policy: Dict[str, str] = {}
        self._rejected = 0
        self._pending: List[list] = []

    # ------------------------------------------------------------ write
    def _rings(self, sid: str) -> Optional[Dict[str, collections.deque]]:
        rings = self._series.get(sid)
        if rings is None:
            if len(self._series) >= self.max_series:
                self._rejected += 1
                return None
            rings = {ring: collections.deque()
                     for ring, _ in RINGS}
            self._series[sid] = rings
        return rings

    def ingest(self, t: float, name: str, value: float,
               labels: Optional[dict] = None, persist: bool = True):
        """Record one point.  Downsampled rings fold the point into
        their current resolution bucket under the family policy; full
        rings evict their oldest point (counted)."""
        sid = _series_id(name, labels)
        rings = self._rings(sid)
        if rings is None:
            return
        policy = self._policy.get(sid)
        if policy is None:
            policy = names.fleet_policy(name) or "last"
            self._policy[sid] = policy
        t, value = float(t), float(value)
        for ring, bucket_s in RINGS:
            dq = rings[ring]
            if bucket_s > 0 and dq:
                last_t, last_v = dq[-1]
                if int(t // bucket_s) == int(last_t // bucket_s):
                    # same resolution bucket: fold, don't append
                    if policy == "max":
                        value_f = max(last_v, value)
                    elif policy == "min":
                        value_f = min(last_v, value)
                    else:  # sum/last: newest point carries the bucket
                        value_f = value
                    dq[-1] = (t, value_f)
                    continue
            if len(dq) >= self.points:
                dq.popleft()
                self._evicted(ring)
            dq.append((t, value))
        self._counter(names.RETAIN_POINTS_TOTAL).inc()
        self._gauge(names.RETAIN_SERIES).set(len(self._series))
        if persist:
            self._pending.append(
                [round(t, 6), name, labels or {}, value])

    def ingest_snapshot(self, t: float, fleet: dict):
        """Convenience for the watch loop: retain the fleet-level
        trend signals out of one ``FleetAggregator.snapshot()``."""
        hosts = (fleet.get("hosts") or {}).values()
        depths = [h.get("queue_depth") for h in hosts
                  if h.get("queue_depth") is not None]
        ratios = [h.get("goodput_ratio")
                  for h in (fleet.get("hosts") or {}).values()
                  if h.get("goodput_ratio") is not None]
        if depths:
            self.ingest(t, names.SERVE_QUEUE_DEPTH, sum(depths))
        if ratios:
            self.ingest(t, names.GOODPUT_RATIO, min(ratios))
        scrape_s = fleet.get("scrape_s")
        if scrape_s is not None:
            self.ingest(t, names.FLEET_SCRAPE_SECONDS, scrape_s)
        self.ingest(t, names.FLEET_STALE_HOSTS,
                    len(fleet.get("stale") or {}))
        self.flush()

    # ------------------------------------------------------------- read
    def series(self, name: str, labels: Optional[dict] = None,
               ring: str = "raw") -> List[Tuple[float, float]]:
        rings = self._series.get(_series_id(name, labels))
        if rings is None or ring not in rings:
            return []
        return list(rings[ring])

    def spark(self, name: str, labels: Optional[dict] = None,
              ring: str = "raw", width: int = 24) -> str:
        return sparkline([v for _, v in self.series(name, labels, ring)],
                         width=width)

    def summary(self) -> dict:
        """Per-series last/min/max over the raw ring — the cross-run
        regression surface a smoke run keeps."""
        out = {}
        for sid, rings in sorted(self._series.items()):
            vals = [v for _, v in rings["raw"]]
            if not vals:
                continue
            out[sid] = {"last": vals[-1], "min": min(vals),
                        "max": max(vals), "n": len(vals),
                        "n_10s": len(rings["10s"]),
                        "n_1m": len(rings["1m"])}
        return out

    @property
    def n_series(self) -> int:
        return len(self._series)

    @property
    def rejected_series(self) -> int:
        return self._rejected

    # ------------------------------------------------------ persistence
    def flush(self):
        """Append pending points as ONE complete JSONL line (atomic
        enough: a torn tail is skipped by :meth:`load`, never a torn
        middle — appends are whole lines)."""
        if not self._pending or not self.directory:
            self._pending = []
            return
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, "retain.jsonl")
        line = json.dumps({"points": self._pending}) + "\n"
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(line)
        self._pending = []

    def load(self) -> int:
        """Replay persisted points (torn trailing line skipped).
        Returns the number of points replayed."""
        if not self.directory:
            return 0
        path = os.path.join(self.directory, "retain.jsonl")
        if not os.path.isfile(path):
            return 0
        n = 0
        with open(path, "rb") as fh:
            data = fh.read()
        for raw in data.split(b"\n"):
            if not raw.strip():
                continue
            try:
                batch = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                continue  # torn tail (or foreign junk): skip, keep going
            for t, name, labels, value in batch.get("points") or []:
                self.ingest(t, name, value, labels or None,
                            persist=False)
                n += 1
        return n

    # ------------------------------------------------------------ meta
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from bigdl_tpu_torch import obs

        return obs.get_registry()

    def _counter(self, name):
        return self._reg().counter(name, names.spec(name).doc,
                                   labels=names.spec(name).labels)

    def _gauge(self, name):
        return self._reg().gauge(name, names.spec(name).doc)

    def _evicted(self, ring: str):
        self._reg().counter(
            names.RETAIN_EVICTIONS_TOTAL,
            names.spec(names.RETAIN_EVICTIONS_TOTAL).doc,
            labels=("ring",)).labels(ring=ring).inc()
