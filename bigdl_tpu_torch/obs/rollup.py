"""Hierarchical fleet rollup — a tier that scrapes N hosts and
re-exposes ONE policy-merged ``/metrics`` exposition.

Counterpart of ``bigdl_tpu/obs/rollup.py``, merging under the port's
``obs/names.py`` policies (the JAX package's).

The flat scrape plane (``obs/aggregate.py``) pulls every host's full
exposition into one process; at 1000 hosts that is 1000 sockets, 1000
parses and an unbounded series count in a single aggregator.  This
module is the tiering layer on top: a :class:`RollupAggregator` owns a
*shard* of hosts, folds their parsed expositions into one merged sample
set under each family's declared fleet aggregation policy
(``obs/names.py``), and re-exposes the merge as a normal Prometheus
text body — so a *root* aggregator scrapes leaf aggregators exactly the
way a leaf scrapes hosts, and a 1000-host fleet costs each node ~√N
fan-in.

Correctness contract (JAX's ``sim/invariants.py`` pins it there):

* ``sum`` families (counters, histogram ``_bucket``/``_sum``/
  ``_count`` samples) merge additively — cumulative bucket counts are
  integers and sum exactly, so a fleet quantile derived from the
  two-tier merge is **bit-identical** to the flat single-tier merge
  (the float ``_sum`` sample alone may differ in its last ulp, since
  float addition is not associative across tiers — quantiles never
  read it);
* ``max``/``min`` fold to the worst host and compose associatively
  across tiers; ``last`` keeps the newest value in scrape order;
* label cardinality is bounded per family by top-K-by-value — dropped
  series fold into an ``other`` bucket (policy-merged, so an ``other``
  histogram series is still exact over its members) and are counted in
  ``bigdl_rollup_series_dropped_total{family}``;
* exemplars ride through the merge newest-timestamp-wins;
* stale hosts (skewed clock / failed scrape — see
  ``FleetAggregator``) are excluded from the merge and accounted in
  ``bigdl_fleet_stale_hosts``, never silently folded in.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs.metrics import (MetricsRegistry, _base_family,
                                   render_exposition)

log = logging.getLogger("bigdl_tpu_torch.obs")

#: label value dropped series fold into under the top-K bound
OTHER = "other"


def _series_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fold(policy: str, old: float, new: float) -> float:
    if policy == "sum":
        return old + new
    if policy == "max":
        return max(old, new)
    if policy == "min":
        return min(old, new)
    return new  # "last": newest in scrape order wins


def merge_parsed(parsed_list: Sequence[dict]) -> dict:
    """Fold a list of :func:`~bigdl_tpu_torch.obs.metrics.parse_prometheus`
    documents (one per live host, scrape order) into one merged
    document under each family's declared fleet policy.  Undeclared
    sample names merge with ``last`` semantics rather than inventing an
    additive meaning for a foreign gauge."""
    families: Dict[str, dict] = {}
    merged: Dict[tuple, dict] = {}
    order: List[tuple] = []
    for parsed in parsed_list:
        if not parsed:
            continue
        for fname, meta in (parsed.get("families") or {}).items():
            cur = families.setdefault(fname, {})
            for k, v in meta.items():
                cur.setdefault(k, v)
        for s in parsed.get("samples") or []:
            name = s["name"]
            labels = dict(s.get("labels") or {})
            key = (name, _series_key(labels))
            policy = names.fleet_policy(name) or "last"
            cur = merged.get(key)
            if cur is None:
                cur = {"name": name, "labels": labels,
                       "value": float(s["value"])}
                merged[key] = cur
                order.append(key)
            else:
                cur["value"] = _fold(policy, cur["value"],
                                     float(s["value"]))
            ex = s.get("exemplar")
            if ex is not None:
                old = cur.get("exemplar")
                if old is None or float(ex.get("ts") or 0.0) >= \
                        float(old.get("ts") or 0.0):
                    cur["exemplar"] = ex
    return {"families": families,
            "samples": [merged[k] for k in order]}


def bound_cardinality(parsed: dict, top_k: Optional[int]
                      ) -> Tuple[dict, Dict[str, int]]:
    """Cap each family at ``top_k`` label sets, keeping the top-K
    by value (histograms rank by their ``_count``) and folding the
    remainder into one ``other`` series per family under the family
    policy.  Returns ``(bounded_doc, {family: n_dropped})``; a
    falsy ``top_k`` is a no-op (the exactness probes compare
    unbounded merges)."""
    if not top_k or top_k <= 0:
        return parsed, {}
    families = parsed.get("families") or {}
    # logical series: histogram _bucket/_sum/_count lines group under
    # their base family with the `le` label ignored, so keep/fold
    # decisions stay consistent across a histogram's derived samples
    groups: Dict[str, Dict[tuple, List[dict]]] = {}
    for s in parsed.get("samples") or []:
        base = _base_family(s["name"], families)
        skey = _series_key({k: v for k, v in
                            (s.get("labels") or {}).items() if k != "le"})
        groups.setdefault(base, {}).setdefault(skey, []).append(s)

    def _rank(entry) -> float:
        _, ss = entry
        for s in ss:
            if s["name"].endswith("_count"):
                return abs(float(s["value"]))
        return max(abs(float(s["value"])) for s in ss)

    out: List[dict] = []
    dropped: Dict[str, int] = {}
    for base, by_series in groups.items():
        entries = list(by_series.items())
        if len(entries) <= top_k or all(not k for k, _ in entries):
            for _, ss in entries:
                out.extend(ss)
            continue
        entries.sort(key=_rank, reverse=True)
        keep, fold = entries[:top_k], entries[top_k:]
        for _, ss in keep:
            out.extend(ss)
        dropped[base] = len(fold)
        folded: Dict[tuple, dict] = {}
        folded_order: List[tuple] = []
        for _, ss in fold:
            for s in ss:
                labels = {k: (v if k == "le" else OTHER)
                          for k, v in (s.get("labels") or {}).items()}
                fkey = (s["name"], _series_key(labels))
                policy = names.fleet_policy(s["name"]) or "last"
                cur = folded.get(fkey)
                if cur is None:
                    folded[fkey] = {"name": s["name"], "labels": labels,
                                    "value": float(s["value"])}
                    folded_order.append(fkey)
                else:
                    cur["value"] = _fold(policy, cur["value"],
                                         float(s["value"]))
        out.extend(folded[k] for k in folded_order)
    return {"families": families, "samples": out}, dropped


def fleet_quantile(parsed: dict, family: str, q: float,
                   **match_labels) -> Optional[float]:
    """Quantile upper bound from a merged document's cumulative
    ``<family>_bucket`` samples (the same first-bucket-past-target rule
    report.py uses) — how a fleet p99 is derived from either a flat or
    a hierarchical merge for the exactness probe."""
    buckets: Dict[float, float] = {}
    bucket_name = family + "_bucket"
    for s in parsed.get("samples") or []:
        if s["name"] != bucket_name:
            continue
        labels = s.get("labels") or {}
        if any(labels.get(k) != str(v) for k, v in match_labels.items()):
            continue
        try:
            le = float(labels.get("le", "nan"))
        except ValueError:
            le = float("inf")  # "+Inf"
        buckets[le] = buckets.get(le, 0.0) + float(s["value"])
    total = buckets.get(float("inf"), 0.0)
    if total <= 0:
        return None
    target = q * total
    for le in sorted(b for b in buckets if b != float("inf")):
        if buckets[le] >= target:
            return le
    return float("inf")


def shard_addrs(addrs: Sequence[str], shard_size: int) -> List[List[str]]:
    """Contiguous shards (order preserved — ``last`` policies then
    compose identically tiered or flat)."""
    shard_size = max(1, int(shard_size))
    addrs = list(addrs)
    return [addrs[i:i + shard_size]
            for i in range(0, len(addrs), shard_size)]


class RollupAggregator:
    """One rollup node: scrape my shard, merge under policy, re-expose.

    ``to_prometheus()`` makes a rollup registrable on a host's obs
    server exactly like an extra registry
    (:func:`bigdl_tpu_torch.obs.server.register_registry`) — an upstream
    scrape of this node transparently drives a downstream shard scrape
    and gets the merge plus the node's self-metrics (tracked series,
    drop counters, memory) in one body."""

    def __init__(self, peers=None, fetch: Optional[Callable] = None,
                 timeout_s: float = 2.0, max_workers: int = 16,
                 top_k: Optional[int] = None,
                 stale_after_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 name: str = "rollup0",
                 refresh_on_scrape: bool = True):
        from bigdl_tpu_torch.config import refresh_from_env
        from bigdl_tpu_torch.obs.aggregate import FleetAggregator

        cfg = refresh_from_env().obs
        self.name = name
        self.top_k = cfg.rollup_top_k if top_k is None else int(top_k)
        self.refresh_on_scrape = bool(refresh_on_scrape)
        self._clock = clock or time.time
        self._agg = FleetAggregator(
            peers=peers, fetch=fetch, timeout_s=timeout_s,
            max_workers=max_workers, stale_after_s=stale_after_s,
            clock=clock)
        # self-metrics live in a private registry appended to the
        # exposition — the meta-observability of the pipeline itself
        self.registry = MetricsRegistry()
        self._merged: dict = {"families": {}, "samples": []}
        self.stale: Dict[str, str] = {}
        self.n_live = 0
        self.last_scrape_s: Optional[float] = None

    @property
    def peers(self) -> List[str]:
        return self._agg.peers

    # ------------------------------------------------------------ cycle
    def refresh(self) -> dict:
        """One scrape+merge cycle over my shard: scrape every peer,
        drop stale/failed hosts (accounted, never folded in), merge the
        live remainder under policy, bound cardinality, publish
        self-metrics.  Returns the merged document."""
        scraped = self._agg.scrape_peers(self._agg.peers)
        self.stale = dict(self._agg.last_stale)
        live = [p for p in scraped
                if p.get("ok") and not p.get("stale")]
        self.n_live = len(live)
        self.last_scrape_s = self._agg.last_scrape_s
        merged = merge_parsed([p.get("metrics") for p in live])
        merged, dropped = bound_cardinality(merged, self.top_k)
        self._merged = merged
        tracked = len(merged["samples"])
        self.registry.gauge(
            names.ROLLUP_SERIES_TRACKED,
            names.spec(names.ROLLUP_SERIES_TRACKED).doc).set(tracked)
        drop_fam = self.registry.counter(
            names.ROLLUP_SERIES_DROPPED_TOTAL,
            names.spec(names.ROLLUP_SERIES_DROPPED_TOTAL).doc,
            labels=("family",))
        for family, n in dropped.items():
            drop_fam.labels(family=family).inc(n)
        self.registry.gauge(
            names.ROLLUP_MEMORY_BYTES,
            names.spec(names.ROLLUP_MEMORY_BYTES).doc).set(
            self.memory_bytes())
        self.registry.gauge(
            names.FLEET_STALE_HOSTS,
            names.spec(names.FLEET_STALE_HOSTS).doc).set(len(self.stale))
        return merged

    def memory_bytes(self) -> int:
        """Approximate bytes of merged-series state this node holds
        (the self-scrape bound)."""
        total = 0
        for s in self._merged["samples"]:
            total += 64 + len(s["name"])
            total += sum(len(k) + len(str(v))
                         for k, v in (s.get("labels") or {}).items())
        return total

    @property
    def tracked_series(self) -> int:
        return len(self._merged["samples"])

    # ------------------------------------------------------- exposition
    def to_prometheus(self) -> str:
        """The merged shard exposition plus this node's self-metrics —
        one text body an upstream tier scrapes like any host."""
        if self.refresh_on_scrape:
            self.refresh()
        return render_exposition(self._merged) + \
            self.registry.to_prometheus()

    def health(self) -> dict:
        """A ``/healthz``-shaped payload so an upstream
        ``FleetAggregator`` scrapes a rollup node with the same
        two-fetch contract it uses on hosts."""
        return {"status": "ok", "host": self.name, "role": "rollup",
                "time": self._clock(), "hosts": self.n_live,
                "stale": len(self.stale), "step": None,
                "goodput_ratio": None, "alerts": [], "heartbeat": None}


def tier_fetch(leaves: Sequence[RollupAggregator]) -> Callable[[str], str]:
    """An injectable ``fetch`` routing ``http://<leaf-name>:9100/...``
    to the in-process leaf rollups — how a test (or one process) wires
    a root aggregator over leaf aggregators without sockets."""
    by_name = {leaf.name: leaf for leaf in leaves}

    def fetch(url: str) -> str:
        rest = url.split("//", 1)[-1]
        host, _, path = rest.partition("/")
        leaf = by_name.get(host.rsplit(":", 1)[0])
        if leaf is None:
            raise ConnectionRefusedError(f"no rollup node for {url}")
        if path.startswith("healthz"):
            return json.dumps(leaf.health())
        if path.startswith("metrics"):
            return leaf.to_prometheus()
        raise ValueError(f"no route {url}")

    return fetch


def build_tiers(addrs: Sequence[str], fetch: Callable[[str], str],
                shard_size: Optional[int] = None,
                top_k: Optional[int] = None,
                stale_after_s: Optional[float] = None,
                clock: Optional[Callable[[], float]] = None,
                timeout_s: float = 2.0, max_workers: int = 16
                ) -> Tuple[RollupAggregator, List[RollupAggregator]]:
    """Assemble a two-tier pipeline over ``addrs``: leaf rollups of
    ``shard_size`` hosts each (default ``BIGDL_TORCH_ROLLUP_SHARD``), one
    root rollup over the leaves.  Returns ``(root, leaves)``; call
    ``root.refresh()`` to drive a full fleet cycle."""
    from bigdl_tpu_torch.config import refresh_from_env

    cfg = refresh_from_env().obs
    if shard_size is None:
        shard_size = cfg.rollup_shard
    leaves = [
        RollupAggregator(peers=shard, fetch=fetch, timeout_s=timeout_s,
                         max_workers=max_workers, top_k=top_k,
                         stale_after_s=stale_after_s, clock=clock,
                         name=f"rollup{i}")
        for i, shard in enumerate(shard_addrs(addrs, shard_size))]
    root = RollupAggregator(
        peers=[f"{leaf.name}:9100" for leaf in leaves],
        fetch=tier_fetch(leaves), timeout_s=timeout_s,
        max_workers=max_workers, top_k=top_k,
        stale_after_s=stale_after_s, clock=clock, name="rollup-root")
    return root, leaves


__all__ = ["OTHER", "merge_parsed", "bound_cardinality", "fleet_quantile",
           "shard_addrs", "RollupAggregator", "tier_fetch", "build_tiers"]
