"""Multi-host trace aggregation — N per-host shards, one timeline.

Counterpart of ``bigdl_tpu/obs/aggregate.py``: the same merge, alignment,
straggler detector and fleet scrape, so that either package merges the
other's shards to the same document.  Each process's :class:`~bigdl_tpu_torch.obs.trace.Tracer` writes a private
``<app>.h<host>.<pid>.<seq>.events.jsonl`` shard into the (shared)
trace directory; nothing at runtime ever crosses hosts.  This module is
the offline half: it merges every shard in a directory into ONE
Perfetto-loadable Chrome ``trace_event`` JSON, with

* **host-tagged spans** — every merged event carries ``host``/``pid``
  in its args and renders under a ``host<h> pid<p>`` process track;
* **clock alignment on a shared barrier** — hosts' wall clocks disagree
  (NTP skew is routinely milliseconds, and the per-process
  ``time.time()`` anchor adds more).  ``Engine.init`` emits an
  ``engine.init_barrier`` instant event right after the process group
  is joined (``init_process_group`` returns on every rank only once all
  have joined — the closest thing the program has to a global
  barrier), so shifting each shard to make the barrier events
  coincide removes the skew instead of baking it silently into the
  timeline.  The applied per-shard offsets are preserved in
  ``otherData.offsets_s`` — the skew stays *visible*;
* shards with no barrier event merge unaligned (offset 0) and are
  flagged, never dropped.

CLI::

    python -m bigdl_tpu_torch.obs.aggregate TRACE_DIR [-o merged.trace.json]

The cross-worker timeline answers "which worker stalled the
collective?" for ``DistriOptimizer`` runs of N ranks; a supervised
run's attempts (one process each) merge the same way.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import time
from typing import List, Optional
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.resilience.retry import RetryBudget, backoff_delay

# the alignment anchor Engine.init emits after multi-host bring-up
BARRIER_EVENT = "engine.init_barrier"

# the per-host step span the straggler detector keys on (the
# dispatch -> resolved-loss wall time both optimizers emit)
STEP_SPAN = "computing"


class Shard:
    """One per-process events shard: parsed records + identity."""

    def __init__(self, path: str, records: List[dict]):
        self.path = path
        self.records = records
        first = records[0] if records else {}
        self.host = int(first.get("host", 0))
        self.pid = int(first.get("pid", 0))
        self.offset_s = 0.0
        self.aligned = False

    def barrier_wall(self, barrier: str = BARRIER_EVENT) -> Optional[float]:
        """Wall time of the FIRST barrier event in this shard (restarts
        re-emit it; the first is the bring-up one)."""
        for rec in self.records:
            if rec.get("name") == barrier:
                return float(rec["wall_time"])
        return None


def read_shards(trace_dir: str) -> List[Shard]:
    """Every ``*.events.jsonl`` shard in a directory, malformed lines
    skipped (a crash mid-write loses at most its last line)."""
    shards = []
    for fn in sorted(os.listdir(trace_dir)):
        if not fn.endswith(".events.jsonl"):
            continue
        recs = []
        with open(os.path.join(trace_dir, fn), encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line
                if isinstance(rec, dict) and "wall_time" in rec:
                    recs.append(rec)
        if recs:
            shards.append(Shard(os.path.join(trace_dir, fn), recs))
    return shards


def align_shards(shards: List[Shard],
                 barrier: str = BARRIER_EVENT) -> List[Shard]:
    """Compute per-shard clock offsets so every shard's barrier event
    lands at the same merged instant (the latest barrier wall time is
    the reference — offsets stay additive-positive for the laggards'
    view, and the choice is arbitrary for correctness)."""
    walls = {}
    for s in shards:
        w = s.barrier_wall(barrier)
        if w is not None:
            walls[id(s)] = w
    if walls:
        ref = max(walls.values())
        for s in shards:
            w = walls.get(id(s))
            if w is not None:
                s.offset_s = ref - w
                s.aligned = True
    return shards


def _p50(values: List[float]) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    return vs[min(len(vs) - 1, max(0, math.ceil(0.5 * len(vs)) - 1))]


def detect_stragglers(shards: List[Shard],
                      factor: Optional[float] = None) -> dict:
    """Cross-host straggler detection over the merged timeline.

    Two signals from the per-host ``computing`` (step) spans:

    * **host-level skew** — a host whose step-time p50 exceeds the
      cross-host median of p50s by ``factor`` is flagged (the chronic
      straggler that drags every synchronous collective);
    * **per-step skew** — for every step present on >= 2 hosts, a host
      slower than that step's cross-host median by ``factor`` counts
      one ``bigdl_straggler_steps_total{host}`` increment (the
      intermittent straggler a p50 hides).

    ``factor`` defaults to ``BIGDL_TORCH_STRAGGLER_FACTOR`` (1.5); <= 1
    disables.  Works on wall durations only — clock *offsets* (which
    the barrier alignment removes) cannot fake a slow duration.
    Returns ``{factor, hosts: {host: {p50, steps, straggler_steps}},
    median_p50, stragglers: [host, ...]}``."""
    if factor is None:
        from bigdl_tpu_torch.config import refresh_from_env

        factor = refresh_from_env().obs.straggler_factor
    factor = float(factor)
    # host -> {step -> [durs]} and host -> [durs]
    by_host: dict = {}
    by_host_step: dict = {}
    for s in shards:
        for rec in s.records:
            if rec.get("kind") != "span" or rec.get("name") != STEP_SPAN:
                continue
            dur = float(rec.get("dur_s", 0.0))
            by_host.setdefault(s.host, []).append(dur)
            step = (rec.get("attrs") or {}).get("step")
            if step is not None:
                by_host_step.setdefault(int(step), {}).setdefault(
                    s.host, []).append(dur)
    hosts = {h: {"p50": _p50(durs), "steps": len(durs),
                 "straggler_steps": 0}
             for h, durs in by_host.items()}
    out = {"factor": factor, "hosts": hosts, "median_p50": None,
           "stragglers": []}
    if factor <= 1.0 or len(hosts) < 2:
        return out
    median = _p50([v["p50"] for v in hosts.values()
                   if v["p50"] is not None])
    out["median_p50"] = median
    if median:
        out["stragglers"] = sorted(
            h for h, v in hosts.items()
            if v["p50"] is not None and v["p50"] > median * factor)
    for step, per_host in by_host_step.items():
        if len(per_host) < 2:
            continue
        step_durs = {h: _p50(d) for h, d in per_host.items()}
        step_median = _p50(list(step_durs.values()))
        if not step_median:
            continue
        for h, d in step_durs.items():
            if d > step_median * factor:
                hosts[h]["straggler_steps"] += 1
    # surface the counts as the labeled counter so in-process callers
    # (tests, a supervisor aggregating between launches) can scrape them
    if any(v["straggler_steps"] for v in hosts.values()) \
            or out["stragglers"]:
        from bigdl_tpu_torch import obs

        counter = obs.get_registry().counter(
            names.STRAGGLER_STEPS_TOTAL,
            "Steps on which a host exceeded the cross-host median step "
            "time by BIGDL_TORCH_STRAGGLER_FACTOR", labels=("host",))
        for h, v in hosts.items():
            if v["straggler_steps"]:
                counter.labels(host=h).inc(v["straggler_steps"])
    return out


def merge_shards(shards: List[Shard], barrier: str = BARRIER_EVENT) -> dict:
    """Merge aligned shards into one Chrome ``trace_event`` document.

    Chrome pids must be small ints and hosts may reuse OS pids, so each
    shard gets a synthetic process id with a ``host<h> pid<p>``
    process_name; original identities ride in every event's args."""
    if not shards:
        raise ValueError("no trace shards to merge")
    align_shards(shards, barrier)
    t0 = min(rec["wall_time"] + s.offset_s
             for s in shards for rec in s.records)
    meta, events = [], []
    for i, s in enumerate(sorted(shards, key=lambda s: (s.host, s.pid,
                                                        s.path))):
        cpid = i + 1
        meta.append({"name": "process_name", "ph": "M", "pid": cpid,
                     "tid": 0,
                     "args": {"name": f"host{s.host} pid{s.pid}"
                              + ("" if s.aligned else " (unaligned)")}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": cpid,
                     "tid": 0, "args": {"sort_index": s.host}})
        for rec in s.records:
            ts = round((rec["wall_time"] + s.offset_s - t0) * 1e6, 3)
            args = dict(rec.get("attrs") or {})
            args["host"] = s.host
            args["pid"] = s.pid
            ev = {"name": rec["name"], "ts": ts, "pid": cpid,
                  "tid": int(rec.get("tid", 1)), "args": args}
            if rec.get("kind") == "span":
                ev["ph"] = "X"
                ev["dur"] = round(float(rec.get("dur_s", 0.0)) * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
    # cross-host straggler detection rides the merge: each flagged host
    # gets one `straggler` instant event at the end of the timeline so
    # the skew is ON the Perfetto view, not only in the summary
    stragglers = detect_stragglers(shards)
    host_cpid = {}
    for i, s in enumerate(sorted(shards, key=lambda s: (s.host, s.pid,
                                                        s.path))):
        host_cpid.setdefault(s.host, i + 1)
    end_ts = events[-1]["ts"] if events else 0.0
    for h in stragglers["stragglers"]:
        info = stragglers["hosts"].get(h, {})
        events.append({
            "name": "straggler", "ph": "i", "s": "g", "ts": end_ts,
            "pid": host_cpid.get(h, 1), "tid": 0,
            "args": {"host": h, "p50_s": info.get("p50"),
                     "median_p50_s": stragglers["median_p50"],
                     "factor": stragglers["factor"],
                     "straggler_steps": info.get("straggler_steps")}})
    # a monotone timeline: Perfetto tolerates disorder, humans and the
    # monotonicity tests do not
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_shards": len(shards),
            "barrier": barrier,
            "wall_epoch": t0,
            "offsets_s": {
                f"host{s.host}/pid{s.pid}": round(s.offset_s, 6)
                for s in shards},
            "unaligned": [f"host{s.host}/pid{s.pid}"
                          for s in shards if not s.aligned],
            "stragglers": stragglers,
        },
    }


def merge_trace_dir(trace_dir: str, out_path: Optional[str] = None,
                    barrier: str = BARRIER_EVENT) -> dict:
    """Merge every shard under ``trace_dir``; write the merged Chrome
    trace (atomic replace) when ``out_path`` is given.  Returns a
    summary dict (shards, events, offsets, output path)."""
    shards = read_shards(trace_dir)
    doc = merge_shards(shards, barrier=barrier)
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, default=str)
        os.replace(tmp, out_path)
    return {
        "shards": len(shards),
        "hosts": sorted({s.host for s in shards}),
        "events": sum(len(s.records) for s in shards),
        "offsets_s": doc["otherData"]["offsets_s"],
        "unaligned": doc["otherData"]["unaligned"],
        "stragglers": doc["otherData"]["stragglers"]["stragglers"],
        "out": out_path,
    }


# ------------------------------------------------------------ live fleet
class ShardTailer:
    """Incremental ``metrics.*.jsonl`` tailing — the *live* reader for
    the shards the registry snapshots append to.

    A full re-read per refresh is O(run length); a dashboard refreshing
    every second needs O(new lines).  Each poll seeks every shard to
    its stored offset, consumes only complete new lines (a torn tail
    line stays unconsumed until its newline lands — the same
    torn-write tolerance the offline readers have), and keeps the
    newest parsed snapshot per shard.  A shard that shrank (truncated
    or replaced between runs) is re-read from zero."""

    def __init__(self, directory: str):
        self.directory = directory
        self._offsets: dict = {}
        self.latest: dict = {}   # shard filename -> newest snapshot

    def poll(self) -> dict:
        """Consume new lines from every shard; returns ``latest``."""
        if not self.directory or not os.path.isdir(self.directory):
            return self.latest
        for fn in sorted(os.listdir(self.directory)):
            if not (fn.startswith("metrics.") and fn.endswith(".jsonl")):
                continue
            path = os.path.join(self.directory, fn)
            try:
                size = os.path.getsize(path)
                offset = self._offsets.get(fn, 0)
                if size < offset:
                    offset = 0  # truncated/replaced: start over
                if size == offset:
                    continue
                with open(path, "rb") as fh:
                    fh.seek(offset)
                    chunk = fh.read(size - offset)
            except OSError:
                continue
            # only complete lines advance the offset
            consumed = chunk.rfind(b"\n") + 1
            if consumed <= 0:
                continue
            self._offsets[fn] = offset + consumed
            for line in chunk[:consumed].splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    snap = json.loads(line.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                if isinstance(snap, dict) and "metrics" in snap:
                    snap.setdefault("shard", fn)
                    self.latest[fn] = snap
        return self.latest


class FleetAggregator:
    """One in-memory fleet snapshot from N hosts, while they run.

    Two sources, same output shape:

    * **peer scraping** — ``BIGDL_TORCH_OBS_PEERS="h0:8080,h1:8080"`` (or a
      peers list): each refresh GETs every peer's ``/healthz`` and
      ``/metrics`` (parsed by :func:`~bigdl_tpu_torch.obs.metrics.
      parse_prometheus`), so the snapshot is as fresh as the scrape;
    * **shard tailing** — no peers: incrementally tail the
      ``metrics.*.jsonl`` shards under ``metrics_dir`` (each host's
      snapshot writer appends there), as stale as the hosts' last
      flush but needing only a shared filesystem.

    ``snapshot()`` returns ``{mode, hosts: {host: {status, step,
    step_age_s, goodput_ratio, alerts, source}}, alerts: [...],
    metrics: {name: [{labels, value, source}]}, errors: {source:
    reason}, stale: {source: reason}}`` — what ``report --watch``
    renders and the autoscaling policy loop reads.  ``fetch`` is
    injectable for tests (no sockets); ``clock`` is injectable so the
    sims run staleness detection on virtual time.

    Staleness contract: every ok peer's ``/healthz`` ``time`` is
    compared against this scraper's clock; a skew past
    ``stale_after_s`` (``BIGDL_TORCH_STALE_AFTER_S``) flags the host stale —
    its metrics are *excluded* from ``snapshot()``/rollup merges and
    *accounted* in ``bigdl_fleet_stale_hosts``, never silently folded
    into fleet percentiles.  Failed scrapes count stale the same way."""

    def __init__(self, peers=None, metrics_dir: Optional[str] = None,
                 fetch=None, timeout_s: float = 2.0,
                 max_workers: int = 16,
                 retry_budget: Optional[RetryBudget] = None,
                 stale_after_s: Optional[float] = None,
                 clock=None):
        if isinstance(peers, str):
            peers = [p.strip() for p in peers.split(",") if p.strip()]
        self.peers = list(peers or [])
        self.metrics_dir = metrics_dir
        self.timeout_s = float(timeout_s)
        self.max_workers = max(1, int(max_workers))
        self.last_scrape_s: Optional[float] = None
        self.last_stale: dict = {}
        self._clock = clock or time.time
        if stale_after_s is None:
            try:
                from bigdl_tpu_torch.config import refresh_from_env

                stale_after_s = refresh_from_env().obs.stale_after_s
            except Exception:  # noqa: BLE001 — config must not sink this
                stale_after_s = 30.0
        self.stale_after_s = float(stale_after_s)
        self._fetch = fetch or self._http_fetch
        # the serving router's shared token bucket, reused here: one
        # flaky peer gets a second chance, a partitioned fleet does NOT
        # double the scrape cycle (the bucket drains after ~burst
        # retries and every further down peer costs one timeout, same
        # as before retries existed)
        self.retry_budget = retry_budget or RetryBudget(
            ratio=0.1, burst=4.0)
        self._tailer = (ShardTailer(metrics_dir)
                        if metrics_dir and not self.peers else None)

    @classmethod
    def from_config(cls) -> "FleetAggregator":
        from bigdl_tpu_torch.config import refresh_from_env

        cfg = refresh_from_env().obs
        return cls(peers=cfg.obs_peers,
                   metrics_dir=cfg.metrics_dir or cfg.trace_dir)

    def _http_fetch(self, url: str) -> str:
        import urllib.request

        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read().decode("utf-8")

    # ------------------------------------------------------ peer scrape
    def _scrape_once(self, base: str, out: dict) -> None:
        out["health"] = json.loads(self._fetch(base + "/healthz"))
        from bigdl_tpu_torch.obs.metrics import parse_prometheus

        out["metrics"] = parse_prometheus(self._fetch(base + "/metrics"))
        out["ok"] = True

    def scrape_peer(self, addr: str) -> dict:
        """One peer's ``/healthz`` + ``/metrics`` (metrics parse errors
        are loud per the parse_prometheus contract; transport errors
        mark the peer down, they never raise).  A transport failure
        gets ONE more attempt after a jittered backoff while the shared
        :class:`~bigdl_tpu_torch.resilience.retry.RetryBudget` grants a token
        — so a single flaky peer doesn't flap the fleet snapshot, but a
        partition (every peer failing) drains the bucket and degrades
        to single attempts instead of doubling the cycle."""
        base = addr if addr.startswith("http") else f"http://{addr}"
        out = {"addr": addr, "ok": False, "health": None, "metrics": None}
        t0 = time.perf_counter()
        self.retry_budget.record_request()
        try:
            self._scrape_once(base, out)
            out["latency_s"] = time.perf_counter() - t0
            return out
        except Exception as e:  # noqa: BLE001 — a dead peer is data
            out["error"] = f"{type(e).__name__}: {e}"
        if self.retry_budget.try_spend():
            time.sleep(backoff_delay(1, base=0.02, cap=0.2))
            try:
                self._scrape_once(base, out)
                out.pop("error", None)
            except Exception as e:  # noqa: BLE001 — still down
                out["error"] = f"{type(e).__name__}: {e}"
        out["latency_s"] = time.perf_counter() - t0
        return out

    @staticmethod
    def _error_reason(error: Optional[str]) -> str:
        """Fold a scrape error string into the bounded ``reason`` label
        of ``bigdl_fleet_scrape_errors_total``."""
        e = (error or "").lower()
        if "timeout" in e:
            return "timeout"
        if "refused" in e or "connection" in e:
            return "refused"
        if "valueerror" in e or "jsondecode" in e or "exposition" in e:
            return "protocol"
        return "error"

    def _classify_stale(self, scraped: List[dict]) -> None:
        """Annotate each scrape result with ``stale``/``stale_reason``
        (skewed clock past ``stale_after_s``, or a failed scrape) and
        publish the pipeline's meta-observability: per-host scrape
        latency and staleness gauges, error-reason counters, the
        excluded-host count."""
        from bigdl_tpu_torch import obs

        reg = obs.get_registry()
        lat = reg.gauge(names.FLEET_SCRAPE_LATENCY_SECONDS,
                        names.spec(
                            names.FLEET_SCRAPE_LATENCY_SECONDS).doc,
                        labels=("host",))
        skew_g = reg.gauge(names.FLEET_HOST_STALENESS_SECONDS,
                           names.spec(
                               names.FLEET_HOST_STALENESS_SECONDS).doc,
                           labels=("host",))
        errs = reg.counter(names.FLEET_SCRAPE_ERRORS_TOTAL,
                           names.spec(
                               names.FLEET_SCRAPE_ERRORS_TOTAL).doc,
                           labels=("reason",))
        now = self._clock()
        stale: dict = {}
        for peer in scraped:
            addr = peer.get("addr", "?")
            if peer.get("latency_s") is not None:
                lat.labels(host=addr).set(peer["latency_s"])
            if not peer.get("ok"):
                reason = self._error_reason(peer.get("error"))
                errs.labels(reason=reason).inc()
                peer["stale"] = True
                peer["stale_reason"] = reason
                stale[addr] = peer.get("error") or reason
                continue
            peer["stale"] = False
            h = peer.get("health") or {}
            t_host = h.get("time")
            if t_host is None:
                continue
            skew = abs(now - float(t_host))
            skew_g.labels(host=addr).set(skew)
            if self.stale_after_s > 0 and skew > self.stale_after_s:
                peer["stale"] = True
                peer["stale_reason"] = f"clock skew {skew:.1f}s"
                stale[addr] = peer["stale_reason"]
        self.last_stale = stale
        reg.gauge(names.FLEET_STALE_HOSTS,
                  names.spec(names.FLEET_STALE_HOSTS).doc).set(
            len(stale))

    def scrape_peers(self, addrs) -> List[dict]:
        """One scrape cycle over ``addrs``, concurrently on a bounded
        thread pool (results in input order).

        Serially, a partitioned fleet costs N × timeout per cycle —
        40 unreachable peers at the 2s default is an 80s scrape, long
        past any policy interval.  Concurrently each peer's timeout
        runs on its own worker, so a cycle costs
        ``ceil(N / max_workers) × timeout`` worst-case.  The cycle
        wall clock is published as ``bigdl_fleet_scrape_seconds`` (and
        kept on ``last_scrape_s``) so a scrape that crowds its policy
        interval is visible before it starves the controller."""
        addrs = list(addrs)
        if not addrs:
            return []
        t0 = time.perf_counter()
        if len(addrs) == 1:
            out = [self.scrape_peer(addrs[0])]
        else:
            workers = min(self.max_workers, len(addrs))
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="bigdl-fleet-scrape") as pool:
                out = list(pool.map(self.scrape_peer, addrs))
        self.last_scrape_s = time.perf_counter() - t0
        from bigdl_tpu_torch import obs

        obs.get_registry().gauge(
            names.FLEET_SCRAPE_SECONDS,
            "Wall seconds of the last full fleet peer-scrape cycle"
        ).set(self.last_scrape_s)
        self._classify_stale(out)
        return out

    # --------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        fleet = {"mode": "peers" if self.peers else "shards",
                 "hosts": {}, "alerts": [], "metrics": {}, "errors": {},
                 "stale": {}}
        if self.peers:
            for scraped in self.scrape_peers(self.peers):
                addr = scraped["addr"]
                if not scraped["ok"]:
                    fleet["errors"][addr] = scraped.get("error", "down")
                    fleet["stale"][addr] = scraped.get(
                        "stale_reason", "down")
                    continue
                h = scraped["health"] or {}
                host = h.get("host", addr)
                entry = {
                    "status": h.get("status"), "step": h.get("step"),
                    "step_age_s": h.get("step_age_s"),
                    "goodput_ratio": h.get("goodput_ratio"),
                    "queue_depth": None,
                    "alerts": h.get("alerts") or [],
                    "heartbeat": h.get("heartbeat"), "source": addr}
                fleet["hosts"][str(host)] = entry
                if scraped.get("stale"):
                    # skewed clock: the host row stays visible (flagged)
                    # but its samples never reach the fleet merge — a
                    # stale host pollutes no percentile
                    entry["status"] = "stale"
                    entry["stale"] = True
                    fleet["stale"][addr] = scraped.get(
                        "stale_reason", "stale")
                    continue
                for a in h.get("alerts") or []:
                    fleet["alerts"].append(dict(a, host=host))
                for s in scraped["metrics"]["samples"]:
                    fleet["metrics"].setdefault(s["name"], []).append(
                        {"labels": s["labels"], "value": s["value"],
                         "source": addr})
                    # the streaming/serving backlog, on the host row —
                    # the signal the autoscaling policy loop scales on
                    if s["name"] in (names.STREAM_BUFFER_DEPTH,
                                     names.SERVE_QUEUE_DEPTH):
                        entry["queue_depth"] = max(
                            entry["queue_depth"] or 0.0, s["value"])
        elif self._tailer is not None:
            for fn, snap in sorted(self._tailer.poll().items()):
                host = snap.get("host", fn)
                entry = fleet["hosts"].setdefault(str(host), {
                    "status": "shard", "step": None, "step_age_s": None,
                    "goodput_ratio": None, "queue_depth": None,
                    "alerts": [], "source": fn})
                for name, fam in (snap.get("metrics") or {}).items():
                    for s in fam.get("samples", []):
                        value = s.get("value", s.get("count"))
                        fleet["metrics"].setdefault(name, []).append(
                            {"labels": s.get("labels") or {},
                             "value": value, "source": fn})
                        if name == names.GOODPUT_RATIO:
                            entry["goodput_ratio"] = value
                        elif name in (names.STREAM_BUFFER_DEPTH,
                                      names.SERVE_QUEUE_DEPTH):
                            entry["queue_depth"] = max(
                                entry["queue_depth"] or 0.0, value)
                        elif name == names.ALERT_ACTIVE and value:
                            rule = (s.get("labels") or {}).get("rule")
                            entry["alerts"].append({"rule": rule})
                            fleet["alerts"].append(
                                {"rule": rule, "host": host})
        fleet["n_hosts"] = len(fleet["hosts"])
        fleet["scrape_s"] = self.last_scrape_s
        return fleet


def fleet_snapshot() -> dict:
    """One live fleet snapshot from the ambient config (peers when
    ``BIGDL_TORCH_OBS_PEERS`` is set, shard tailing otherwise)."""
    return FleetAggregator.from_config().snapshot()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.obs.aggregate",
        description="Merge per-host trace shards into one Perfetto "
                    "timeline with barrier clock alignment.")
    ap.add_argument("trace_dir", help="directory holding *.events.jsonl "
                                      "shards (BIGDL_TORCH_TRACE_DIR)")
    ap.add_argument("-o", "--out", default=None,
                    help="merged Chrome trace path "
                         "(default: TRACE_DIR/merged.trace.json)")
    ap.add_argument("--barrier", default=BARRIER_EVENT,
                    help=f"alignment event name (default {BARRIER_EVENT})")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.trace_dir, "merged.trace.json")
    try:
        summary = merge_trace_dir(args.trace_dir, out, barrier=args.barrier)
    except ValueError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["BARRIER_EVENT", "STEP_SPAN", "Shard", "read_shards",
           "align_shards", "detect_stragglers", "merge_shards",
           "merge_trace_dir", "ShardTailer", "FleetAggregator",
           "fleet_snapshot", "main"]
