"""Run report — one readable answer from a run's trace/metrics dirs.

Counterpart of ``bigdl_tpu/obs/report.py``, with its sections, its
``--json`` dict and its CLI; it reads either package's shards.  Where
the JAX report reads jit compile counts, HLO FLOPs or MFU, the port
has no such metric and the section reads as the JAX report renders it
absent; its compile events are the ``nvcc.compile`` spans of the
kernel build.

``python -m bigdl_tpu_torch.obs.report TRACE_DIR [--metrics-dir DIR]`` reads
the per-host ``*.events.jsonl`` shards (and the ``metrics.*.jsonl``
snapshots when present) and renders what a postmortem asks first:

* per-host step-time percentiles (from the ``computing`` spans — the
  dispatch→resolved-loss wall time the reservoirs also see);
* compile events (count + wall seconds blocked: ``*.compile`` spans);
* collective wire bytes by op/dtype, per-step footprint and the
  int8-vs-f32 savings ratio;
* resilience events (retries, non-finite skips, checkpoint failures);
* slow-step anomalies and the slowest spans per host;
* training health (obs/health.py): per-layer grad norm / param norm /
  update ratio gauges, non-finite layer attributions, numerics
  anomalies;
* goodput (obs/goodput.py): the cross-attempt, cross-host wall-clock
  ledger — goodput ratio, badput seconds by cause (compile,
  checkpoints, data waits, startup, supervisor backoff, restart
  rework), the window bottleneck classification, and cross-host
  straggler flags;
* kernel auto-tuner (ops/autotune.py): dispatch decisions by site and
  chosen impl, cache hit/miss/measurement traffic, and the recent
  ``tuner.decision`` events with their provenance (cache / model /
  measured / corrupt_cache).

* alerts (obs/alerts.py): fired/resolved transition counts per rule,
  currently-firing rules, and the recent ``alert.firing`` /
  ``alert.resolved`` events.

``--json`` emits the machine-readable report instead of text — the
same dict ``build_report`` returns, so CI and ``obs/regress.py``
consume reports without scraping the rendered text.

``--watch`` turns the report into a refreshing terminal view topped by
a live fleet header: with ``BIGDL_TORCH_OBS_PEERS`` (or ``--peers``) set it
scrapes each host's live ``/healthz`` + ``/metrics`` endpoint
(obs/server.py); otherwise it incrementally tails the metrics shards.
``--once`` renders a single frame (CI), ``--interval`` sets the
refresh period.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional

from bigdl_tpu_torch.obs.aggregate import read_shards
from bigdl_tpu_torch.obs import names

_PCTS = (0.5, 0.95, 0.99)


def _nearest_rank(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    k = min(len(vs) - 1, max(0, math.ceil(q * len(vs)) - 1))
    return vs[k]


def load_metric_snapshots(metrics_dir: str) -> List[dict]:
    """Latest JSONL snapshot per metrics shard (one per host/pid)."""
    snaps = []
    if not metrics_dir or not os.path.isdir(metrics_dir):
        return snaps
    for fn in sorted(os.listdir(metrics_dir)):
        if not (fn.startswith("metrics.") and fn.endswith(".jsonl")):
            continue
        last = None
        with open(os.path.join(metrics_dir, fn), encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    try:
                        last = json.loads(line)
                    except json.JSONDecodeError:
                        continue
        if last:
            last.setdefault("shard", fn)
            snaps.append(last)
    return snaps


def _metric_samples(snaps: List[dict], name: str) -> list:
    """[(labels, value_or_histdict, host), ...] across all snapshots."""
    out = []
    for snap in snaps:
        fam = (snap.get("metrics") or {}).get(name)
        if not fam:
            continue
        for s in fam.get("samples", []):
            out.append((s.get("labels") or {}, s, snap.get("host", 0)))
    return out


def build_report(trace_dir: str, metrics_dir: Optional[str] = None,
                 bundle_dir: Optional[str] = None) -> dict:
    shards = read_shards(trace_dir)
    snaps = load_metric_snapshots(metrics_dir or trace_dir)

    hosts: dict = {}
    resilience: dict = {}
    slow_steps: list = []
    ckpt_async_writes = 0
    ckpt_snapshots = 0
    compile_events: list = []
    nonfinite_events: list = []
    anomaly_events: list = []
    tuner_events: list = []
    alert_events: list = []
    autoscale_events: list = []
    fleet_events: list = []
    reqtrace_spans: dict = {}
    for sh in shards:
        key = f"host{sh.host}/pid{sh.pid}"
        h = hosts.setdefault(key, {
            "host": sh.host, "pid": sh.pid, "records": 0,
            "step_times": [], "spans": []})
        h["records"] += len(sh.records)
        for rec in sh.records:
            name = rec.get("name", "")
            if rec.get("kind") == "span":
                dur = float(rec.get("dur_s", 0.0))
                attrs = rec.get("attrs") or {}
                h["spans"].append((name, dur, attrs.get("step")))
                # request-trace hop spans (obs/reqtrace.py) carry a
                # `trace` attr — group them per trace id so the
                # cross-host flow of one request reassembles here
                tid = attrs.get("trace")
                if tid and name.startswith("req."):
                    e = reqtrace_spans.setdefault(
                        tid, {"request": None, "spans": [],
                              "hosts": set()})
                    if e["request"] is None:
                        e["request"] = attrs.get("request")
                    e["spans"].append((name, dur))
                    e["hosts"].add(sh.host)
                if name == "computing":
                    h["step_times"].append(dur)
                if name == "checkpoint.write_async":
                    ckpt_async_writes += 1
                elif name == "checkpoint.snapshot":
                    ckpt_snapshots += 1
                if name.endswith(".compile"):
                    compile_events.append(
                        {"host": sh.host, "name": name,
                         "seconds": round(dur, 4)})
            else:
                if name.startswith("resilience."):
                    resilience[name] = resilience.get(name, 0) + 1
                elif name == "slow_step":
                    a = dict(rec.get("attrs") or {})
                    a["host"] = sh.host
                    slow_steps.append(a)
                elif name == "health.nonfinite_layers":
                    a = dict(rec.get("attrs") or {})
                    a["host"] = sh.host
                    nonfinite_events.append(a)
                elif name == "health.anomaly":
                    a = dict(rec.get("attrs") or {})
                    a["host"] = sh.host
                    anomaly_events.append(a)
                elif name == "tuner.decision":
                    a = dict(rec.get("attrs") or {})
                    a["host"] = sh.host
                    tuner_events.append(a)
                elif name in ("alert.firing", "alert.resolved"):
                    a = dict(rec.get("attrs") or {})
                    a["host"] = sh.host
                    a["state"] = name.split(".", 1)[1]
                    a["wall_time"] = rec.get("wall_time")
                    alert_events.append(a)
                elif name in ("elastic.autoscale", "supervisor.backoff",
                              "elastic.stream_restore"):
                    a = dict(rec.get("attrs") or {})
                    a["host"] = sh.host
                    a["event"] = name
                    a["wall_time"] = rec.get("wall_time")
                    autoscale_events.append(a)
                elif name == "fleet.scenario":
                    a = dict(rec.get("attrs") or {})
                    a["wall_time"] = rec.get("wall_time")
                    fleet_events.append(a)

    per_host = {}
    for key, h in hosts.items():
        st = h["step_times"]
        slowest = sorted(h["spans"], key=lambda t: -t[1])[:5]
        per_host[key] = {
            "records": h["records"],
            "steps": len(st),
            "step_time_s": {
                "p50": _nearest_rank(st, 0.5),
                "p95": _nearest_rank(st, 0.95),
                "p99": _nearest_rank(st, 0.99),
                "max": max(st) if st else None,
            },
            "slowest_spans": [
                {"name": n, "dur_s": round(d, 6), "step": s}
                for n, d, s in slowest],
        }

    # ---- collective bytes from the metric snapshots ------------------
    coll_total: dict = {}
    for labels, s, _host in _metric_samples(
            snaps, names.COLLECTIVE_BYTES_TOTAL):
        key = f"{labels.get('op', '?')}:{labels.get('dtype', '?')}"
        coll_total[key] = coll_total.get(key, 0.0) + float(
            s.get("value", 0.0))
    coll_step: dict = {}
    for labels, s, _host in _metric_samples(
            snaps, names.COLLECTIVE_BYTES_PER_STEP):
        key = f"{labels.get('op', '?')}:{labels.get('dtype', '?')}"
        coll_step[key] = float(s.get("value", 0.0))
    savings = [float(s.get("value", 0.0)) for _l, s, _h in _metric_samples(
        snaps, names.COLLECTIVE_WIRE_SAVINGS_RATIO)]
    savings_by_path: dict = {}
    for labels, s, _host in _metric_samples(
            snaps, names.COLLECTIVE_WIRE_SAVINGS_RATIO):
        savings_by_path[labels.get("path", "grad")] = float(
            s.get("value", 0.0))

    compile_count = sum(
        float(s.get("value", 0.0)) for _l, s, _h in _metric_samples(
            snaps, names.JIT_COMPILE_COUNT))

    # ---- training health (obs/health.py) -----------------------------
    def _by_layer(metric):
        out = {}
        for labels, s, _host in _metric_samples(snaps, metric):
            out[labels.get("layer", "?")] = float(s.get("value", 0.0))
        return out

    def _summed(metric, key):
        out = {}
        for labels, s, _host in _metric_samples(snaps, metric):
            k = labels.get(key, "?")
            out[k] = out.get(k, 0.0) + float(s.get("value", 0.0))
        return out

    step_flops = [float(s.get("value", 0.0))
                  for _l, s, _h in _metric_samples(snaps,
                                                   names.STEP_FLOPS)]
    mfu = [float(s.get("value", 0.0))
           for _l, s, _h in _metric_samples(snaps, names.MFU)]

    # ---- goodput ledger (obs/goodput.py) -----------------------------
    from bigdl_tpu_torch.obs import goodput as G
    from bigdl_tpu_torch.obs.aggregate import detect_stragglers

    gp = G.aggregate_goodput(metrics_dir or trace_dir)
    if gp is not None:
        # bottleneck: prefer the run's own windowed gauge (it saw live
        # comm/host fractions); fall back to re-deriving the input
        # share from the ledger when no window ever ticked
        label, source = None, None
        for labels, s, _host in _metric_samples(snaps, names.BOTTLENECK):
            if float(s.get("value", 0.0)) >= 1.0:
                label, source = labels.get("class"), "gauge"
        derived = G.classify_bottleneck(
            gp["productive_s"] + gp["badput_s"].get("rework", 0.0),
            gp["badput_s"].get("data_wait", 0.0))
        if label is None:
            label, source = derived["label"], "ledger"
        gp["bottleneck"] = {"label": label, "source": source,
                            "input_fraction": derived["input_fraction"]}
    stragglers = detect_stragglers(shards)

    # ---- kernel auto-tuner (ops/autotune.py) -------------------------
    tuner_decisions: dict = {}
    for labels, s, _host in _metric_samples(
            snaps, names.TUNER_DECISIONS_TOTAL):
        key = f"{labels.get('site', '?')}:{labels.get('impl', '?')}"
        tuner_decisions[key] = tuner_decisions.get(key, 0.0) + float(
            s.get("value", 0.0))

    def _tuner_count(metric):
        return sum(float(s.get("value", 0.0))
                   for _l, s, _h in _metric_samples(snaps, metric))

    tuner = {
        "decisions_total": tuner_decisions,
        "cache_hits": _tuner_count(names.TUNER_CACHE_HITS_TOTAL),
        "cache_misses": _tuner_count(names.TUNER_CACHE_MISSES_TOTAL),
        "measurements": _tuner_count(names.TUNER_MEASUREMENTS_TOTAL),
        "events": tuner_events,
    }

    # ---- alerts (obs/alerts.py) --------------------------------------
    fired: dict = {}
    for labels, s, _host in _metric_samples(snaps, names.ALERTS_TOTAL):
        key = f"{labels.get('rule', '?')}[{labels.get('severity', '?')}]"
        fired[key] = fired.get(key, 0.0) + float(s.get("value", 0.0))
    resolved: dict = {}
    for labels, s, _host in _metric_samples(
            snaps, names.ALERTS_RESOLVED_TOTAL):
        rule = labels.get("rule", "?")
        resolved[rule] = resolved.get(rule, 0.0) + float(
            s.get("value", 0.0))
    active: dict = {}
    for labels, s, _host in _metric_samples(snaps, names.ALERT_ACTIVE):
        rule = labels.get("rule", "?")
        active[rule] = max(active.get(rule, 0.0),
                           float(s.get("value", 0.0)))
    alert_events.sort(key=lambda a: a.get("wall_time") or 0.0)
    alerts = {
        "fired_total": fired,
        "resolved_total": resolved,
        "active": sorted(r for r, v in active.items() if v >= 1.0),
        "events": alert_events,
    }

    # ---- autoscaling & streaming (resilience/autoscale.py,
    # dataset/stream.py) ------------------------------------------------
    decisions: dict = {}
    for labels, s, _host in _metric_samples(
            snaps, names.AUTOSCALE_DECISIONS_TOTAL):
        key = f"{labels.get('direction', '?')}:{labels.get('reason', '?')}"
        decisions[key] = decisions.get(key, 0.0) + float(
            s.get("value", 0.0))
    resumes: dict = {}
    for labels, s, _host in _metric_samples(snaps, names.RESUMES_TOTAL):
        key = labels.get("resize", "?")
        resumes[key] = resumes.get(key, 0.0) + float(s.get("value", 0.0))

    def _metric_max(name):
        vals = [float(s.get("value", 0.0))
                for _l, s, _h in _metric_samples(snaps, name)]
        return max(vals) if vals else None

    def _metric_sum(name):
        return sum(float(s.get("value", 0.0))
                   for _l, s, _h in _metric_samples(snaps, name))

    autoscale_events.sort(key=lambda a: a.get("wall_time") or 0.0)
    stream_records = _metric_sum(names.STREAM_RECORDS_TOTAL)
    autoscale = {
        "decisions_total": decisions,
        "resumes_total": resumes,
        "events": autoscale_events,
        "stream": None if not stream_records else {
            "records_total": stream_records,
            "offset": _metric_max(names.STREAM_OFFSET),
            "watermark": _metric_max(names.STREAM_WATERMARK),
            "buffer_depth": _metric_max(names.STREAM_BUFFER_DEPTH),
            "lag_records": _metric_max(names.STREAM_LAG_RECORDS),
            "backpressure_waits": _metric_sum(
                names.STREAM_BACKPRESSURE_WAITS_TOTAL),
        },
    }

    # ---- fleet simulation (sim/, python -m bigdl_tpu_torch.sim) ------
    # scenario verdicts ride fleet.scenario trace events; the scrape
    # latency gauge (names.FLEET_SCRAPE_SECONDS) comes from the
    # bounded-pool concurrent peer scrape
    fleet_scrape = None
    for _labels, s, _host in _metric_samples(
            snaps, names.FLEET_SCRAPE_SECONDS):
        v = float(s.get("value", 0.0))
        fleet_scrape = v if fleet_scrape is None else max(fleet_scrape,
                                                          v)
    fleet = None
    if fleet_events or fleet_scrape is not None:
        fleet_events.sort(key=lambda a: a.get("wall_time") or 0.0)
        fleet = {
            "scenarios": fleet_events,
            "scrape_seconds": fleet_scrape,
            "decisions_total": decisions,
            "alert_episodes": {"fired": fired, "resolved": resolved},
        }

    # ---- serving tier (serving/ package) -----------------------------
    def _hist_stats(metric, key_labels=("engine", "kind")):
        """Per-label-combo count/mean/p50/p95/p99 from the snapshot's
        cumulative histogram buckets (summed across hosts — cumulative
        counts add)."""
        acc: dict = {}
        for labels, s, _host in _metric_samples(snaps, metric):
            key = ":".join(labels.get(k, "?") for k in key_labels)
            cur = acc.setdefault(key, {"count": 0, "sum": 0.0,
                                       "buckets": {}})
            cur["count"] += int(s.get("count", 0))
            cur["sum"] += float(s.get("sum", 0.0))
            for le, c in s.get("buckets", []):
                le_f = float("inf") if le in ("+Inf", "inf") \
                    else float(le)
                cur["buckets"][le_f] = cur["buckets"].get(le_f, 0.0) \
                    + float(c)
        out = {}
        for key, cur in acc.items():
            total = cur["count"]
            finite = sorted(b for b in cur["buckets"]
                            if b != float("inf"))

            def q(p, _cur=cur, _total=total, _finite=finite):
                if _total <= 0:
                    return None
                for le in _finite:
                    if _cur["buckets"][le] >= p * _total:
                        return le
                return _finite[-1] if _finite else None

            out[key] = {"count": total,
                        "mean_s": (cur["sum"] / total) if total else None,
                        "p50_s": q(0.5), "p95_s": q(0.95),
                        "p99_s": q(0.99)}
        return out

    serve_requests: dict = {}
    for labels, s, _host in _metric_samples(
            snaps, names.SERVE_REQUESTS_TOTAL):
        key = f"{labels.get('engine', '?')}:{labels.get('status', '?')}"
        serve_requests[key] = serve_requests.get(key, 0.0) + float(
            s.get("value", 0.0))
    slo_vals = [float(s.get("value", 0.0)) for _l, s, _h in
                _metric_samples(snaps, names.SERVE_LATENCY_SLO_RATIO)]
    serving = None
    if serve_requests or slo_vals:
        serving = {
            "requests_total": serve_requests,
            "tokens_total": _metric_sum(names.SERVE_TOKENS_TOTAL),
            "tokens_per_second": _metric_max(
                names.SERVE_TOKENS_PER_SECOND),
            "batch_occupancy": _metric_max(
                names.SERVE_BATCH_OCCUPANCY),
            "queue_depth": _metric_max(names.SERVE_QUEUE_DEPTH),
            "kv_pages_in_use": _metric_max(
                names.SERVE_KV_PAGES_IN_USE),
            "admission_waits": _metric_sum(
                names.SERVE_ADMISSION_WAITS_TOTAL),
            "preemptions": _metric_sum(
                names.SERVE_PREEMPTIONS_TOTAL),
            "slo_ratio": min(slo_vals) if slo_vals else None,
            "latency": _hist_stats(names.REQUEST_LATENCY_SECONDS),
            "decode_attn_ms": _metric_max(
                names.SERVE_DECODE_ATTN_MS),
            "decode_hbm_bytes_per_token": _metric_max(
                names.SERVE_DECODE_HBM_BYTES_PER_TOKEN),
        }

    # ---- request traces (obs/reqtrace.py) ----------------------------
    # per-hop p99 attribution: group each kept trace's req.* spans by
    # hop key, then average the hop times over the slowest e2e decile —
    # that is the "where did the p99 go" answer
    reqtrace = None
    if reqtrace_spans:
        from bigdl_tpu_torch.serving.spans import HOP_ORDER, hop_key

        traces = []
        for tid, e in reqtrace_spans.items():
            hops: dict = {}
            route = 0.0
            for name, dur in e["spans"]:
                k = hop_key(name)
                if k == "route":
                    # the router's whole-request envelope IS the
                    # measured e2e; the other hops partition it
                    route = max(route, dur)
                else:
                    hops[k] = hops.get(k, 0.0) + dur
            hop_sum = sum(hops.values())
            e2e = route if route > 0 else hop_sum
            traces.append({
                "trace": tid, "request": e["request"],
                "hosts": len(e["hosts"]), "e2e_s": e2e, "hops": hops,
                "coverage": (hop_sum / e2e) if e2e > 0 else None})
        traces.sort(key=lambda t: -t["e2e_s"])
        n_slow = max(1, len(traces) // 10)
        slow = traces[:n_slow]
        hop_means = {}
        for k in HOP_ORDER:
            if k == "route":
                continue
            vals = [t["hops"].get(k, 0.0) for t in slow]
            if any(vals):
                hop_means[k] = sum(vals) / len(vals)
        cov = [t["coverage"] for t in slow
               if t["coverage"] is not None]
        reqtrace = {
            "traces": len(traces),
            "cross_host": sum(1 for t in traces if t["hosts"] > 1),
            "slow_decile": {
                "count": n_slow,
                "e2e_mean_s": sum(t["e2e_s"] for t in slow) / n_slow,
                "hop_mean_s": {k: round(v, 6)
                               for k, v in hop_means.items()},
                "coverage": (sum(cov) / len(cov)) if cov else None,
            },
            "slowest": [
                {"trace": t["trace"], "request": t["request"],
                 "e2e_s": round(t["e2e_s"], 6),
                 "hops": {k: round(v, 6) for k, v in sorted(
                     t["hops"].items(), key=lambda kv: -kv[1])}}
                for t in traces[:5]],
        }

    # ---- overlapped step (bucketed exchange, async
    # checkpointing, double-buffered input) ----------------------------
    buckets = _metric_max(names.OVERLAP_BUCKETS)
    overlap = {
        "buckets": buckets,
        "exposed_comm_fraction": _metric_max(
            names.OVERLAP_EXPOSED_COMM_FRACTION),
        "exposed_comm_seconds_per_step": _metric_max(
            names.OVERLAP_EXPOSED_COMM_SECONDS),
        "checkpoint_snapshot_seconds": _metric_max(
            names.CHECKPOINT_SNAPSHOT_SECONDS),
        "checkpoint_write_seconds": _metric_max(
            names.CHECKPOINT_WRITE_SECONDS),
        "async_checkpoint_writes": ckpt_async_writes,
        "checkpoint_snapshots": ckpt_snapshots,
    }

    # per-device HBM peaks (bigdl_hbm_peak_bytes, max across snapshots)
    hbm: dict = {}
    for labels, s, _host in _metric_samples(snaps, names.HBM_PEAK_BYTES):
        d = labels.get("device", "?")
        hbm[d] = max(hbm.get(d, 0.0), float(s.get("value", 0.0)))
    health = {
        "grad_norm": _by_layer(names.GRAD_NORM),
        "param_norm": _by_layer(names.PARAM_NORM),
        "update_ratio": _by_layer(names.UPDATE_RATIO),
        "nonfinite_layers_total": _summed(
            names.NONFINITE_LAYERS_TOTAL, "layer"),
        "anomalies_total": _summed(
            names.NUMERICS_ANOMALIES_TOTAL, "kind"),
        "nonfinite_events": nonfinite_events,
        "anomaly_events": anomaly_events,
        "step_flops": max(step_flops) if step_flops else None,
        "mfu": max(mfu) if mfu else None,
    }

    # ---- continuous profiles + debug bundles (obs/prof.py,
    # obs/bundle.py) ----------------------------------------------------
    # profile shards are the obs.flush() dumps (prof.*.profile.json);
    # bundles come from the manifest-verified inventory, so a torn
    # bundle shows up flagged instead of silently counted as good
    prof_shards: list = []
    prof_dirs = []
    for d in (metrics_dir or trace_dir, trace_dir):
        if d and d not in prof_dirs:
            prof_dirs.append(d)
    for d in prof_dirs:
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".profile.json"):
                continue
            try:
                with open(os.path.join(d, fn), encoding="utf-8") as fh:
                    prof_shards.append(json.load(fh))
            except (OSError, ValueError):
                continue
    from bigdl_tpu_torch.obs import bundle as _bundle
    bdir = bundle_dir
    if bdir is None:
        from bigdl_tpu_torch.config import refresh_from_env
        bdir = refresh_from_env().obs.bundle_dir
    if bdir is None:
        cand = os.path.join(metrics_dir or trace_dir, "bundles")
        bdir = cand if os.path.isdir(cand) else None
    bundles = _bundle.inventory(bdir) if bdir else []
    profiles = None
    if prof_shards or bundles:
        prof_phases: dict = {}
        for sh in prof_shards:
            for phase, p in (sh.get("phases") or {}).items():
                cur = prof_phases.setdefault(
                    phase, {"samples": 0, "frames": {}})
                cur["samples"] += int(p.get("samples", 0))
                for label, n in p.get("frames") or []:
                    cur["frames"][label] = \
                        cur["frames"].get(label, 0) + int(n)
        for p in prof_phases.values():
            p["frames"] = sorted(p["frames"].items(),
                                 key=lambda kv: -kv[1])[:8]
        oh_vals = [float(sh.get("overhead_ratio") or 0.0)
                   for sh in prof_shards]
        live_oh = _metric_max(names.PROF_OVERHEAD_RATIO)
        if live_oh is not None:
            oh_vals.append(float(live_oh))
        profiles = {
            "samples": sum(int(sh.get("samples") or 0)
                           for sh in prof_shards),
            "skipped": sum(int(sh.get("skipped") or 0)
                           for sh in prof_shards),
            "overhead_ratio": max(oh_vals) if oh_vals else None,
            "phases": prof_phases,
            "bundle_dir": bdir,
            "bundles": bundles,
            "bundles_valid": sum(1 for b in bundles if b.get("ok")),
        }

    return {
        "trace_dir": trace_dir,
        "metrics_dir": metrics_dir or trace_dir,
        "hosts": per_host,
        "n_hosts": len({h["host"] for h in hosts.values()}),
        "compile": {
            "events_in_trace": compile_events,
            "count_from_metrics": compile_count or None,
        },
        "collective_bytes_total": coll_total,
        "collective_bytes_per_step": coll_step,
        "wire_savings_ratio": max(savings) if savings else None,
        "wire_savings_by_path": savings_by_path,
        "resilience_events": resilience,
        "slow_steps": slow_steps,
        "alerts": alerts,
        "serving": serving,
        "reqtrace": reqtrace,
        "autoscale": autoscale,
        "fleet": fleet,
        "overlap": overlap,
        "health": health,
        "goodput": gp,
        "stragglers": stragglers,
        "hbm_peak_bytes": hbm,
        "tuner": tuner,
        "profiles": profiles,
    }


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024 or unit == "TiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{b:.0f}B"
        b /= 1024.0
    return f"{b:.1f}TiB"


def render_text(rep: dict) -> str:
    lines = ["== bigdl_tpu_torch run report ==",
             f"trace dir:   {rep['trace_dir']}",
             f"metrics dir: {rep['metrics_dir']}",
             f"hosts:       {rep['n_hosts']}", ""]
    lines.append("-- step times (computing spans, per host) --")
    for key, h in sorted(rep["hosts"].items()):
        st = h["step_time_s"]

        def f(v):
            return "-" if v is None else f"{v * 1000:.2f}ms"

        lines.append(
            f"  {key}: n={h['steps']} p50={f(st['p50'])} "
            f"p95={f(st['p95'])} p99={f(st['p99'])} max={f(st['max'])}")
    lines.append("")
    lines.append("-- compiles --")
    cc = rep["compile"]["count_from_metrics"]
    lines.append(f"  count (metrics): "
                 f"{int(cc) if cc is not None else 'n/a'}")
    for ev in rep["compile"]["events_in_trace"][:8]:
        lines.append(f"  host{ev['host']} {ev['name']}: {ev['seconds']}s")
    hbm = rep.get("hbm_peak_bytes") or {}
    if hbm:
        lines.append("  hbm peak: " + ", ".join(
            f"d{d} {_fmt_bytes(b)}" for d, b in sorted(hbm.items())))
    lines.append("")
    lines.append("-- collective wire bytes (total across hosts) --")
    if not rep["collective_bytes_total"]:
        lines.append("  (none recorded)")
    for key, b in sorted(rep["collective_bytes_total"].items()):
        per = rep["collective_bytes_per_step"].get(key)
        extra = f"  ({_fmt_bytes(per)}/step)" if per else ""
        lines.append(f"  {key:28s} {_fmt_bytes(b):>12s}{extra}")
    if rep.get("wire_savings_by_path"):
        by = ", ".join(f"{p} {r:.2f}x" for p, r in
                       sorted(rep["wire_savings_by_path"].items()))
        lines.append(f"  wire savings vs uncompressed exchange: {by}")
    elif rep["wire_savings_ratio"]:
        lines.append(f"  wire savings vs f32 exchange: "
                     f"{rep['wire_savings_ratio']:.2f}x")
    lines.append("")
    lines.append("-- resilience events --")
    if not rep["resilience_events"]:
        lines.append("  (clean run)")
    for name, n in sorted(rep["resilience_events"].items()):
        lines.append(f"  {name}: {n}")
    lines.append("")
    lines.append("-- slow steps --")
    if not rep["slow_steps"]:
        lines.append("  (none)")
    for s in rep["slow_steps"][:8]:
        lines.append(
            f"  host{s.get('host')} step {s.get('step')}: "
            f"{float(s.get('dur_s', 0)) * 1000:.1f}ms "
            f"(median {float(s.get('median_s', 0)) * 1000:.1f}ms, "
            f"breakdown {s.get('breakdown')})")
    lines.append("")
    lines.append("-- alerts --")
    al = rep.get("alerts") or {}
    if not (al.get("fired_total") or al.get("events")):
        lines.append("  (none fired)")
    else:
        for rule in al.get("active", []):
            lines.append(f"  FIRING {rule}")
        for key, n in sorted(al.get("fired_total", {}).items()):
            rule = key.split("[", 1)[0]
            res = al.get("resolved_total", {}).get(rule, 0)
            lines.append(f"  {key:40s} fired {int(n)}x, "
                         f"resolved {int(res)}x")
        for ev in al.get("events", [])[-8:]:
            lines.append(
                f"  host{ev.get('host')} {ev.get('state'):>8s} "
                f"{ev.get('rule')} [{ev.get('severity')}] "
                f"{ev.get('metric')}={ev.get('value')}")
    lines.append("")
    lines.append("-- serving --")
    sv = rep.get("serving")
    if not sv:
        lines.append("  (no serving activity — see bigdl_tpu_torch/serving)")
    else:
        req = ", ".join(f"{k} {int(n)}" for k, n in
                        sorted(sv.get("requests_total", {}).items()))
        lines.append(f"  requests: {req or '(none)'}")
        tps = sv.get("tokens_per_second")
        lines.append(
            f"  tokens: {int(sv.get('tokens_total') or 0)} generated"
            + (f", {tps:.1f} tok/s" if tps else ""))
        occ = sv.get("batch_occupancy")
        lines.append(
            "  batcher: occupancy "
            + (f"{occ * 100:.0f}%" if occ is not None else "n/a")
            + f", queue depth {sv.get('queue_depth')}"
            + f", {int(sv.get('admission_waits') or 0)} admission "
              "wait(s)"
            + f", {int(sv.get('preemptions') or 0)} preemption(s)")
        for key, st in sorted((sv.get("latency") or {}).items()):
            def ms(v):
                return "-" if v is None else f"{v * 1000:.1f}ms"

            lines.append(
                f"  latency {key:16s} n={st['count']} "
                f"p50<={ms(st['p50_s'])} p95<={ms(st['p95_s'])} "
                f"p99<={ms(st['p99_s'])}")
        if sv.get("slo_ratio") is not None:
            lines.append(f"  latency SLO ratio: {sv['slo_ratio']:.3f}")
        dms = sv.get("decode_attn_ms")
        if dms is not None:
            bpt = sv.get("decode_hbm_bytes_per_token")
            lines.append(
                f"  decode: {dms:.2f}ms/step"
                + (f", {bpt / 1e6:.2f} MB/token (HBM)"
                   if bpt is not None else ""))
    lines.append("")
    lines.append("-- request traces --")
    rt = rep.get("reqtrace")
    if not rt:
        lines.append("  (none kept — set BIGDL_TORCH_REQTRACE_SAMPLE>0, "
                     "anomalies are always kept)")
    else:
        lines.append(
            f"  kept traces: {rt['traces']}"
            + (f" ({rt['cross_host']} cross-host)"
               if rt.get("cross_host") else ""))
        sd = rt["slow_decile"]
        cov = sd.get("coverage")
        lines.append(
            f"  slowest decile (n={sd['count']}): "
            f"e2e mean {sd['e2e_mean_s'] * 1000:.1f}ms"
            + (f", hop coverage {cov * 100:.0f}%"
               if cov is not None else ""))
        total = sum(sd["hop_mean_s"].values()) or 1.0
        for hop, v in sorted(sd["hop_mean_s"].items(),
                             key=lambda kv: -kv[1]):
            lines.append(f"    {hop:10s} {v * 1000:9.2f}ms  "
                         f"{v / total * 100:5.1f}%")
        for t in rt.get("slowest", [])[:3]:
            worst = next(iter(t["hops"]), "-")
            lines.append(
                f"  trace {t['trace']} (request {t['request']}): "
                f"{t['e2e_s'] * 1000:.1f}ms, worst hop {worst}")
    lines.append("")
    lines.append("-- profiles --")
    pr = rep.get("profiles")
    if not pr:
        lines.append("  (no profiler activity — set BIGDL_TORCH_PROF_HZ>0; "
                     "bundles via BIGDL_TORCH_BUNDLE_DIR)")
    else:
        oh = pr.get("overhead_ratio")
        lines.append(
            f"  samples: {int(pr.get('samples') or 0)}"
            f" ({int(pr.get('skipped') or 0)} skipped by budget)"
            + (f", overhead {oh * 100:.2f}%" if oh is not None else ""))
        prof_phases = pr.get("phases") or {}
        total_samples = sum(
            int(p.get("samples") or 0)
            for p in prof_phases.values()) or 1
        for phase, p in sorted(prof_phases.items(),
                               key=lambda kv: -kv[1]["samples"])[:6]:
            n_ph = int(p.get("samples") or 0)
            lines.append(f"  {phase:24s} {n_ph:6d} samples  "
                         f"{n_ph / total_samples * 100:5.1f}%")
            for label, n in (p.get("frames") or [])[:3]:
                lines.append(
                    f"    {label:40s} {int(n):6d}  "
                    f"{int(n) / max(n_ph, 1) * 100:5.1f}%")
        bundles = pr.get("bundles") or []
        if bundles:
            lines.append(
                f"  bundles: {int(pr.get('bundles_valid') or 0)}/"
                f"{len(bundles)} valid in {pr.get('bundle_dir')}")
            for b in bundles[-4:]:
                if b.get("ok"):
                    lines.append(
                        f"    {b['name']}: ok "
                        f"({_fmt_bytes(float(b.get('bytes') or 0))}, "
                        f"{b.get('trigger')})")
                else:
                    lines.append(f"    {b['name']}: "
                                 f"SKIPPED ({b.get('reason')})")
    lines.append("")
    lines.append("-- autoscaling & stream --")
    asc = rep.get("autoscale") or {}
    if not (asc.get("decisions_total") or asc.get("resumes_total")
            or asc.get("stream") or asc.get("events")):
        lines.append("  (no autoscale/stream activity)")
    else:
        for key, n in sorted(asc.get("decisions_total", {}).items()):
            lines.append(f"  decision {key:28s} {int(n)}x")
        if asc.get("resumes_total"):
            lines.append("  resumes: " + ", ".join(
                f"{k} {int(n)}x"
                for k, n in sorted(asc["resumes_total"].items())))
        st = asc.get("stream")
        if st:
            wm = st.get("watermark")
            lines.append(
                f"  stream: {int(st['records_total'])} records trained, "
                f"offset {int(st['offset'] or 0)}"
                + (f", watermark {wm:g}" if wm is not None else ""))
            lines.append(
                f"  stream buffer: depth {st.get('buffer_depth')}, "
                f"lag {st.get('lag_records')}, "
                f"{int(st.get('backpressure_waits') or 0)} "
                "backpressure wait(s)")
        for ev in asc.get("events", [])[-8:]:
            if ev.get("event") == "elastic.autoscale":
                if ev.get("suppressed"):
                    lines.append(
                        f"  host{ev.get('host')} suppressed "
                        f"({ev.get('suppressed')}) rule {ev.get('rule')}")
                else:
                    lines.append(
                        f"  host{ev.get('host')} {ev.get('direction')} "
                        f"{ev.get('old_world')}->{ev.get('new_world')} "
                        f"[{ev.get('reason')}]"
                        + (" DRY-RUN" if ev.get("dry_run") else ""))
            elif ev.get("event") == "supervisor.backoff":
                lines.append(
                    f"  host{ev.get('host')} backoff {ev.get('kind')} "
                    f"{float(ev.get('delay_s') or 0):.2f}s (rc "
                    f"{ev.get('rc')})")
    lines.append("")
    lines.append("-- fleet simulation --")
    fl = rep.get("fleet")
    if not fl:
        lines.append("  (no fleet sim activity)")
    else:
        for ev in (fl.get("scenarios") or [])[-8:]:
            bad = sorted(k for k, v in (ev.get("invariants")
                                        or {}).items() if not v)
            lines.append(
                f"  {str(ev.get('scenario')):14s} "
                f"{'PASS' if ev.get('ok') else 'FAIL'} "
                f"hosts={ev.get('hosts')} ticks={ev.get('ticks')} "
                f"world->{ev.get('final_world')} "
                f"decisions={ev.get('decisions')} "
                f"episodes={ev.get('episodes')}"
                + (f"  FAILED: {','.join(bad)}" if bad else ""))
        for key, n in sorted((fl.get("decisions_total") or {}).items()):
            lines.append(f"  decision {key:28s} {int(n)}x")
        ep = fl.get("alert_episodes") or {}
        if ep.get("fired"):
            lines.append("  alert episodes: " + ", ".join(
                f"{key.split('[', 1)[0]} fired "
                f"{int(n)}x/resolved "
                f"{int(ep.get('resolved', {}).get(key.split('[', 1)[0], 0))}x"
                for key, n in sorted(ep["fired"].items())))
        if fl.get("scrape_seconds") is not None:
            lines.append(f"  scrape cycle: "
                         f"{fl['scrape_seconds'] * 1000:.1f}ms "
                         "(bounded-pool concurrent peer scrape)")
    lines.append("")
    lines.append("-- overlap --")
    ov = rep.get("overlap") or {}
    has_overlap = (ov.get("buckets") or 0) > 1 \
        or ov.get("async_checkpoint_writes") \
        or ov.get("checkpoint_snapshot_seconds") is not None
    if not has_overlap:
        lines.append("  (no overlap activity — set BIGDL_TORCH_OVERLAP_BUCKET_MB"
                     " / BIGDL_TORCH_CHECKPOINT_ASYNC / "
                     "BIGDL_TORCH_INPUT_DOUBLE_BUFFER)")
    else:
        b = ov.get("buckets")
        if b and b > 1:
            frac = ov.get("exposed_comm_fraction")
            secs = ov.get("exposed_comm_seconds_per_step")
            lines.append(
                f"  gradient exchange: {int(b)} buckets, exposed comm "
                + (f"{frac * 100:.0f}% of the wire"
                   if frac is not None else "n/a")
                + (f" (~{secs * 1000:.2f}ms/step)"
                   if secs is not None else ""))
        elif b:
            lines.append("  gradient exchange: monolithic (1 bucket — "
                         "everything exposed)")
        snap = ov.get("checkpoint_snapshot_seconds")
        wr = ov.get("checkpoint_write_seconds")
        if snap is not None or wr is not None:
            lines.append(
                "  checkpoint: snapshot "
                + (f"{snap * 1000:.1f}ms (blocking)"
                   if snap is not None else "n/a")
                + ", write "
                + (f"{wr * 1000:.1f}ms" if wr is not None else "n/a")
                + (f" — {int(ov['async_checkpoint_writes'])} async "
                   "write(s) off the critical path"
                   if ov.get("async_checkpoint_writes") else ""))
    lines.append("")
    lines.append("-- goodput --")
    gp = rep.get("goodput")
    if not gp:
        lines.append("  (no goodput ledger — set BIGDL_TORCH_METRICS_DIR)")
    else:
        hosts = ",".join(str(h) for h in gp["hosts"])
        lines.append(f"  attempts: {gp['attempts']} (hosts {hosts}), "
                     f"{gp['steps']} productive steps")
        ratio = gp["goodput_ratio"]
        lines.append(
            f"  wall {gp['total_s']:.2f}s | productive "
            f"{gp['productive_s']:.2f}s | goodput ratio "
            + (f"{ratio:.3f}" if ratio is not None else "n/a"))
        if gp["badput_s"]:
            lines.append("  badput: " + "; ".join(
                f"{cause} {secs:.2f}s"
                for cause, secs in sorted(gp["badput_s"].items())))
        if gp["unknown_s"]:
            lines.append(f"  unknown gaps: {gp['unknown_s']:.2f}s")
        if gp["rework_steps"]:
            lines.append(f"  rework: {gp['rework_steps']} replayed "
                         "step(s) after restart")
        bn = gp.get("bottleneck")
        if bn:
            lines.append(
                f"  bottleneck: {bn['label']} (input share "
                f"{bn['input_fraction'] * 100:.0f}%, via {bn['source']})")
    strag = rep.get("stragglers") or {}
    if strag.get("stragglers"):
        med = strag.get("median_p50") or 0.0
        for h in strag["stragglers"]:
            info = strag["hosts"].get(h) or strag["hosts"].get(str(h), {})
            p50 = info.get("p50") or 0.0
            lines.append(
                f"  STRAGGLER host{h}: p50 {p50 * 1000:.1f}ms vs "
                f"cross-host median {med * 1000:.1f}ms "
                f"(factor {strag['factor']:g}, "
                f"{info.get('straggler_steps', 0)} flagged steps)")
    elif len(rep["hosts"]) > 1:
        lines.append("  stragglers: none flagged")
    lines.append("")
    lines.append("-- training health --")
    h = rep.get("health") or {}
    if not (h.get("grad_norm") or h.get("nonfinite_layers_total")
            or h.get("anomalies_total")):
        lines.append("  (no health telemetry — set BIGDL_TORCH_HEALTH_EVERY)")
    else:
        layers = sorted(set(h.get("grad_norm", {}))
                        | set(h.get("update_ratio", {})))
        for layer in layers[:12]:
            g = h.get("grad_norm", {}).get(layer)
            p = h.get("param_norm", {}).get(layer)
            r = h.get("update_ratio", {}).get(layer)

            def f(v):
                return "-" if v is None else f"{v:.4g}"

            lines.append(f"  {layer:24s} grad={f(g):>10s} "
                         f"param={f(p):>10s} upd/w={f(r):>10s}")
        if len(layers) > 12:
            lines.append(f"  ... {len(layers) - 12} more layers "
                         "(use --json for all)")
        if h.get("step_flops"):
            mfu = f" mfu={h['mfu']:.4f}" if h.get("mfu") else ""
            lines.append(f"  HLO step FLOPs: {h['step_flops']:.4g}{mfu}")
        for layer, n in sorted(h.get("nonfinite_layers_total",
                                     {}).items()):
            lines.append(f"  NON-FINITE {layer}: {int(n)} step(s)")
        for ev in h.get("nonfinite_events", [])[:8]:
            lines.append(
                f"  host{ev.get('host')} step {ev.get('step')}: first "
                f"offender {ev.get('first')} (all: {ev.get('layers')})")
        for kind, n in sorted(h.get("anomalies_total", {}).items()):
            lines.append(f"  ANOMALY {kind}: {int(n)}")
        for ev in h.get("anomaly_events", [])[:8]:
            lines.append(
                f"  host{ev.get('host')} step {ev.get('step')}: "
                f"{ev.get('kind')} {float(ev.get('value', 0)):.4g} vs "
                f"median {float(ev.get('median', 0)):.4g}")
    lines.append("")
    lines.append("-- kernel auto-tuner --")
    tn = rep.get("tuner") or {}
    if not (tn.get("decisions_total") or tn.get("events")):
        lines.append("  (no tuner activity — set BIGDL_TORCH_TUNER=1)")
    else:
        for key, n in sorted(tn.get("decisions_total", {}).items()):
            lines.append(f"  {key:28s} {int(n)} decision(s)")
        lines.append(
            f"  cache: {int(tn.get('cache_hits', 0))} hit(s), "
            f"{int(tn.get('cache_misses', 0))} miss(es), "
            f"{int(tn.get('measurements', 0))} wall-clock probe(s)")
        for ev in tn.get("events", [])[:8]:
            lines.append(
                f"  host{ev.get('host')} {ev.get('site')}: "
                f"{ev.get('label')} via {ev.get('source')} "
                f"(static {ev.get('static')}) [{ev.get('key')}]")
    lines.append("")
    lines.append("-- slowest spans per host --")
    for key, h in sorted(rep["hosts"].items()):
        for sp in h["slowest_spans"]:
            step = "" if sp["step"] is None else f" step={sp['step']}"
            lines.append(f"  {key} {sp['name']}: "
                         f"{sp['dur_s'] * 1000:.2f}ms{step}")
    return "\n".join(lines) + "\n"


def _host_badness(h: dict) -> tuple:
    """Gating-signal rank for the --watch host table: the host an
    operator must look at first sorts highest (bad/stale status, firing
    alerts, deep queue, old step stamp, poor goodput)."""
    status = str(h.get("status") or "?")
    rank = {"ok": 0, "idle": 1}.get(status, 3)
    gr = h.get("goodput_ratio")
    return (rank, len(h.get("alerts") or []),
            float(h.get("queue_depth") or 0.0),
            float(h.get("step_age_s") or 0.0),
            1.0 - (float(gr) if gr is not None else 1.0))


def render_fleet(fleet: dict, max_hosts: Optional[int] = None) -> str:
    """The live-fleet header ``--watch`` puts above the report body.

    The host table is capped to the worst ``max_hosts`` hosts by gating
    signal (default ``BIGDL_TORCH_WATCH_HOSTS``) — at 1000 hosts the frame
    shows the 16 an operator must look at and accounts for the rest
    with one "... and N more" line; the full count always rides
    ``fleet['n_hosts']`` for ``--json`` consumers."""
    if max_hosts is None:
        from bigdl_tpu_torch.config import refresh_from_env

        max_hosts = refresh_from_env().obs.watch_hosts
    hosts = fleet.get("hosts") or {}
    n_total = int(fleet.get("n_hosts") or len(hosts))
    lines = [f"-- live fleet ({fleet.get('mode')}) --"]
    if not hosts:
        lines.append("  (no hosts visible yet)")
    ranked = sorted(hosts.items(), key=lambda kv: str(kv[0]))
    ranked.sort(key=lambda kv: _host_badness(kv[1]), reverse=True)
    shown = ranked if int(max_hosts) <= 0 else ranked[:int(max_hosts)]
    for host, h in shown:
        gr = h.get("goodput_ratio")
        age = h.get("step_age_s")
        qd = h.get("queue_depth")
        po = h.get("prof_overhead")
        nb = h.get("bundles")
        lines.append(
            f"  host{host}: status={h.get('status')} "
            f"step={h.get('step')}"
            + (f" age={age:.1f}s" if age is not None else "")
            + (f" goodput={gr:.3f}" if gr is not None else "")
            + (f" queue={qd:g}" if qd is not None else "")
            + (f" prof={po * 100:.2f}%" if po is not None else "")
            + (f" bundles={int(nb)}" if nb else "")
            + f"  [{h.get('source')}]")
        for a in h.get("alerts") or []:
            lines.append(f"    FIRING {a.get('rule')}"
                         + (f" [{a.get('severity')}]"
                            if a.get("severity") else ""))
    hidden = len(ranked) - len(shown)
    if hidden > 0:
        lines.append(f"  ... and {hidden} more host(s) "
                     f"(worst {len(shown)} of {n_total} shown — "
                     "raise BIGDL_TORCH_WATCH_HOSTS)")
    errors = fleet.get("errors") or {}
    for src, err in sorted(errors.items()):
        lines.append(f"  DOWN {src}: {err}")
    # skew-stale hosts: scraped fine but excluded from fleet merges
    # (failed peers above already carry their error as the reason)
    for src, why in sorted((fleet.get("stale") or {}).items()):
        if src not in errors:
            lines.append(f"  STALE {src}: {why}")
    return "\n".join(lines) + "\n"


#: the fleet-trend series ``--watch`` sparklines out of the retention
#: store (label, metric family) — what ``ingest_snapshot`` retains
_TREND_SERIES = (
    ("queue", names.SERVE_QUEUE_DEPTH),
    ("goodput", names.GOODPUT_RATIO),
    ("scrape_s", names.FLEET_SCRAPE_SECONDS),
    ("stale", names.FLEET_STALE_HOSTS),
)


def render_trends(store, ring: str = "raw", width: int = 32) -> str:
    """Sparkline block for the --watch header: one line per retained
    fleet-trend series (empty string until the store has points)."""
    lines = []
    for label, name in _TREND_SERIES:
        pts = store.series(name, ring=ring)
        if not pts:
            continue
        lines.append(f"  {label:9s} "
                     f"{store.spark(name, ring=ring, width=width)}  "
                     f"{pts[-1][1]:g}")
    if not lines:
        return ""
    return "-- trends (retention store) --\n" + "\n".join(lines) + "\n"


def main(argv=None) -> int:
    import argparse
    import time as _time

    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.obs.report",
        description="Render a run report from trace/metrics JSONL dirs "
                    "(--watch: a refreshing live view fed by peer "
                    "/metrics endpoints or shard tailing).")
    ap.add_argument("trace_dir", help="BIGDL_TORCH_TRACE_DIR of the run")
    ap.add_argument("--metrics-dir", default=None,
                    help="BIGDL_TORCH_METRICS_DIR (default: trace_dir)")
    ap.add_argument("--bundles", default=None,
                    help="debug-bundle dir for the profiles section "
                         "(default: BIGDL_TORCH_BUNDLE_DIR, then "
                         "<metrics_dir>/bundles when it exists)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    ap.add_argument("--watch", action="store_true",
                    help="refreshing terminal view with a live fleet "
                         "header (BIGDL_TORCH_OBS_PEERS or --peers scrapes "
                         "live endpoints; otherwise tails the metrics "
                         "shards)")
    ap.add_argument("--peers", default=None,
                    help="comma-separated host:port live endpoints "
                         "(default BIGDL_TORCH_OBS_PEERS)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--watch refresh period in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="render a single --watch frame and exit "
                         "(CI/testing)")
    args = ap.parse_args(argv)

    if args.watch:
        from bigdl_tpu_torch.obs.aggregate import FleetAggregator
        from bigdl_tpu_torch.obs.retain import RetentionStore

        from bigdl_tpu_torch.config import refresh_from_env

        peers = args.peers if args.peers is not None else \
            refresh_from_env().obs.obs_peers
        agg = FleetAggregator(
            peers=peers,
            metrics_dir=args.metrics_dir or args.trace_dir)
        store = RetentionStore(
            directory=args.metrics_dir or args.trace_dir)
        store.load()  # prior frames' trends survive a watch restart
        while True:
            fleet = agg.snapshot()
            store.ingest_snapshot(_time.time(), fleet)
            rep = build_report(args.trace_dir, args.metrics_dir,
                               bundle_dir=args.bundles)
            rep["fleet"] = fleet
            rep["trends"] = store.summary()
            if args.json:
                print(json.dumps(rep, default=str), flush=True)
            else:
                frame = render_fleet(fleet) + render_trends(store) \
                    + "\n" + render_text(rep)
                if not args.once:
                    # ANSI clear+home: a refreshing view, not a scroll
                    print("\x1b[2J\x1b[H", end="")
                print(frame, end="", flush=True)
            if args.once:
                return 0
            try:
                _time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0

    rep = build_report(args.trace_dir, args.metrics_dir,
                       bundle_dir=args.bundles)
    if not rep["hosts"]:
        print(f"no trace shards under {args.trace_dir}", flush=True)
        return 1
    if args.json:
        print(json.dumps(rep, default=str))
    else:
        print(render_text(rep), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["load_metric_snapshots", "build_report", "render_text",
           "render_fleet", "render_trends", "main"]
