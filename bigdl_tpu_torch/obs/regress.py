"""Perf-regression verdict: "is this step time slower than the best?".

Counterpart of ``bigdl_tpu/obs/regress.py``: :func:`check` compares a
fresh result against a trajectory of earlier ones on the same platform
and says ``pass``, ``violation``
or ``no_baseline``; a violation is ``fresh_step_time > best *
tolerance`` (or the throughput mirror), with ``tolerance`` from
``BIGDL_TORCH_REGRESS_TOLERANCE`` (default 1.5).  The kernel
auto-tuner gates every measured winner through it
(``ops/autotune._gate_measured``).  :func:`load_trajectory` reads
``BENCH_r*.json`` files as the JAX package writes them.  On a violation
:func:`gate` dumps a flight-recorder bundle (:func:`flight_bundle`: the
tracer's span ring or the newest events shard's tail, the metrics
snapshot, the runtime profile, the health columns, JAX :160-270); the
CLI (JAX :276-318)::

    python -m bigdl_tpu_torch.obs.regress --fresh BENCH.json \
        --trajectory DIR [--tolerance 1.5] [--flight-dir DIR] [--json]

exits 1 on a violation, 0 on a pass or with no comparable baseline.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import List, Optional

from bigdl_tpu_torch.obs import names

_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")


def _default_tolerance() -> float:
    from bigdl_tpu_torch.config import ObsConfig

    return ObsConfig.from_env().regress_tolerance


def _entry_from_result(result: dict, source: str = "fresh",
                       round_no: Optional[int] = None) -> Optional[dict]:
    """One bench result dict as a comparable entry (JAX :46-64)."""
    if not isinstance(result, dict) or "extras" not in result:
        return None
    ex = result.get("extras") or {}
    rt = ex.get("obs_runtime") or {}
    step = rt.get("step_time_p50_s")
    if step is None:
        step = ex.get("step_time_s")
    return {
        "source": source,
        "round": round_no,
        "platform": result.get("platform"),
        "value": result.get("value"),
        "step_time_s": step,
        "step_time_p95_s": rt.get("step_time_p95_s"),
        "compile_count": rt.get("compile_count"),
    }


def load_trajectory(path: Optional[str]) -> List[dict]:
    """Every ``BENCH_r*.json`` under ``path``, oldest first; a result
    wrapped under ``"parsed"`` or bare.  An unset or empty path, or one
    with no such file, is ``[]`` (JAX :67-97)."""
    if not path:
        return []
    entries = []
    for fn in sorted(glob.glob(os.path.join(path, "BENCH_r*.json"))):
        m = _ROUND_RE.search(fn)
        rnd = int(m.group(1)) if m else None
        try:
            with open(fn, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        result = doc.get("parsed") if isinstance(doc, dict) else None
        if result is None:
            result = doc
        e = _entry_from_result(result, source=os.path.basename(fn),
                               round_no=rnd)
        if e is not None:
            entries.append(e)
    entries.sort(key=lambda e: (e["round"] is None, e["round"]))
    return entries


def check(fresh, trajectory: Optional[List[dict]],
          tolerance: Optional[float] = None) -> dict:
    """Compare a fresh result (a bench dict or an entry) against the
    trajectory's best on the same platform (JAX :100-157).  Returns a
    verdict with ``status`` in ``{"pass", "violation", "no_baseline"}``;
    an empty trajectory is a clean ``no_baseline``."""
    if tolerance is None:
        tolerance = _default_tolerance()
    trajectory = trajectory or []
    cur = (fresh if fresh is not None and "source" in fresh
           else _entry_from_result(fresh or {}))
    verdict = {"status": "no_baseline", "tolerance": tolerance,
               "current": cur, "baseline": None, "violations": []}
    if cur is None:
        verdict["violations"].append("fresh result is not a bench dict")
        verdict["status"] = "violation"
        return verdict
    peers = [e for e in trajectory
             if e["platform"] == cur["platform"]
             and (e["step_time_s"] is not None or e["value"] is not None)]
    if not peers:
        return verdict
    step_peers = [e for e in peers if e["step_time_s"]]
    val_peers = [e for e in peers if e["value"]]
    base_step = min(step_peers, key=lambda e: e["step_time_s"]) \
        if step_peers else None
    base_val = max(val_peers, key=lambda e: e["value"]) if val_peers else None
    verdict["baseline"] = {
        "step_time_s": base_step["step_time_s"] if base_step else None,
        "step_round": base_step["source"] if base_step else None,
        "value": base_val["value"] if base_val else None,
        "value_round": base_val["source"] if base_val else None,
        "rounds_compared": len(peers),
    }
    compared = False
    if base_step and cur.get("step_time_s"):
        compared = True
        ratio = cur["step_time_s"] / base_step["step_time_s"]
        verdict["step_time_ratio"] = round(ratio, 4)
        if ratio > tolerance:
            verdict["violations"].append(
                f"step time {cur['step_time_s']:.6g}s is {ratio:.2f}x the "
                f"trajectory best {base_step['step_time_s']:.6g}s "
                f"({base_step['source']}) > tolerance {tolerance}x")
    if base_val and cur.get("value"):
        compared = True
        ratio = base_val["value"] / cur["value"]
        verdict["throughput_ratio"] = round(ratio, 4)
        if ratio > tolerance:
            verdict["violations"].append(
                f"throughput {cur['value']:.6g} is {ratio:.2f}x below the "
                f"trajectory best {base_val['value']:.6g} "
                f"({base_val['source']}) > tolerance {tolerance}x")
    if not compared:
        return verdict
    verdict["status"] = "violation" if verdict["violations"] else "pass"
    return verdict


# ------------------------------------------------------------ flight recorder
def _tail_shard_records(trace_dir: str, k: int) -> list:
    """Offline fallback: the last ``k`` records of the newest events
    shard under ``trace_dir``."""
    from bigdl_tpu_torch.obs.aggregate import read_shards

    try:
        shards = read_shards(trace_dir)
    except OSError:
        return []
    if not shards:
        return []
    newest = max(shards, key=lambda s: os.path.getmtime(s.path))
    return newest.records[-k:]


def flight_bundle(reason: str = "", trace_dir: Optional[str] = None,
                  metrics_dir: Optional[str] = None) -> dict:
    """The postmortem bundle: last-K spans (live ring buffer first,
    newest on-disk shard as the offline fallback), metrics snapshot
    (live registry first, newest on-disk ``metrics.*.jsonl`` snapshot
    offline), runtime profile."""
    from bigdl_tpu_torch import obs

    spans = obs.get_tracer().recent()
    source = "ring_buffer"
    if not spans and trace_dir:
        from bigdl_tpu_torch.config import refresh_from_env

        k = refresh_from_env().obs.flight_spans
        spans = _tail_shard_records(trace_dir, k)
        source = "shard_tail"
    metrics = obs.get_registry().snapshot()
    metrics_source = "registry"
    if not metrics.get("metrics") and (metrics_dir or trace_dir):
        from bigdl_tpu_torch.obs.report import load_metric_snapshots

        snaps = load_metric_snapshots(metrics_dir or trace_dir)
        if snaps:
            metrics = max(snaps, key=lambda s: s.get("ts", 0))
            metrics_source = "disk_snapshot"
    from bigdl_tpu_torch.obs.runtime import host_rss_bytes

    return {
        "kind": "bigdl_flight_recorder",
        "ts": time.time(),
        "reason": reason,
        "spans_source": source if spans else "none",
        "spans": spans,
        "metrics": metrics,
        "metrics_source": metrics_source,
        # memory=False: a postmortem dump must never block on a wedged
        # device
        "runtime": obs.get_runtime().snapshot(memory=False),
        "host_rss_bytes": host_rss_bytes(),
        # training-health columns (obs/health.py): the postmortem's
        # first numerics questions — which layer's norms moved, which
        # went non-finite, what anomalies fired — pre-extracted from
        # the same metrics snapshot + span ring
        "health": _health_columns(metrics, spans),
    }


_HEALTH_FAMILIES = (names.GRAD_NORM, names.PARAM_NORM,
                    names.UPDATE_RATIO, names.GLOBAL_GRAD_NORM,
                    names.NONFINITE_LAYERS_TOTAL,
                    names.NUMERICS_ANOMALIES_TOTAL, names.STEP_FLOPS,
                    names.MFU)


def _health_columns(metrics: dict, spans: list) -> dict:
    fams = (metrics or {}).get("metrics") or {}
    out = {"metrics": {name: fams[name]["samples"]
                       for name in _HEALTH_FAMILIES if name in fams}}
    out["events"] = [r for r in (spans or [])
                     if str(r.get("name", "")).startswith("health.")]
    return out


def dump_flight_recorder(out_dir: str, verdict: dict,
                         trace_dir: Optional[str] = None,
                         metrics_dir: Optional[str] = None) -> str:
    """Write ``flight.<pid>.<ts>.json`` with the bundle + verdict."""
    os.makedirs(out_dir, exist_ok=True)
    bundle = flight_bundle(
        reason="; ".join(verdict.get("violations", [])) or "manual",
        trace_dir=trace_dir, metrics_dir=metrics_dir)
    bundle["verdict"] = verdict
    path = os.path.join(
        out_dir, f"flight.{os.getpid()}.{int(time.time())}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(bundle, fh, default=str)
    os.replace(tmp, path)
    return path


def gate(fresh, trajectory_dir: Optional[str],
         tolerance: Optional[float] = None,
         flight_dir: Optional[str] = None,
         trace_dir: Optional[str] = None,
         metrics_dir: Optional[str] = None) -> dict:
    """check() against the dir's BENCH_r*.json; on violation, dump the
    flight-recorder bundle (when ``flight_dir`` is given) and record its
    path in the verdict.  A ``trajectory_dir`` of None reads
    ``BIGDL_TORCH_REGRESS_TRAJECTORY``."""
    if trajectory_dir is None:
        from bigdl_tpu_torch.config import ObsConfig

        trajectory_dir = ObsConfig.from_env().regress_trajectory
    verdict = check(fresh, load_trajectory(trajectory_dir),
                    tolerance=tolerance)
    if verdict["status"] == "violation" and flight_dir:
        try:
            verdict["flight_recorder"] = dump_flight_recorder(
                flight_dir, verdict, trace_dir=trace_dir,
                metrics_dir=metrics_dir)
        except OSError as e:
            verdict["flight_recorder_error"] = str(e)
    return verdict


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.obs.regress",
        description="Gate a fresh bench result against the BENCH_r*.json "
                    "trajectory; exit 1 on regression.")
    ap.add_argument("--fresh", required=True,
                    help="fresh bench JSON file ('-' reads stdin)")
    ap.add_argument("--trajectory", default=".",
                    help="dir holding BENCH_r*.json (default: cwd)")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="slowdown factor that trips the gate "
                         "(default BIGDL_TORCH_REGRESS_TOLERANCE=1.5)")
    ap.add_argument("--flight-dir", default=None,
                    help="dump a flight-recorder bundle here on violation")
    ap.add_argument("--trace-dir", default=None,
                    help="trace dir whose newest shard seeds the bundle's "
                         "span tail when no live tracer exists")
    ap.add_argument("--metrics-dir", default=None,
                    help="metrics dir whose newest snapshot seeds the "
                         "bundle offline (default: trace dir)")
    ap.add_argument("--json", action="store_true",
                    help="print the full verdict JSON (default: summary)")
    args = ap.parse_args(argv)
    raw = (sys.stdin.read() if args.fresh == "-"
           else open(args.fresh, encoding="utf-8").read())
    doc = json.loads(raw)
    fresh = doc.get("parsed") if isinstance(doc, dict) and "parsed" in doc \
        else doc
    verdict = gate(fresh, args.trajectory, tolerance=args.tolerance,
                   flight_dir=args.flight_dir, trace_dir=args.trace_dir,
                   metrics_dir=args.metrics_dir)
    if args.json:
        print(json.dumps(verdict, default=str))
    else:
        print(f"regression gate: {verdict['status']} "
              f"(tolerance {verdict['tolerance']}x)")
        for v in verdict["violations"]:
            print(f"  VIOLATION: {v}")
        if verdict.get("flight_recorder"):
            print(f"  flight recorder: {verdict['flight_recorder']}")
    return 1 if verdict["status"] == "violation" else 0


__all__ = ["check", "load_trajectory", "flight_bundle",
           "dump_flight_recorder", "gate", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
