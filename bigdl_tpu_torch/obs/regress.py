"""Perf-regression verdict: "is this step time slower than the best?".

Counterpart of the verdict half of ``bigdl_tpu/obs/regress.py``
(:38-157): :func:`check` compares a fresh result against a trajectory
of earlier ones on the same platform and says ``pass``, ``violation``
or ``no_baseline``; a violation is ``fresh_step_time > best *
tolerance`` (or the throughput mirror), with ``tolerance`` from
``BIGDL_TORCH_REGRESS_TOLERANCE`` (default 1.5).  The kernel
auto-tuner gates every measured winner through it
(``ops/autotune._gate_measured``).  :func:`load_trajectory` reads
``BENCH_r*.json`` files as the JAX package writes them.  The flight
bundle, the bench gate and the CLI of that file are not ported.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import List, Optional

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


__all__ = ["check", "load_trajectory"]
