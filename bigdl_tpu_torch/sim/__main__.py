"""The fleet simulator's scenario matrix at fleet scale.

    python -m bigdl_tpu_torch.sim [--hosts N] [--scenarios a,b] [--seed S]
        [--compression C] [--partition-stall-s T] [--jobs J]
        [--serve | --no-serve] [--out FILE]

Counterpart of ``scripts/fleet_sim.py``.  It runs the builtin chaos
scenarios (``BIGDL_TORCH_FLEET_SCENARIO``, default all seven) at
``FleetSimConfig.hosts`` synthetic hosts (``BIGDL_TORCH_FLEET_HOSTS``,
200) against the port's real autoscaler, scrapers and alert engines;
checks the O(hosts) aggregation budget at that size; runs the four
serve scenarios (unless ``--no-serve``); renders the report's fleet
section from the run's own trace; and writes every verdict as one JSON
document to ``--out`` (default: stdout only).  The debug-bundle plane
is armed for ``alert_storm`` alone, as in JAX.  ``--jobs J`` runs the
scenarios in J worker processes at once (each its own fleet, clock and
registry, so each result is the one a serial run gives; only the wall
seconds change); the aggregation probe and the serve scenarios run
after them, alone.  Exits 1 when any invariant fails.  The trace and
metrics go to a temporary directory that is removed at exit.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time


def _scenario_names(spec):
    from bigdl_tpu_torch.sim.scenario import BUILTIN_SCENARIOS

    if not spec:
        return list(BUILTIN_SCENARIOS)
    if spec.lstrip().startswith(("{", "[")):
        return [spec]
    return [s.strip() for s in spec.split(",") if s.strip()]


def run(args) -> dict:
    """The matrix, the aggregation probe, the serve scenarios and the
    report's fleet section: one JSON-able document."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.config import refresh_from_env
    from bigdl_tpu_torch.obs.report import build_report, render_text
    from bigdl_tpu_torch.sim import run_serve_scenario
    from bigdl_tpu_torch.sim.invariants import check_aggregation_scaling
    from bigdl_tpu_torch.sim.runner import run_matrix
    from bigdl_tpu_torch.sim.serve import SERVE_SCENARIOS

    t_run = time.perf_counter()
    fcfg = refresh_from_env().fleet
    hosts = args.hosts if args.hosts is not None else fcfg.hosts
    seed = args.seed if args.seed is not None else fcfg.seed
    compression = (args.compression if args.compression is not None
                   else fcfg.time_compression)
    names = _scenario_names(args.scenarios if args.scenarios is not None
                            else fcfg.scenario)
    t0 = time.perf_counter()
    results = run_matrix(names, hosts, seed, compression,
                         args.partition_stall_s,
                         os.path.join(args.obs_dir, "bundles"), args.jobs)
    wall = time.perf_counter() - t0
    for res in results:
        print(res.summary(), flush=True)
        for inv in res.invariants:
            print("   ", inv, flush=True)
    agg = check_aggregation_scaling(hosts, args.agg_budget_s, seed=seed)
    print(agg, flush=True)
    serve = []
    if args.serve:
        for name in SERVE_SCENARIOS:
            res = run_serve_scenario(name, seed=seed)
            serve.append(res)
            print(res.summary(), flush=True)
            for inv in res.invariants:
                print("   ", inv, flush=True)
    obs.flush()
    text = render_text(build_report(args.obs_dir, args.obs_dir))
    section = text[text.index("-- fleet simulation --"):]
    section = section[:section.index("\n\n")]
    print(section, flush=True)
    ok = (all(r.ok for r in results) and agg.ok
          and all(r.ok for r in serve))
    return {
        "ok": ok,
        "hosts": hosts,
        "seed": seed,
        "time_compression": compression,
        "partition_stall_s": args.partition_stall_s,
        "jobs": args.jobs,
        "total_wall_s": round(wall, 3),
        "scenarios": [r.to_dict() for r in results],
        "aggregation": {"ok": agg.ok, "detail": agg.detail},
        "decisions": sum(len(r.decisions) for r in results),
        "episodes": sum(r.episodes for r in results),
        "bundles": sum(r.bundles for r in results),
        "serve": [r.to_dict() for r in serve],
        "report_fleet_section": section,
        "run_wall_s": round(time.perf_counter() - t_run, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.sim",
        description="Run the fleet simulator's chaos scenarios against "
                    "the port's control plane (the BIGDL_TORCH_FLEET_* "
                    "knobs are these flags' defaults).")
    ap.add_argument("--hosts", type=int, default=None)
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated builtin names, inline JSON or a "
                         "JSON file (default: every builtin)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--compression", type=float, default=None)
    ap.add_argument("--partition-stall-s", type=float, default=0.02,
                    help="real seconds a partitioned host's fetch stalls")
    ap.add_argument("--agg-budget-s", type=float, default=1.5,
                    help="wall budget of one aggregation snapshot")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes the scenarios run in")
    ap.add_argument("--serve", dest="serve", action="store_true",
                    default=True)
    ap.add_argument("--no-serve", dest="serve", action="store_false")
    ap.add_argument("--out", default=None,
                    help="write the JSON document here")
    args = ap.parse_args(argv)
    # the poisoned-sink scenario logs a warning per failed delivery
    logging.getLogger("bigdl_tpu_torch.obs").setLevel(logging.ERROR)
    saved = {k: os.environ.get(k) for k in (
        "BIGDL_TORCH_TRACE_DIR", "BIGDL_TORCH_METRICS_DIR",
        "BIGDL_TORCH_BUNDLE_DIR", "BIGDL_TORCH_BUNDLE_RATE_LIMIT")}
    args.obs_dir = tempfile.mkdtemp(prefix="bigdl_torch_sim_")
    os.environ["BIGDL_TORCH_TRACE_DIR"] = args.obs_dir
    os.environ["BIGDL_TORCH_METRICS_DIR"] = args.obs_dir
    try:
        doc = run(args)
    finally:
        from bigdl_tpu_torch import obs

        obs.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(args.obs_dir, ignore_errors=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=str)
    print(f"fleet sim {'PASS' if doc['ok'] else 'FAIL'}: "
          f"{len(doc['scenarios'])} scenarios at {doc['hosts']} hosts in "
          f"{doc['total_wall_s']:.1f} s, {doc['decisions']} decisions, "
          f"{doc['episodes']} episodes, {doc['bundles']} bundles; "
          f"{len(doc['serve'])} serve scenarios", flush=True)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
