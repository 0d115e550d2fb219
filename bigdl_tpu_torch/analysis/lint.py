"""graftlint CLI of the port — ``python -m bigdl_tpu_torch.analysis.lint
[paths...]`` (the JAX package's ``bigdl_tpu/analysis/lint.py``).

Thread/lock discipline (CC*) and config/metric registry drift (RD*)
over the port.  The JAX package's tracing rules (JX*) have no
counterpart: there is no jit to trace (``ROADMAP.md`` queue 3).  Exit 0
means zero unsuppressed findings; any fresh finding (not in the
baseline, not silenced by a ``# graftlint: disable=`` comment) exits 1.

Workflow (from the repository root)::

    python -m bigdl_tpu_torch.analysis.lint                 # the gate
    python -m bigdl_tpu_torch.analysis.lint --list-rules
    python -m bigdl_tpu_torch.analysis.lint --rules CC001,CC002
    python -m bigdl_tpu_torch.analysis.lint --write-baseline  # accept

The baseline (``bigdl_tpu_torch/analysis/baseline.json``, which the
port's pass does not need and so does not have) holds accepted legacy
findings keyed by rule + path + a hash of the offending source line, so
entries survive unrelated edits but expire when the line changes.
Stale entries are reported (and dropped by ``--write-baseline``) —
never silently kept.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from bigdl_tpu_torch.analysis import core
from bigdl_tpu_torch.analysis.core import (DEFAULT_BASELINE, Finding, Linter,
                                     apply_baseline, load_baseline,
                                     write_baseline)

DEFAULT_PATHS = ("bigdl_tpu_torch",)


def run_lint(paths=DEFAULT_PATHS, root: Optional[str] = None,
             baseline: Optional[str] = DEFAULT_BASELINE,
             rules=None, lib_mode: str = "auto", packs=None):
    """Library entry point: returns ``(fresh, stale, linter)`` where
    ``fresh`` are unsuppressed non-baseline findings and ``stale`` are
    baseline entries that no longer match anything."""
    linter = Linter(paths, root=root, rules=rules, lib_mode=lib_mode,
                    packs=packs)
    findings = linter.run()
    stale: List[dict] = []
    if baseline:
        bpath = baseline if os.path.isabs(baseline) else os.path.join(
            linter.root, baseline)
        entries = load_baseline(bpath)
        if entries is not None:
            findings, stale = apply_baseline(findings, linter.modules,
                                             entries)
    return findings, stale, linter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.analysis.lint",
        description="graftlint: concurrency discipline and registry "
                    "drift")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", default=None,
                    help="repo root paths are relative to (default: cwd)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file of accepted legacy findings "
                         f"(default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings into --baseline "
                         "(drops stale entries) and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        # importing the packs populates core.ALL_RULES
        from bigdl_tpu_torch.analysis import (  # noqa: F401
            concurrency, registry_rules)

        for rule, desc in sorted(core.ALL_RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    t0 = time.perf_counter()
    paths = args.paths or list(DEFAULT_PATHS)
    baseline = None if args.no_baseline else args.baseline
    if args.write_baseline:
        linter = Linter(paths, root=args.root, rules=rules)
        findings = linter.run()
        bpath = args.baseline if os.path.isabs(args.baseline) else \
            os.path.join(linter.root, args.baseline)
        write_baseline(bpath, findings, linter.modules)
        print(f"[graftlint] baseline: {len(findings)} finding(s) "
              f"accepted into {args.baseline}")
        return 0

    fresh, stale, linter = run_lint(paths, root=args.root,
                                    baseline=baseline, rules=rules)
    dt = time.perf_counter() - t0
    if args.json:
        print(json.dumps({
            "findings": [f.__dict__ for f in fresh],
            "stale_baseline": stale,
            "files": len(linter.modules),
            "seconds": round(dt, 3),
        }, indent=1, sort_keys=True))
    else:
        for f in fresh:
            print(f.render())
        for e in stale:
            print(f"[graftlint] stale baseline entry: {e['rule']} "
                  f"{e['path']} ({e.get('message', '')[:60]}) — fixed? "
                  "run --write-baseline to expire it")
        status = "clean" if not fresh else f"{len(fresh)} finding(s)"
        print(f"[graftlint] {status}: {len(linter.modules)} files in "
              f"{dt:.2f}s"
              + (f", {len(stale)} stale baseline entries" if stale
                 else ""))
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
