"""The controls of the outputs' check, and the readings that set its
limits.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--program] [--fault] [--seconds <s>]

The control of a training cell is the plain reference computed with the
inputs of every product rounded to float8 (the precision below the
configuration's bfloat16), put in the program's place: its steps 1-3
are compared with the float32 reference's exactly as the program's are.
``--fault`` also reads the reference with half of each batch left out in
the program's place; ``--program`` also reads the program itself on
each seed (a run of ``--seconds``).  Each reading is printed as one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_control(run, fault: bool = False) -> dict:
    """{number: value}: the float8 reference's steps 1-3 against the
    float32 reference's, at the cell's sizes; with ``fault``, the
    reference with half of each batch left out (the mean over the rest)
    in the program's place instead."""
    from benchmark import compare, traffic, weights
    from benchmark.drivers import train

    x, y = traffic.train_pool(run.cell["traffic"], run.config, run.seed,
                              run.device)
    batches = train.first_batches(run, x, y)
    w0 = weights.make(run.reference.weight_specs(run.config), run.seed,
                      run.device)
    if fault:
        half = [(a[:len(a) // 2], b[:len(b) // 2]) for a, b in batches]
        low = train.reference_steps(run, w0, half)
    else:
        low = train.reference_steps(run, w0, batches, quant="fp8")
    low = compare.reference_readings(low, w0)
    run.free_device()
    ref = train.reference_steps(run, w0, batches)
    return {k: v for k, (v, _) in
            compare.train_readings(low, ref, w0).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--fault", action="store_true",
                    help="read half of each batch left out, in the "
                         "program's place")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    os.environ["BIGDL_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build",
                                                       "bigdl_tpu_torch")
    from benchmark import harness

    for seed in args.seeds:
        run = harness.prepare(args.workload, seed, args.seconds, False,
                              "cuda", time.perf_counter())
        print(json.dumps({"seed": seed, "control": train_control(run)}),
              flush=True)
        if args.fault:
            print(json.dumps({"seed": seed, "half_batch": train_control(
                run, fault=True)}), flush=True)
        if args.program:
            run = harness.prepare(args.workload, seed, args.seconds, False,
                                  "cuda", time.perf_counter())
            harness.load_module(harness.find(
                "drivers", run.cell["driver"], run.roots, ".py")).drive(run)
            program = run.record.get("readings") or {
                k: v for k, (v, _) in run.checks.items()}
            print(json.dumps({"seed": seed, "program": program}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
