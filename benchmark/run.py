"""Run one cell of the benchmark of ``bigdl_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit (also the last
lines of standard error).  Exits non-zero, printing no result, without
enough CUDA devices, or when the JAX stack or the JAX package was loaded.
Every build and kernel cache stays under ``build/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment(trace: bool) -> None:
    """The program's knobs as the benchmark runs it: no inherited
    ``BIGDL_TORCH_*`` setting, caches inside the checkout, the tuner and
    the sampling profiler off; a traced run samples every request's
    spans."""
    for key in [k for k in os.environ if k.startswith("BIGDL_TORCH_")]:
        del os.environ[key]
    build = os.path.join(ROOT, "build")
    os.environ["BIGDL_TORCH_BUILD_DIR"] = os.path.join(build, "bigdl_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["BIGDL_TORCH_TUNER"] = "0"
    os.environ["BIGDL_TORCH_PROF_HZ"] = "0"
    os.environ["BIGDL_TORCH_DISABLE_LOGGER"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if trace:
        os.environ["BIGDL_TORCH_REQTRACE_SAMPLE"] = "1.0"
        os.environ["BIGDL_TORCH_REQTRACE_RING"] = "65536"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(bool(args.trace))
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stderr.write(harness.checks_text(result) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
