#!/usr/bin/env python3
"""Phase 4 of ``chip_smoke.py`` (the flagship served by ``LMEngine``) from
two checkouts on one card, in turns.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_ab.py OTHER_CHECKOUT [--rounds 1] [--flash]

Each round runs OTHER, this, this, OTHER, each in a process of its own
started in that checkout, which imports that checkout's
``chip_smoke.py`` and runs its phases 1, 2 and 4 (the card, the kernels'
build, the flagship served by a new engine), then serves phase 4's
requests four more times through one more engine of the same model:
the first pass warms it, the other three (its allocator and streams in
use) are averaged.  The kernels are built once into one shared build
directory, ``BIGDL_TORCH_BUILD_DIR`` where it is set, else a temporary
one (their libraries are named by a hash of their sources, so two
checkouts with different sources do not share a library).  It prints
every run's phase-4 and warm lines, prefixed with the checkout's name,
then each checkout's decode step ms and tokens/s, new and warm; the
card's name and power limit come from phase 1.  With ``--flash`` each
run times the flash kernels instead (rows 1-3 of ``PERF.md``'s table):
the forward on the device (phase 3's ``_flash_fwd_times``) and dq and
dkv (phase 10's ``_flash_bwd_times``) in bf16 at the training shape
(B=16, H=8, T=512, D=64, causal) and at B=2, T=4096, and prints each
checkout's ms per kernel and shape, run by run.  Exits non-zero when a
run fails.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

# phase 4 serves its 12 requests on a new engine; then one more engine of
# the same model serves them WARM_PASSES more times, each pass timed
# alone, the first one not counted
WARM_PASSES = 4
RUN = f"""
import sys, time
import chip_smoke as c
if not c.torch.cuda.is_available():
    sys.exit(2)
c.phase_device()
c.phase_build()
model, _, _ = c.phase_main_path()
eng = c._lm_engine(model)
prompts = c._serving_prompts()
steps = ms = 0.0
for i in range({WARM_PASSES}):
    t0 = time.perf_counter()
    reqs = [eng.submit(p, c.SERVE_NEW_TOKENS) for p in prompts]
    eng.run_until_idle(600)
    c.torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    n, total = st["steps"] - steps, st["decode_ms_mean"] * st["steps"] - ms
    steps, ms = st["steps"], st["decode_ms_mean"] * st["steps"]
    if any(r.error or len(r.tokens) != c.SERVE_NEW_TOKENS for r in reqs):
        sys.exit("a warm pass's request failed")
    print(f"warm pass {{i}}: tokens/s {{12 * c.SERVE_NEW_TOKENS / wall:.1f}}, "
          f"decode step {{total / n:.3f}} ms mean", flush=True)
eng.close()
"""
STEP = re.compile(r"tokens/s ([0-9.]+), decode step ([0-9.]+) ms mean")
RUN_FLASH = """
import json, sys
import chip_smoke as c
if not c.torch.cuda.is_available():
    sys.exit(2)
c.phase_device()
c.phase_build()
gen = c.torch.Generator(device="cuda")
gen.manual_seed(0)
bf16 = c.torch.bfloat16
row = {}
for tag, b, t in (("train", c.LM_BATCH, c.LM_T), ("long", c.LONG_BATCH,
                                                   c.LONG_T)):
    row["flash_fwd " + tag] = c._flash_fwd_times(b, 8, t, 64, bf16, gen,
                                                 plain=False)["device_ms"]
    bwd = c._flash_bwd_times((b, 8, t, t, 64, bf16, True), gen, plain=False)
    row["flash_bwd_dq " + tag] = bwd["dq"]
    row["flash_bwd_dkv " + tag] = bwd["dkv"]
print("FLASH " + json.dumps(row), flush=True)
"""


def run_flash(tree: str, build_dir: str) -> dict:
    env = dict(os.environ, BIGDL_TORCH_BUILD_DIR=build_dir)
    out = subprocess.run([sys.executable, "-c", RUN_FLASH], cwd=tree,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    name = os.path.basename(os.path.abspath(tree))
    for line in out.stdout.splitlines():
        if "phase 1 " in line or not line.startswith("["):
            print(f"[{name}] {line}", flush=True)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {out.returncode}")
    import json

    return json.loads(out.stdout.split("FLASH ", 1)[1].splitlines()[0])


def run_one(tree: str, build_dir: str) -> tuple:
    env = dict(os.environ, BIGDL_TORCH_BUILD_DIR=build_dir)
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    name = os.path.basename(os.path.abspath(tree))
    for line in out.stdout.splitlines():
        # phases 1 and 4, and the lines printed bare (nvidia-smi's)
        if "phase 1 " in line or "phase 4 " in line \
                or not line.startswith("[") or line.startswith("warm"):
            print(f"[{name}] {line}", flush=True)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {out.returncode}")
    got = [(float(a), float(b)) for a, b in STEP.findall(out.stdout)]
    if len(got) != 1 + WARM_PASSES:
        raise SystemExit(f"{tree}: {len(got)} step lines")
    # phase 4 (a new engine), then the warm passes' mean
    warm = got[2:]
    return got[0], (sum(a for a, _ in warm) / len(warm),
                    sum(b for _, b in warm) / len(warm))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--flash", action="store_true",
                    help="time the flash kernels instead of phase 4")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [os.path.abspath(args.other), here]
    got = {t: [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        build_dir = os.environ.get("BIGDL_TORCH_BUILD_DIR") or tmp
        for _ in range(args.rounds):
            for t in (trees[0], trees[1], trees[1], trees[0]):
                got[t].append((run_flash if args.flash else run_one)(
                    t, build_dir))
    if args.flash:
        for t in trees:
            for key in got[t][0]:
                ms = ", ".join(f"{r[key]:.4f}" for r in got[t])
                print(f"{os.path.basename(t)}: {key} ms [{ms}]", flush=True)
        return 0
    for t in trees:
        for k, what in enumerate(("phase 4 (new engine)",
                                  f"warm, mean of {WARM_PASSES - 1} "
                                  "passes")):
            tps = ", ".join(f"{r[k][0]:.1f}" for r in got[t])
            step = ", ".join(f"{r[k][1]:.3f}" for r in got[t])
            print(f"{os.path.basename(t)}: {what}: tokens/s [{tps}]; "
                  f"decode step ms [{step}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
