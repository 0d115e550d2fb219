#!/usr/bin/env python3
"""Mutation check of the training-phase loss limits of ``chip_smoke.py``.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_mutants.py

It trains the two ResNet-50 arms of ``chip_smoke.py``'s phase 7 three
times, each in a fresh process on a copy of the package: as it is, and
with the fused conv + BN backward (``bigdl_tpu_torch/ops/conv_bn.py``)
broken in two ways, the ``2(y - shift)·gs2`` term dropped, and both
statistics cotangents dropped.  It prints each run's loss gaps (fused
minus standard) by step and exits non-zero unless the intact run keeps
within chip_smoke's limits and each broken run does not.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
TARGET = os.path.join("bigdl_tpu_torch", "ops", "conv_bn.py")
INTACT = "gy_eff = (gy.to(acc) + gs1[c] + 2.0 * yc * gs2[c]).to(x.dtype)"
MUTANTS = {
    "intact": INTACT,
    "drop_gs2": "gy_eff = (gy.to(acc) + gs1[c]).to(x.dtype)",
    "drop_gs1_gs2": "gy_eff = gy.to(acc).to(x.dtype)",
}
CHILD = """
import json, chip_smoke as cs
cs.phase_device()
_, _, std, fused = cs.train_both_arms()
gaps, over = cs.loss_gaps(std, fused)
print(json.dumps({"standard": std, "fused": fused, "gaps": gaps,
                  "over": over}))
"""


def run(name: str, line: str, tmp: str) -> dict:
    """Train both arms on a copy of the package with ``line`` in place of
    the intact backward line; the child's result."""
    copy = os.path.join(tmp, name)
    ignore = shutil.ignore_patterns("__pycache__", "build")
    shutil.copytree(os.path.join(ROOT, "bigdl_tpu_torch"),
                    os.path.join(copy, "bigdl_tpu_torch"), ignore=ignore)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
    path = os.path.join(copy, TARGET)
    with open(path) as f:
        text = f.read()
    if text.count(INTACT) != 1:
        raise RuntimeError(f"{TARGET}: the backward line is not there once")
    with open(path, "w") as f:
        f.write(text.replace(INTACT, line))
    env = dict(os.environ, BIGDL_TORCH_BUILD_DIR=os.path.join(tmp, "build"))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: exit {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    tmp = tempfile.mkdtemp(prefix="chip_mutants-")
    try:
        results = {name: run(name, line, tmp)
                   for name, line in MUTANTS.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = True
    for name, r in results.items():
        caught = bool(r["over"])
        ok &= caught == (name != "intact")
        print(f"[chip_mutants] {name}: fused losses "
              f"{['%.5f' % v for v in r['fused']]}; |gap| by step "
              f"{['%.3e' % g for g in r['gaps']]}; over the limit at steps "
              f"{r['over']}", flush=True)
    print(json.dumps({"ok": ok, "runs": results}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
