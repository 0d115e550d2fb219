"""Training driver of an MoE cell: ``train``'s loop, with a reference
that holds four copies of the parameters on the device and one reading
more.

* The reference follows ``reference.optim.run_steps`` step for step and
  number for number (the clip, then Adam with bias correction), but
  keeps the start on the host, updates one leaf at a time and keeps the
  first gradient and the change as their norms by leaf: w, m, v and the
  gradient on the device, where ``run_steps`` with its caller holds nine
  copies.  So the depth a cell keeps is the program's to set.
* ``grad_median_gap``: the median over the leaves of the gap whose
  largest ``grad_gap`` reads (:func:`benchmark.compare.worst_leaf`).  Every leaf's gradient in an
  MoE depends on the router's top-k choices, and rounding flips a few
  of them; the worst leaf then reads the flips, to which a lower
  precision adds only slowly, while the median leaf reads the arithmetic
  of most leaves.  The worst leaf still catches a fault confined to a
  few leaves.

    python3 benchmark/drivers/train_moe.py --workload <cell> \
        --seeds <n> [<n> ...]

prints the float8 control's readings (``benchmark/control.py``'s
control, by this reference), one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from typing import Dict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import compare, traffic, weights  # noqa: E402
from benchmark.drivers import train  # noqa: E402


def start_on_host(run) -> Dict[str, torch.Tensor]:
    """The benchmark's weights of the run's seed, drawn on the device as
    the program's are, then moved to the host one leaf at a time."""
    w0 = weights.make(run.reference.weight_specs(run.config), run.seed,
                      run.device)
    return {k: w0.pop(k).cpu() for k in list(w0)}


def reference_steps(run, w0: Dict[str, torch.Tensor], batches,
                    quant=None) -> dict:
    """The plain reference's steps 1-3 from ``w0`` (on the host) over
    ``batches``, as ``train.reference_steps`` takes them: each step's
    loss, the first gradient after the clip and the change over the
    steps, the last two as norms by leaf."""
    from benchmark.reference import optim as ref_optim

    cfg, mix = run.config, run.cell["traffic"]
    method, clip = cfg["train"]["optim"], cfg["train"].get("clip_l2")
    if method["name"] != "Adam":
        raise ValueError(f"no plain update for {method['name']!r} here")
    a = method["args"]
    lr, eps = a["learningrate"], a.get("epsilon", 1e-8)
    b1, b2 = a.get("beta1", 0.9), a.get("beta2", 0.999)
    ref_optim.no_tf32()
    rows = max(1, int(mix.get("reference_rows", mix["batch"])))

    def loss_sum(w, xb, yb):
        return run.reference.loss_sum(w, xb, yb, cfg, quant)

    w = {k: t.to(run.device) for k, t in w0.items()}
    m = {k: torch.zeros_like(t) for k, t in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    losses, grad_norms = [], None
    for t, (x, y) in enumerate(batches, 1):
        loss, g = ref_optim.grads(loss_sum, w, x, y, rows)
        with torch.no_grad():
            if clip is not None:   # ref_optim.clip_global, in place
                sq = sum(torch.sum(d * d) for d in g.values())
                scale = torch.clamp_max(clip / (torch.sqrt(sq) + 1e-12),
                                        1.0)
                for d in g.values():
                    d.mul_(scale)
            if grad_norms is None:
                grad_norms = dict(zip(g, torch.stack(
                    [d.norm() for d in g.values()]).tolist()))
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            for k in list(w):      # ref_optim.step's Adam, leaf by leaf
                d = g.pop(k)
                m[k] = b1 * m[k] + (1 - b1) * d
                v[k] = b2 * v[k] + (1 - b2) * d * d
                w[k] = w[k] - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2)
                                                   + eps)
        losses.append(loss)
    del m, v
    with torch.no_grad():
        change = dict(zip(w, torch.stack(
            [(w[k] - w0[k].to(run.device)).norm() for k in w]).tolist()))
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def median_gap(program: Dict[str, float],
               reference: Dict[str, float]) -> float:
    """The median over the leaves of :func:`compare.worst_leaf`'s gap."""
    med = statistics.median(reference.values())
    gaps = []
    for k in reference:
        p = program.get(k, math.nan) if program is not None else math.nan
        gap = abs(p - reference[k]) / max(reference[k], med, 1e-30)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return statistics.median(gaps)


def readings(program: dict, ref: dict) -> Dict[str, tuple]:
    """:func:`compare.train_readings` of ``program`` against the
    reference's norms (:func:`reference_steps`), and the median leaf's
    gradient gap.  ``train_readings`` takes tensors and
    reads their norms, so each norm goes in as a 0-d tensor."""
    def held(norms):
        return {k: torch.tensor(n, dtype=torch.float64)
                for k, n in norms.items()}

    change = held(ref["change_norms"])
    out = compare.train_readings(
        program, {"losses": ref["losses"], "grad": held(ref["grad_norms"]),
                  "weights": change}, held(dict.fromkeys(change, 0.0)))
    out["grad_median_gap"] = (median_gap(program["grad_norms"],
                                         ref["grad_norms"]), "median leaf")
    return out


def check_against_reference(run, program: dict, x, y) -> None:
    """``train.check_against_reference`` by this module's reference and
    readings."""
    ref = reference_steps(run, start_on_host(run),
                          train.first_batches(run, x, y))
    found = readings(program, ref)
    run.record["readings"] = {k: v for k, (v, _) in found.items()}
    for name in run.cell["limits"]:
        value, where = found[name]
        run.checks[name] = (value, run.limit(name))
        run.record.setdefault("worst", {})[name] = where


def drive(run) -> None:
    """``train.drive``, its check against the reference this module's."""
    stock = train.check_against_reference
    train.check_against_reference = check_against_reference
    try:
        train.drive(run)
    finally:
        train.check_against_reference = stock


def control(run) -> Dict[str, float]:
    """``control.train_control``'s reading: the float8 reference's steps
    1-3 in the program's place against the float32 reference's."""
    x, y = traffic.train_pool(run.cell["traffic"], run.config, run.seed,
                              run.device)
    batches = train.first_batches(run, x, y)
    w0 = start_on_host(run)
    low = reference_steps(run, w0, batches, quant="fp8")
    run.free_device()
    ref = reference_steps(run, w0, batches)
    return {k: v for k, (v, _) in readings(low, ref).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    os.environ["BIGDL_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build",
                                                       "bigdl_tpu_torch")
    from benchmark import harness

    for seed in args.seeds:
        run = harness.prepare(args.workload, seed, 1.0, False, "cuda",
                              time.perf_counter())
        print(json.dumps({"seed": seed, "control": control(run)}),
              flush=True)
        run.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
