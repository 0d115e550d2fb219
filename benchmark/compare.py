"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference, as numbers each held to a limit of its
cell (``workloads/<cell>.json``, ``limits``)."""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam (a key's bias under softmax)
# and is left out of the change
STILL_LEAF = 1e-3


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               leaves) -> tuple:
    """(gap, leaf): the largest gap between the program's norm of a leaf
    and the reference's, over the larger of the reference's norm of that
    leaf and of the median leaf."""
    med = statistics.median(reference[k] for k in leaves)
    worst = (0.0, None)
    for k in leaves:
        p = program.get(k, math.nan) if program is not None else math.nan
        gap = abs(p - reference[k]) / max(reference[k], med, 1e-30)
        gap = gap if math.isfinite(gap) else math.inf
        if gap >= worst[0]:
            worst = (gap, k)
    return worst


def train_readings(program: dict, ref: dict,
                   w0: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """``loss_gap``: the largest relative gap of steps 1-3's losses
    (``loss1_gap``: step 1's, the forward alone);
    ``grad_gap``: the worst leaf of the first gradient the update was
    handed; ``change_gap``: the worst leaf of the parameters' change over
    steps 1-3, leaves the reference's gradient leaves still left out.
    Each comes as (value, the step or leaf where it is read).  A cell compares those its
    ``limits`` name."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                   ref["losses"])]
    worst = max(range(len(losses)), key=lambda i: (
        losses[i] if math.isfinite(losses[i]) else math.inf))
    loss_gap = (losses[worst] if math.isfinite(losses[worst]) else math.inf,
                f"step {worst + 1}")
    g_ref = {k: float(v.norm()) for k, v in ref["grad"].items()}
    d_ref = {k: float((ref["weights"][k] - w0[k].float()).norm())
             for k in w0}
    med = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= STILL_LEAF * med]
    first = losses[0] if math.isfinite(losses[0]) else math.inf
    return {"loss_gap": loss_gap, "loss1_gap": (first, "step 1"),
            "grad_gap": worst_leaf(program["grad_norms"], g_ref, list(g_ref)),
            "change_gap": worst_leaf(program["change_norms"], d_ref, moving)}


def reference_readings(out: dict, w0: Dict[str, torch.Tensor]) -> dict:
    """A reference run's steps in the program's place: its losses, first
    gradient's and change's norms by leaf."""
    return {"losses": list(out["losses"]),
            "grad_norms": {k: float(v.norm()) for k, v in out["grad"].items()},
            "change_norms": {k: float((out["weights"][k] - w0[k].float())
                                      .norm()) for k in w0}}

