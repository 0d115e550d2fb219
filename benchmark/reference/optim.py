"""Plain training steps: gradients in blocks of rows, the global L2
clip, and the SGD and Adam updates, each written out as the measured
trainer states them (BigDL's SGD: weight decay added to the gradient,
then momentum with dampening; Adam with bias correction and eps outside
the root).  float32 with TF32 off; nothing here imports the program."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def no_tf32() -> None:
    """float32 products in float32: TF32 is a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def grads(loss_sum: Callable, w: Dict[str, torch.Tensor], x, y,
          rows_per_block: int):
    """(mean loss, {name: gradient}) of the mean over every row and
    position of ``loss_sum(w, x, y)``, summed block by block so that a
    large batch fits; a block of the whole batch where statistics couple
    the rows."""
    names = list(w)
    leaves = [w[n].detach().requires_grad_(True) for n in names]
    live = dict(zip(names, leaves))
    count = y.numel()
    total, acc = 0.0, None
    for i in range(0, x.shape[0], rows_per_block):
        part = loss_sum(live, x[i:i + rows_per_block],
                        y[i:i + rows_per_block]) / count
        g = torch.autograd.grad(part, leaves, allow_unused=True)
        g = [torch.zeros_like(a) if b is None else b
             for a, b in zip(leaves, g)]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        total += float(part.detach())
    return total, dict(zip(names, acc))


def clip_global(g: Dict[str, torch.Tensor], clip) -> Dict[str, torch.Tensor]:
    if clip is None:
        return g
    sq = sum(torch.sum(a * a) for a in g.values())
    scale = torch.clamp_max(clip / (torch.sqrt(sq) + 1e-12), 1.0)
    return {k: a * scale for k, a in g.items()}


def init_state(method: dict, w: Dict[str, torch.Tensor]) -> dict:
    zeros = {k: torch.zeros_like(a) for k, a in w.items()}
    if method["name"] == "SGD":
        return {"velocity": zeros, "t": 0}
    return {"m": zeros, "v": {k: torch.zeros_like(a) for k, a in w.items()},
            "t": 0}


def step(method: dict, w, g, state):
    """One update; returns (new weights, new state)."""
    a = method["args"]
    t = state["t"] + 1
    if method["name"] == "SGD":
        lr, wd, mom = a["learningrate"], a["weightdecay"], a["momentum"]
        damp = a.get("dampening", mom)
        new_w, vel = {}, {}
        for k in w:
            gg = g[k] + wd * w[k] if wd > 0 else g[k]
            vel[k] = mom * state["velocity"][k] + (1.0 - damp) * gg
            new_w[k] = w[k] - lr * vel[k]
        return new_w, {"velocity": vel, "t": t}
    if method["name"] == "Adam":
        lr = a["learningrate"]
        b1, b2 = a.get("beta1", 0.9), a.get("beta2", 0.999)
        eps = a.get("epsilon", 1e-8)
        m = {k: b1 * state["m"][k] + (1 - b1) * g[k] for k in w}
        v = {k: b2 * state["v"][k] + (1 - b2) * g[k] * g[k] for k in w}
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        new_w = {k: w[k] - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                 for k in w}
        return new_w, {"m": m, "v": v, "t": t}
    raise ValueError(f"no plain update for {method['name']!r}")


def run_steps(loss_sum: Callable, w0: Dict[str, torch.Tensor],
              batches: List[tuple], method: dict, clip,
              rows_per_block: int) -> dict:
    """The reference's first steps from ``w0`` over ``batches``
    ((x, 0-based y) each): each step's loss, the first step's gradient
    after the clip (what the update is handed), and the final
    weights."""
    w = {k: a.detach().float() for k, a in w0.items()}
    state = init_state(method, w)
    losses, first = [], None
    for x, y in batches:
        loss, g = grads(loss_sum, w, x, y, rows_per_block)
        g = clip_global(g, clip)
        if first is None:
            first = g
        with torch.no_grad():
            w, state = step(method, w, g, state)
        losses.append(loss)
    return {"losses": losses, "grad": first, "weights": w}
