"""Training driver: one ``LocalOptimizer`` from the seed, driven through
``optimize()`` by a trigger of the benchmark's own.

The trigger (``needs_loss`` False, so the trainer still reads each loss
one step behind) runs the phases of one ``optimize()`` call:

1. steps 1-3 are the check's: after step 1 it reads the gradient the
   update was handed back out of the optimizer's state, after step 3
   each parameter's change since the start;
2. up to step ``warmup`` every shape of the cell has run once; the device
   is synchronised and the window starts (``setup_s`` ends here);
3. the window: every step dispatched until ``--seconds`` have passed,
   then a synchronise; the rate is all those samples over all that time;
4. with ``--trace 1`` only, ``profile_steps`` more steps under
   ``torch.profiler``, then the trainer stops.

The reference then follows steps 1-3 from the same weights on the same
batches (batches 0-2 of the pool: the feed does not shuffle, the pool is
in an order drawn from the seed).
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import compare, harness, traffic, weights


class _Losses:
    """The trainer's summary sink: each step's loss, by step."""

    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[int(step)] = float(value)


class _Phases:
    needs_loss = False

    def __init__(self, run, opt, names, start, warmup, profile_steps):
        self.run, self.opt, self.names = run, opt, names
        self.start = start                 # the parameters at step 0
        self.warmup = int(warmup)
        self.profile_steps = int(profile_steps)
        self.phase = "setup"
        self.grad_norms = self.change_norms = None
        self.dispatch = []
        self.prof = None

    def _leaves(self):
        names, params, _ = self.opt._param_leaves()
        return [self.names[id(p)] for p in params], params

    def _first_grad(self):
        """The gradient step 1 handed the update, from the state it
        left: SGD's velocity is (1 - dampening)·(g + wd·w0), Adam's m is
        (1 - β1)·g."""
        m = self.opt.optim_method
        st = m.state
        if "velocity" in st:
            return [v / (1.0 - m.dampening) - m.weightdecay * w
                    for v, w in zip(st["velocity"], self.start)]
        return [a / (1.0 - m.beta1) for a in st["m"]]

    def __call__(self, state):
        n = state["neval"] - 1                     # the step just dispatched
        run, dev = self.run, self.run.device
        if n == 1:
            names, _ = self._leaves()
            self.grad_norms = dict(zip(names, torch.stack(
                [g.float().norm() for g in self._first_grad()]).tolist()))
        if n == 3:
            names, params = self._leaves()
            self.change_norms = dict(zip(names, torch.stack(
                [(p.detach() - w).float().norm()
                 for p, w in zip(params, self.start)]).tolist()))
            self.start = None
        if self.phase == "setup" and n >= max(3, self.warmup):
            harness.sync(dev)
            self.t_win = time.perf_counter()
            self.n_win = n
            self.fed = self._fed()
            self.dispatch = []
            self.phase = "window"
            return False
        if self.phase == "window" and \
                time.perf_counter() - self.t_win >= run.seconds:
            harness.sync(dev)
            self.t_end = time.perf_counter()
            self.n_end = n
            self.fed_end = self._fed()
            self.window_dispatch = list(self.dispatch)
            if not run.trace:
                return True
            self.phase = "profile"
            self.prof = harness.profiled(dev)
            self.t_prof = time.perf_counter()
            return False
        if self.phase == "profile" and n >= self.n_end + self.profile_steps:
            harness.sync(dev)
            window = time.perf_counter() - self.t_prof
            self.prof.stop()
            run.profile = harness.Profile(self.prof, window)
            run.record["profile_steps"] = self.profile_steps
            return True
        return False

    def _fed(self) -> float:
        """Seconds the trainer has waited for its feed so far."""
        return self.opt.metrics.total("data wait time")

    def timed(self, step):
        def call(*a, **k):
            t = time.perf_counter()
            out = step(*a, **k)
            self.dispatch.append(time.perf_counter() - t)
            return out
        return call


def _method(spec: dict):
    from bigdl_tpu_torch import optim

    return getattr(optim, spec["name"])(**spec["args"])


def drive(run) -> None:
    from bigdl_tpu_torch.dataset.dataset import ArrayDataSet
    from bigdl_tpu_torch.optim import LocalOptimizer

    cfg, mix, dev = run.config, run.cell["traffic"], run.device
    ref, fam = run.reference, run.family
    train = cfg["train"]
    batch = int(mix["batch"])
    model = fam.build(cfg, dev)
    names = fam.load(model, weights.make(ref.weight_specs(cfg), run.seed,
                                         dev), ref, cfg)
    x, y = traffic.train_pool(mix, cfg, run.seed, dev)
    opt = LocalOptimizer(model, ArrayDataSet(x, y, batch, shuffle=False),
                         fam.criterion(cfg), batch_size=batch, device=dev)
    opt.set_optim_method(_method(train["optim"]))
    if cfg.get("compute_dtype") != "float32":
        opt.set_compute_dtype(cfg["compute_dtype"])
    if train.get("clip_l2") is not None:
        opt.set_gradient_clipping_by_l2_norm(train["clip_l2"])
    losses = _Losses()
    opt.set_train_summary(losses)
    _, params, _ = opt._param_leaves()
    phases = _Phases(run, opt, names, [p.detach().clone() for p in params],
                     mix["warmup_steps"], mix["profile_steps"])
    opt._train_step = phases.timed(opt._train_step)
    opt.set_end_when(phases)
    opt.optimize()
    harness.sync(dev)
    run.read_peak()

    steps = phases.n_end - phases.n_win
    rows = steps * batch
    run.record.update(
        setup_s=phases.t_win - run.t0, window_s=phases.t_end - phases.t_win,
        steps=steps, samples=rows,
        tokens=rows * traffic.tokens_per_row(mix),
        dispatch_s=phases.window_dispatch,
        data_wait_s=phases.fed_end - phases.fed)
    run.attempted = steps
    skipped = [k for k in range(phases.n_win + 1, phases.n_end + 1)
               if not math.isfinite(losses.loss.get(k, math.nan))]
    run.failed = len(skipped)

    program = {"losses": [losses.loss.get(k, float("nan")) for k in (1, 2, 3)],
               "grad_norms": phases.grad_norms,
               "change_norms": phases.change_norms}
    del opt, model, params, phases, names
    run.free_device()
    check_against_reference(run, program, x, y)


def check_against_reference(run, program: dict, x, y) -> None:
    """Steps 1-3 of the plain reference from the same weights on the same
    three batches, in float32 with TF32 off; the numbers the cell's
    limits name go to ``run.checks``."""
    w0 = weights.make(run.reference.weight_specs(run.config), run.seed,
                      run.device)
    out = reference_steps(run, w0, first_batches(run, x, y))
    readings = compare.train_readings(program, out, w0)
    run.record["readings"] = {k: v for k, (v, _) in readings.items()}
    for name in run.cell["limits"]:
        value, where = readings[name]
        run.checks[name] = (value, run.limit(name))
        run.record.setdefault("worst", {})[name] = where


def first_batches(run, x, y) -> list:
    """Batches 0-2 of the pool on the device, targets 0-based."""
    mix, dev = run.cell["traffic"], run.device
    batch = int(mix["batch"])
    out = []
    for k in range(3):
        xb = torch.as_tensor(x[k * batch:(k + 1) * batch], device=dev)
        yb = torch.as_tensor(y[k * batch:(k + 1) * batch], device=dev)
        out.append((xb.long() if mix["rows"] == "tokens" else xb,
                    yb.long() - 1))
    return out


def reference_steps(run, w0, batches, quant=None) -> dict:
    """The plain reference's steps 1-3 (``reference.optim.run_steps``)
    in float32 with TF32 off, or with ``quant`` in a lower precision."""
    from benchmark.reference import optim as ref_optim

    cfg, mix = run.config, run.cell["traffic"]
    ref_optim.no_tf32()
    rows = max(1, int(mix.get("reference_rows", mix["batch"])))

    def loss_sum(w, xb, yb):
        return run.reference.loss_sum(w, xb, yb, cfg, quant)

    return ref_optim.run_steps(loss_sum, w0, batches, cfg["train"]["optim"],
                               cfg["train"].get("clip_l2"), rows)
