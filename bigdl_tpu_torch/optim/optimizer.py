"""LocalOptimizer: the single-device training loop.

Counterpart of ``bigdl_tpu/optim/optimizer.py``: ``_GradClipper``
(:38), the fluent setters of ``BaseOptimizer`` (:139-211) and
``LocalOptimizer`` (:491).  One step is

    loss, grads = autograd of criterion(model(x), y)
    grads -> clipper -> optim_method.step -> non-finite guard

with f32 master parameters.  Under ``set_compute_dtype("bfloat16")``
every floating parameter and the input are cast to bf16 *inside* the
differentiated function (``torch.func.functional_call`` with cast
copies, JAX ``_cast_for_compute`` :515), so the gradients land in f32;
the loss is taken in f32 (JAX ``_loss_fn`` :532).  A model with
``takes_rng_seed`` gets step n's dropout seed ``fold_in(1234, n)``, as
JAX derives ``fold_in(key(1234), n)`` (:717, :1034).

The non-finite guard (on by default, ``BIGDL_TORCH_NONFINITE_GUARD``)
keeps params, optimizer state and BN state as they were when the loss
or a gradient is NaN or inf, on the device without a host round trip,
and the loop counts the skip; ``max_nonfinite_skips`` consecutive
skips raise ``NonFiniteStepError``.  The loss is read back one step
behind, so the host queues the next step before it waits.

The port updates the model's parameters in place (the JAX step returns
new arrays and writes them back at the end): the model holds the
trained weights after every step.  Checkpoints, validation, the summary
writers, observability and the input prefetcher are not ported yet; a
train summary here is any object with ``add_scalar(tag, value, step)``,
given the "Loss" and "Throughput" scalars of each step.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import fold_in, resolve_device
from bigdl_tpu_torch.config import TrainConfig
from bigdl_tpu_torch.dataset import to_dataset
from bigdl_tpu_torch.optim.optim_method import SGD
from bigdl_tpu_torch.optim.triggers import Trigger

log = logging.getLogger("bigdl_tpu_torch.optim")
# the base of the per-step dropout seeds (JAX ``jax.random.key(1234)``)
DROPOUT_BASE_SEED = 1234


class NonFiniteStepError(RuntimeError):
    """Too many consecutive training steps with a non-finite loss or
    gradient."""


class _GradClipper:
    """Constant clipping, then global L2-norm clipping, of the gradient
    list."""

    def __init__(self):
        self.l2_norm_clip: Optional[float] = None
        self.const_clip: Optional[tuple] = None

    def __call__(self, grads):
        g = grads
        if self.const_clip is not None:
            lo, hi = self.const_clip
            g = [torch.clamp(a, lo, hi) for a in g]
        if self.l2_norm_clip is not None:
            sq = sum(torch.sum(a * a) for a in g)
            scale = torch.clamp_max(self.l2_norm_clip / (torch.sqrt(sq)
                                                          + 1e-12), 1.0)
            g = [a * scale for a in g]
        return g


def _where(ok, new, old):
    """The new tree where ``ok`` (a device bool), else the old one."""
    if isinstance(new, dict):
        return {k: _where(ok, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return [_where(ok, a, b) for a, b in zip(new, old)]
    return torch.where(ok, new, old)


class LocalOptimizer:
    """Single-device trainer (JAX ``LocalOptimizer``).

    ``model`` is moved to ``device`` (default the card; raises without
    CUDA unless ``device="cpu"``).  ``dataset`` is a ``DataSet`` or an
    ``(x, y)`` tuple of numpy arrays."""

    def __init__(self, model, dataset, criterion, batch_size: int = 32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dataset = to_dataset(dataset, batch_size)
        self.criterion = criterion
        self.batch_size = batch_size
        self.optim_method = SGD()
        self.end_when = Trigger.max_epoch(1)
        self.train_summary = None
        self.compute_dtype = None
        self._clipper = _GradClipper()
        self._nonfinite_consec = 0
        # the reference's state table; neval is the next iteration
        self.state = {"epoch": 1, "neval": 1, "loss": None,
                      "epoch_finished": 0, "nonfinite_skips": 0}

    # ---- fluent setters (reference spellings below) ---------------------
    def set_optim_method(self, method):
        self.optim_method = method
        return self

    def set_end_when(self, trigger):
        self.end_when = trigger
        return self

    def set_train_summary(self, summary):
        self.train_summary = summary
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        self._clipper.l2_norm_clip = clip_norm
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        self._clipper.const_clip = (min_value, max_value)
        return self

    def disable_gradient_clipping(self):
        self._clipper.l2_norm_clip = None
        self._clipper.const_clip = None
        return self

    def set_compute_dtype(self, dtype):
        """Mixed precision: ``"bfloat16"`` (or a torch dtype) runs the
        forward and backward in that dtype while the master params, the
        gradients, the loss and the update stay f32.  ``None``
        disables."""
        self.compute_dtype = getattr(torch, dtype) \
            if isinstance(dtype, str) else dtype
        return self

    setOptimMethod = set_optim_method
    setEndWhen = set_end_when
    setTrainSummary = set_train_summary
    setGradientClippingByL2Norm = set_gradient_clipping_by_l2_norm
    setConstantGradientClipping = set_constant_gradient_clipping

    # ---- one step --------------------------------------------------------
    def _loss(self, names, params, inp, tgt, seed):
        """The f32 loss of one batch, differentiable in ``params``;
        ``seed`` is the step's dropout seed."""
        ct = self.compute_dtype
        kw = {"rng_seed": seed} if self.model.takes_rng_seed else {}
        if ct is None:
            out = self.model(inp, **kw)
        else:
            cast = {n: p.to(ct) if p.is_floating_point() else p
                    for n, p in zip(names, params)}
            out = torch.func.functional_call(
                self.model, cast, (inp.to(ct) if inp.is_floating_point()
                                   else inp,), kw)
        out = out.float() if out.is_floating_point() else out
        return self.criterion.loss(out, tgt)

    def _train_step(self, names, params, opt_state, inp, tgt, guard, seed):
        """One step; returns (new opt_state, loss, ok), both device
        tensors, after writing params and BN state in place."""
        mstate = self.model.state()
        loss = self._loss(names, params, inp, tgt, seed)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        grads = self._clipper(grads)
        with torch.no_grad():
            new_p, new_opt = self.optim_method.step(
                grads, [p.detach() for p in params], opt_state)
            ok = torch.ones((), dtype=torch.bool, device=loss.device)
            if guard:
                ok = torch.isfinite(loss.detach())
                for g in grads:
                    ok = ok & torch.isfinite(g).all()
                new_p = _where(ok, new_p, [p.detach() for p in params])
                new_opt = _where(ok, new_opt, opt_state)
                self.model.set_state(_where(ok, self.model.state(), mstate))
            for p, q in zip(params, new_p):
                p.copy_(q)
        return new_opt, loss.detach(), ok

    # ---- the loop ----------------------------------------------------------
    def optimize(self):
        cfg = TrainConfig.from_env()
        model = self.model
        model.train()
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        names = [n for n, _ in named]
        params = [p for _, p in named]
        opt = self.optim_method
        if opt.state is None:
            opt.state = opt.init_state([p.detach() for p in params])
        self._nonfinite_consec = 0
        pending = []        # (n, loss, ok, batch size, dispatch time)

        def resolve(n, loss_dev, ok_dev, bs, t0):
            loss_val = float(loss_dev)
            self.state["loss"] = loss_val
            if self.train_summary is not None:
                self.train_summary.add_scalar("Loss", loss_val, n)
                self.train_summary.add_scalar(
                    "Throughput", bs / max(1e-9, time.perf_counter() - t0),
                    n)
            if bool(ok_dev):
                self._nonfinite_consec = 0
                return
            self.state["nonfinite_skips"] += 1
            self._nonfinite_consec += 1
            log.warning("non-finite grads/loss at iter %d (loss=%r): update "
                        "skipped (%d consecutive, %d total)", n, loss_val,
                        self._nonfinite_consec,
                        self.state["nonfinite_skips"])
            if self._nonfinite_consec >= cfg.max_nonfinite_skips:
                raise NonFiniteStepError(
                    f"{self._nonfinite_consec} consecutive non-finite "
                    f"training steps (iter {n})")

        def flush():
            while pending:
                resolve(*pending.pop(0))

        stop = False
        while not stop:
            epoch = self.state["epoch"]
            t_epoch = time.time()
            finished = True
            for inp, tgt in self.dataset.data(train=True):
                n = self.state["neval"]
                t0 = time.perf_counter()
                inp_d = torch.as_tensor(np.asarray(inp), device=self.device)
                tgt_d = torch.as_tensor(np.asarray(tgt), device=self.device)
                opt.state, loss, ok = self._train_step(
                    names, params, opt.state, inp_d, tgt_d,
                    cfg.nonfinite_guard, fold_in(DROPOUT_BASE_SEED, n))
                # read the previous step's loss while this one runs
                flush()
                pending.append((n, loss, ok, int(inp_d.shape[0]), t0))
                self.state["neval"] = n + 1
                if self.end_when(self.state):
                    stop, finished = True, False
                    break
            flush()
            if finished:
                self.state["epoch_finished"] = epoch
                self.state["epoch"] = epoch + 1
                opt.state["epoch"] = opt.state["epoch"] + 1.0
                log.info("Epoch %d done in %.1fs", epoch,
                         time.time() - t_epoch)
                if self.end_when(self.state):
                    stop = True
        model.evaluate()
        return model


__all__ = ["LocalOptimizer", "NonFiniteStepError"]
