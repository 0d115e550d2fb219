"""LocalOptimizer: the single-device training loop, with validation.

Counterpart of ``bigdl_tpu/optim/optimizer.py``: ``_GradClipper``
(:38), the fluent setters of ``BaseOptimizer`` (:139-211), its
checkpoints (``set_checkpoint`` :155, ``_checkpoint`` :247,
``_topology``, ``_checkpoint_extra`` :327), ``_run_validation`` (:454),
``LocalOptimizer`` (:491) and the ``Optimizer`` factory (:1173), which
gives a ``DistriOptimizer`` for ``distributed=True``.  One step is

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
behind, so the host queues the next step before it waits, unless a
trigger reads ``state["loss"]`` (``needs_loss``; a trigger that does
not say is taken to read it): then each step's loss is read before the
triggers are asked, as JAX's ``sync_per_step`` does.

Validation (``set_validation``) runs when its trigger fires after a
step and again at the end of an epoch (JAX :1079-1090, :1121-1129),
after the pending losses are read: ``evaluate_dataset`` over the live
parameters on the trainer's device, the first method's value into
``state["score"]``, and a ``Plateau`` schedule told the score (its
scale goes into the optimizer state's ``lr_scale``); then the model
goes back to training mode.

The parameters are taken in the JAX package's leaf order
(``utils/tree.py``), so a per-parameter optimizer state (``velocity``)
is a list in that order and checkpoints under the JAX package's keys.
Checkpoints (``set_checkpoint``) are written synchronously when their
trigger fires after a step or at an epoch's end, with ``epoch``,
``neval``, ``epoch_neval0`` (the neval of the epoch's first batch) and
the topology (``"tree"``); a resume from a mid-epoch checkpoint skips
``neval - epoch_neval0`` batches of the next epoch
(``_pending_fast_forward``), so it trains the batches the uninterrupted
run would.

The input feed (``dataset/prefetch.py``): a producer thread pulls the
dataset's batches (decoding an image folder there) and, for a CUDA
trainer, pins each one; the step copies it with ``non_blocking=True``.
``feed_stats`` holds how many batches the loop waited for and for how
long.

The port updates the model's parameters in place (the JAX step returns
new arrays and writes them back at the end): the model holds the
trained weights after every step.  The summary writers, observability
and background checkpoint writes are not ported yet; a train summary
here is any object with ``add_scalar(tag, value, step)``, given the
"Loss" and "Throughput" scalars of each step, and a validation summary
gets each method's value at the ``neval`` of its validation.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import fold_in, resolve_device
from bigdl_tpu_torch.config import TrainConfig
from bigdl_tpu_torch.dataset import to_dataset
from bigdl_tpu_torch.dataset.prefetch import PrefetchIterator, to_host_tensor
from bigdl_tpu_torch.optim.evaluator import evaluate_dataset
from bigdl_tpu_torch.optim.optim_method import SGD, Plateau
from bigdl_tpu_torch.optim.triggers import Trigger
# the error moved to resilience/retry.py; this name stays importable
from bigdl_tpu_torch.resilience.retry import NonFiniteStepError
from bigdl_tpu_torch.utils import tree as T

log = logging.getLogger("bigdl_tpu_torch.optim")
# the base of the per-step dropout seeds (JAX ``jax.random.key(1234)``)
DROPOUT_BASE_SEED = 1234


class _GradClipper:
    """Constant clipping, then global L2-norm clipping, of the gradient
    list."""

    def __init__(self):
        self.l2_norm_clip: Optional[float] = None
        self.const_clip: Optional[tuple] = None

    def __call__(self, grads, global_sq=None):
        """``global_sq``: the squared norm over every rank's shard
        (``DistriOptimizer``, taken before the constant clip, as JAX's
        ``global_sq_norm``); else the norm of ``grads``."""
        g = grads
        if self.const_clip is not None:
            lo, hi = self.const_clip
            g = [torch.clamp(a, lo, hi) for a in g]
        if self.l2_norm_clip is not None:
            sq = global_sq if global_sq is not None else sum(
                torch.sum(a * a) for a in g)
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
        self.val_summary = None
        self.validation_trigger = None
        self.validation_dataset = None
        self.validation_methods = None
        self.compute_dtype = None
        self.checkpoint_path = None
        self.checkpoint_trigger = None
        self.checkpoint_keep_last = 0
        self.max_retry = 5
        self._clipper = _GradClipper()
        self._nonfinite_consec = 0
        # batches to skip at the next epoch's start: a resume from a
        # mid-epoch checkpoint replays from the batch its neval expects
        self._pending_fast_forward = 0
        # (batches waited for, seconds waited, batches) of the last epoch
        self.feed_stats = (0, 0.0, 0)
        # the reference's state table; neval is the next iteration,
        # epoch_neval0 the neval of the current epoch's first batch
        self.state = {"epoch": 1, "neval": 1, "loss": None, "score": None,
                      "epoch_finished": 0, "nonfinite_skips": 0,
                      "epoch_neval0": 1}

    # ---- fluent setters (reference spellings below) ---------------------
    def set_optim_method(self, method):
        self.optim_method = method
        return self

    def set_end_when(self, trigger):
        self.end_when = trigger
        return self

    def set_validation(self, trigger=None, dataset=None, methods=None,
                       batch_size=None):
        """Validate with ``methods`` over ``dataset`` (a ``DataSet`` or
        an ``(x, y)`` tuple, batched by ``batch_size`` or the training
        batch size) whenever ``trigger`` fires."""
        self.validation_trigger = trigger
        self.validation_dataset = to_dataset(dataset,
                                             batch_size or self.batch_size)
        self.validation_methods = methods
        return self

    def set_checkpoint(self, path, trigger=None, background=None,
                       keep_last=None):
        """Write a checkpoint into directory ``path`` whenever
        ``trigger`` (default every epoch) fires, keeping the newest
        ``keep_last`` pairs (default ``BIGDL_TORCH_CHECKPOINT_KEEP_LAST``,
        0 = all).  Writes are synchronous; ``background=True`` is not
        ported yet and raises."""
        if background:
            raise NotImplementedError(
                "background checkpoint writes are not ported yet "
                "(ROADMAP.md queue 1 item 4)")
        os.makedirs(path, exist_ok=True)
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger or Trigger.every_epoch()
        self.checkpoint_keep_last = (
            TrainConfig.from_env().checkpoint_keep_last
            if keep_last is None else int(keep_last))
        return self

    def set_train_summary(self, summary):
        self.train_summary = summary
        return self

    def set_val_summary(self, summary):
        self.val_summary = summary
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
    setValidation = set_validation
    setCheckpoint = set_checkpoint
    setTrainSummary = set_train_summary
    setValSummary = set_val_summary
    setGradientClippingByL2Norm = set_gradient_clipping_by_l2_norm
    setConstantGradientClipping = set_constant_gradient_clipping

    # ---- one step --------------------------------------------------------
    def _loss(self, names, params, inp, tgt, seed):
        """The f32 loss of one batch, differentiable in ``params``;
        ``seed`` is the step's dropout seed."""
        return self.criterion.loss(self._output(names, params, inp, seed),
                                   tgt)

    def _output(self, names, params, inp, seed):
        """The model's output on one batch, floating outputs in f32,
        under the compute dtype (the JAX ``_cast_for_compute``)."""
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
        return out.float() if out.is_floating_point() else out

    def _train_step(self, names, params, opt_state, inp, tgt, mask, guard,
                    seed):
        """One step; returns (new opt_state, loss, ok), both device
        tensors, after writing params and BN state in place.  ``mask``
        is ``_prepare_batch``'s, ``None`` for this trainer."""
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

    def _run_validation(self):
        """Validate on the live parameters; returns the results."""
        if self.validation_dataset is None or not self.validation_methods:
            return None
        results = self._evaluate()
        for method, res in zip(self.validation_methods, results):
            value, _ = res.result()
            log.info("validation %s: %.6f", method.name, value)
            if self.val_summary is not None:
                self.val_summary.add_scalar(method.name, value,
                                            self.state["neval"])
        # the first method's value is the score Trigger.max_score reads
        self.state["score"] = results[0].result()[0]
        opt = self.optim_method
        sched = getattr(opt, "learningrate_schedule", None)
        if isinstance(sched, Plateau):
            scale = sched.on_score(self.state["score"], opt.learningrate)
            if opt.state is not None:
                opt.state["lr_scale"] = torch.tensor(
                    scale, dtype=torch.float32, device=self.device)
        return results

    def _evaluate(self):
        return evaluate_dataset(self.model, self.validation_dataset,
                                self.validation_methods, self.device)

    # ---- checkpoints -------------------------------------------------------
    def _topology(self) -> dict:
        """How the optimizer state of a checkpoint is laid out: local
        training keeps one entry per parameter tree leaf."""
        return {"world_size": 1, "shard_layout": "tree",
                "step": self.state["neval"]}

    def _checkpoint_extra(self) -> dict:
        """What a resume needs beyond the arrays."""
        return {"epoch": self.state["epoch"], "neval": self.state["neval"],
                "epoch_neval0": self.state.get("epoch_neval0",
                                               self.state["neval"]),
                "topology": self._topology()}

    def _checkpoint(self, method=None) -> None:
        """Write ``checkpoint_<epoch>_<neval>`` with ``method``'s state
        (the live optimizer method by default)."""
        if not self.checkpoint_path:
            return
        from bigdl_tpu_torch.utils.serializer import save_checkpoint

        tag = f"{self.state['epoch']}_{self.state['neval']}"
        prefix = os.path.join(self.checkpoint_path, f"checkpoint_{tag}")
        save_checkpoint(prefix, self.model, method or self.optim_method,
                        self._checkpoint_extra(),
                        keep_last=self.checkpoint_keep_last)
        log.info("checkpoint saved at epoch %s iter %s", self.state["epoch"],
                 self.state["neval"])

    # ---- parameters, optimizer state and the input feed -----------------
    def _param_leaves(self):
        """(torch names, parameters, parameter tree of list positions),
        the parameters in the JAX package's leaf order."""
        pairs = T.leaves_with_paths(self.model.params())
        by_id = {id(p): n for n, p in self.model.named_parameters()}
        params = [p for _, p in pairs]
        ids = {id(p) for p in params}
        if len(ids) != len(params):
            raise ValueError("a parameter appears twice in the model's "
                             "parameter tree")
        missing = [n for n, p in self.model.named_parameters()
                   if p.requires_grad and id(p) not in ids]
        if missing:
            raise ValueError(f"parameters outside the model's params() "
                             f"tree: {missing}")
        names = [by_id[id(p)] for p in params]
        tree = T.unflatten([(path, i) for i, (path, _) in enumerate(pairs)]
                           + [(path, {}) for path in
                              T.empty_paths(self.model.params())])
        return names, params, tree

    def _init_opt_state(self, params, tree) -> None:
        """A fresh state, or a loaded one (a checkpoint's nested dicts)
        turned into this trainer's per-parameter lists on its device."""
        opt = self.optim_method
        opt.param_tree = tree
        if opt.state is None:
            opt.state = opt.init_state([p.detach() for p in params])
            return
        topo = getattr(opt, "loaded_topology", None) or {}
        if topo.get("shard_layout", "tree") != "tree":
            raise NotImplementedError(
                f"the optimizer state was written by a "
                f"{topo.get('shard_layout')!r} trainer; a LocalOptimizer "
                "resumes only from a tree state (ROADMAP.md queue 1 item 6)")
        paths = [path for path, _ in T.leaves_with_paths(tree)]

        def at(node, path):
            for k in path:
                node = node[k]
            return node

        state = {}
        for k, v in opt.state.items():
            if isinstance(v, dict):
                v = [at(v, path) for path in paths]
            if isinstance(v, (list, tuple)):
                state[k] = [torch.as_tensor(a).to(self.device, p.dtype)
                            for a, p in zip(v, params)]
            else:
                state[k] = torch.as_tensor(v).to(self.device)
        opt.state = state

    def _prepare_batch(self, inp, tgt):
        """A host batch as (input, target, mask) for this trainer; runs
        on the feed's thread.  The mask (``None`` here) marks padded
        rows in a sharded trainer."""
        return inp, tgt, None

    def _host_batches(self, pin: bool):
        """The epoch's training batches as CPU tensors (pinned when
        ``pin``), each with its mask and its record count."""
        for inp, tgt in self.dataset.data(train=True):
            n = int(np.asarray(inp).shape[0])
            inp, tgt, mask = self._prepare_batch(inp, tgt)
            yield (to_host_tensor(inp, pin), to_host_tensor(tgt, pin),
                   to_host_tensor(mask, pin), n)

    def _put_batch(self, inp, tgt, mask):
        """The batch (input, target, mask or ``None``) on the trainer's
        device: an asynchronous copy from pinned memory, else a blocking
        one."""
        return tuple(None if t is None else
                     t.to(self.device, non_blocking=t.is_pinned())
                     for t in (inp, tgt, mask))

    # ---- the loop ----------------------------------------------------------
    def optimize(self):
        cfg = TrainConfig.from_env()
        model = self.model
        model.train()
        names, params, tree = self._param_leaves()
        self._init_opt_state(params, tree)
        opt = self.optim_method
        self._nonfinite_consec = 0
        pending = []        # (n, loss, ok, batch size, dispatch time)
        val_trigger = self.validation_trigger
        sync_per_step = any(getattr(t, "needs_loss", True)
                            for t in (self.end_when, val_trigger)
                            if t is not None)

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

        ckpt_trigger = self.checkpoint_trigger
        pin = self.device.type == "cuda"
        stop = False
        while not stop:
            epoch = self.state["epoch"]
            t_epoch = time.time()
            finished = True
            feed = PrefetchIterator(self._host_batches(pin))
            batches = iter(feed)
            try:
                skip, self._pending_fast_forward = \
                    self._pending_fast_forward, 0
                if skip > 0:
                    log.info("mid-epoch resume: skipping %d batches to "
                             "iter %d", skip, self.state["neval"])
                for _ in range(skip):
                    if next(batches, None) is None:
                        break
                for inp, tgt, mask, records in batches:
                    n = self.state["neval"]
                    t0 = time.perf_counter()
                    inp_d, tgt_d, mask_d = self._put_batch(inp, tgt, mask)
                    opt.state, loss, ok = self._train_step(
                        names, params, opt.state, inp_d, tgt_d, mask_d,
                        cfg.nonfinite_guard, fold_in(DROPOUT_BASE_SEED, n))
                    # read the previous step's loss while this one runs
                    flush()
                    pending.append((n, loss, ok, records, t0))
                    if sync_per_step:
                        flush()
                    self.state["neval"] = n + 1
                    if val_trigger is not None and val_trigger(self.state):
                        flush()
                        self._run_validation()
                        model.train()
                    if ckpt_trigger is not None and ckpt_trigger(self.state):
                        flush()
                        self._checkpoint()
                    if self.end_when(self.state):
                        stop, finished = True, False
                        break
            finally:
                feed.close()
                self.feed_stats = (feed.waits, feed.wait_s, feed.items)
            flush()
            if finished:
                self.state["epoch_finished"] = epoch
                self.state["epoch"] = epoch + 1
                # the next epoch's first batch runs at the current neval
                self.state["epoch_neval0"] = self.state["neval"]
                opt.state["epoch"] = opt.state["epoch"] + 1.0
                log.info("Epoch %d done in %.1fs", epoch,
                         time.time() - t_epoch)
                if val_trigger is not None and val_trigger(self.state):
                    self._run_validation()
                    model.train()
                if ckpt_trigger is not None and ckpt_trigger(self.state):
                    self._checkpoint()
                if self.end_when(self.state):
                    stop = True
        self._publish_optim_state()
        model.evaluate()
        return model

    def _publish_optim_state(self) -> None:
        """Leave ``optim_method.state`` whole after a run (a sharded
        trainer gathers it)."""


def Optimizer(model=None, training_set=None, criterion=None,
              batch_size: int = 32, training_rdd=None, x=None, y=None,
              end_trigger=None, optim_method=None, distributed=None,
              device="cuda"):
    """Factory (JAX :1173) over ``training_set`` (or ``training_rdd``,
    or ``(x, y)``): a ``DistriOptimizer`` for ``distributed=True`` or,
    when ``distributed`` is None, for a per-process dataset (the
    reference dispatches on the dataset's type); else a
    ``LocalOptimizer``.  The JAX package also promotes on seeing more
    than one device; here one process drives one GPU, so the process
    group's size is what counts and a per-process dataset says so."""
    data = training_set if training_set is not None else training_rdd
    if data is None and x is not None:
        data = (x, y)
    ds = to_dataset(data, batch_size)
    if distributed is None:
        distributed = bool(getattr(ds, "per_process", False))
    if distributed:
        from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer

        opt = DistriOptimizer(model, ds, criterion, batch_size,
                              device=device)
    else:
        opt = LocalOptimizer(model, ds, criterion, batch_size, device=device)
    if optim_method is not None:
        opt.set_optim_method(optim_method)
    if end_trigger is not None:
        opt.set_end_when(end_trigger)
    return opt


__all__ = ["LocalOptimizer", "NonFiniteStepError", "Optimizer"]
