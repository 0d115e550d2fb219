"""LocalOptimizer: the single-device training loop, with validation.

Counterpart of ``bigdl_tpu/optim/optimizer.py``: ``_GradClipper``
(:38), the fluent setters of ``BaseOptimizer`` (:139-211), its
checkpoints (``set_checkpoint`` :155-183, ``_raise_pending_ckpt_error``
:231, ``_checkpoint`` :247, ``_flush_checkpoints`` :286, ``_topology``,
``_checkpoint_extra`` :327), ``_summary_resilience`` (:224),
``_run_validation`` (:454), ``LocalOptimizer`` (:491) with its
parameter histograms (:1162) and the ``Optimizer`` factory (:1173),
which gives a ``DistriOptimizer`` for ``distributed=True``.  One step
is

    loss, grads = autograd of criterion(model(x), y)
                  + model.regularization_loss()
    grads -> freeze mask -> clipper -> optim_method.step
          -> frozen parameters kept -> non-finite guard

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
Checkpoints (``set_checkpoint``) are written when their trigger fires
after a step or at an epoch's end, with ``epoch``, ``neval``,
``epoch_neval0`` (the neval of the epoch's first batch), the topology
(``"tree"``) and, for a stream, its trained frontier; a resume from a
mid-epoch checkpoint skips ``neval - epoch_neval0`` batches of the next
epoch (``_pending_fast_forward``), so it trains the batches the
uninterrupted run would.  With ``background=True`` the loop only
snapshots every array to the host (``snapshot_checkpoint(to_host=
True)``, finished before it returns, since the parameters change in
place) and one writer thread serializes, fsyncs and writes the
manifest; at most one write is in flight (the next trigger waits for
it).  A failed background write is counted
(``checkpoint_write_failures``, ``bigdl_checkpoint_write_failures_total``,
the summary's "CheckpointWriteFailures") and raised as
``CheckpointWriteError`` at the next checkpoint, at the end of
``optimize`` or, when the run failed meanwhile, at the next
``optimize``.

Fault injection (``resilience/faults.py``): with a plan set, each step
asks the injector before its batch goes to the device; ``raise``
raises ``InjectedFault`` there, ``nan_grad`` replaces the batch with
NaN.  A stream (``dataset/stream.py``) is told of each dispatched batch
(``note_batch_trained``), so a checkpoint's offset covers exactly the
batches in its weights; the port's trainers drop no batch (a batch the
world does not divide is padded and masked).

The input feed (``dataset/prefetch.py``): a producer thread pulls the
dataset's batches (decoding an image folder there) and, for a CUDA
trainer, pins each one; the step copies it with ``non_blocking=True``.
``feed_stats`` holds how many batches the loop waited for and for how
long.

A frozen module's parameters (``AbstractModule.freeze``) get their
gradients multiplied by 0 before the clipper, so they do not count in
the global norm, and keep their values bit for bit after the update
(JAX :577-603); the optimizer state of them still steps, as there.

``metrics`` (``optim/metrics.py``) times the reference's phases: "data
wait time" (the loop waiting for the feed), "put batch time" (the copy
to the device) and "computing time" (a step's dispatch to its loss
read, JAX :819, :936, :985), logged at each epoch's end.

The port updates the model's parameters in place (the JAX step returns
new arrays and writes them back at the end): the model holds the
trained weights after every step.  A train summary
(``visualization.TrainSummary``, or any object with ``add_scalar``) gets
the "Loss" and "Throughput" scalars of each step, the resilience
counters (``add_resilience``, where it has one) and, when its
"Parameters" trigger fires, a histogram of each parameter tagged by its
JAX leaf path; a validation summary gets each method's value at the
``neval`` of its validation.

Telemetry and resilience at ``optimize()`` (JAX :650-740, :1002-1041):

- the step spans ``iteration``, ``batch_prep`` (on the feed's thread),
  ``device_put`` and ``step_dispatch``, each with its ``step``, and
  ``data_wait`` and ``computing`` recorded after the fact; ``iteration``,
  ``device_put`` and ``step_dispatch`` are ``utils.profiler.annotate``
  regions, so a ``torch.profiler`` trace shows them too;
- inside ``step_dispatch``, one ``annotate`` region a phase of the step,
  in order and without overlap: ``step.forward`` (the BN state read,
  the casts, the forward and the loss), ``step.backward`` (autograd,
  the zero-fill of unused gradients, the frozen mask), ``step.clip``
  (only with a clip set), ``step.update`` (the method and the frozen
  keep), ``step.guard`` (only with the guard on) and ``step.write``
  (the health stats, the write-back); all but the first two carry
  ``tensors``, the number of parameter tensors.  ``loss_read`` (with
  its ``step``) covers the loop's one wait on the device, a loss read
  back;
- ``BIGDL_TORCH_PROFILE=DIR``: a ``torch.profiler`` trace of iterations
  1-20 of each ``optimize`` into DIR (``utils.profiler.StepProfiler``,
  JAX :721-733), stopped in the ``finally`` so a retry never finds one
  running;
- with observability on (``BIGDL_TORCH_TRACE_DIR`` or
  ``BIGDL_TORCH_OBS_PORT``), the runtime profile (``obs/runtime.py``:
  each step's time and its dispatch time) and the slow-step detector
  (``_detect_slow_step``, ``BIGDL_TORCH_SLOW_STEP_FACTOR``);
- the obs server (``BIGDL_TORCH_OBS_PORT``): the phase timers'
  registry on ``/metrics``, and each resolved step stamped for
  ``/healthz`` (``note_step``);
- the goodput ledger (``obs/goodput.py``, on with observability): a
  ``step`` interval where the step's loss resolves (the interval the
  ``computing`` span covers: its batch copy and dispatch to its loss,
  re-tagged ``rework`` under a resume's high-water mark), each
  ``data_wait``, the batch copy's host seconds, each ``eval``; the
  sampling profiler (``BIGDL_TORCH_PROF_HZ``) starts with the loop, and
  ``obs.flush`` writes the run's shards when ``optimize`` ends;
- the health monitor (``obs/health.py``, ``BIGDL_TORCH_HEALTH_EVERY``
  > 0): on every K-th step the per-layer ``(L, 4)`` stats of the
  pre-clip gradient, the parameters and the update, read back when
  that step's loss is; other steps compute none;
- an ``ElasticSession`` (``resilience/elastic.py``): heartbeats at
  world > 1, and a preemption request (SIGTERM) seen at the top of a
  step resolves the steps in flight, writes a synchronous emergency
  checkpoint and raises ``Preempted`` (exit code 170,
  ``_elastic_shutdown``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.common import fold_in, resolve_device
from bigdl_tpu_torch.config import TrainConfig
from bigdl_tpu_torch.dataset import to_dataset
from bigdl_tpu_torch.dataset.prefetch import PrefetchIterator, to_host_tensor
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs.goodput import NULL_LEDGER
from bigdl_tpu_torch.optim.evaluator import evaluate_dataset
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, Plateau
from bigdl_tpu_torch.optim.triggers import Trigger
# the error moved to resilience/retry.py; this name stays importable
from bigdl_tpu_torch.resilience.retry import NonFiniteStepError
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.profiler import StepProfiler, annotate

log = logging.getLogger("bigdl_tpu_torch.optim")
# the base of the per-step dropout seeds (JAX ``jax.random.key(1234)``)
DROPOUT_BASE_SEED = 1234


class _GradClipper:
    """Constant clipping, then global L2-norm clipping, of the gradient
    list."""

    def __init__(self):
        self.l2_norm_clip: Optional[float] = None
        self.const_clip: Optional[tuple] = None

    @property
    def active(self) -> bool:
        """Does a clip change anything (else the gradients pass as they
        are)."""
        return self.l2_norm_clip is not None or self.const_clip is not None

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


class BaseOptimizer:
    """The trainers' shared builder (JAX ``BaseOptimizer``,
    optimizer.py:69): the model, data, criterion and the fluent
    setters."""

    def __init__(self, model, dataset, criterion, batch_size: int = 32):
        self.model = model
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
        self.checkpoint_background = False
        self._clipper = _GradClipper()

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
        0 = all).  ``background=True`` snapshots to the host on the loop
        and writes on one writer thread (default
        ``BIGDL_TORCH_CHECKPOINT_ASYNC``)."""
        cfg = TrainConfig.from_env()
        os.makedirs(path, exist_ok=True)
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger or Trigger.every_epoch()
        self.checkpoint_background = (cfg.checkpoint_async
                                      if background is None
                                      else bool(background))
        self.checkpoint_keep_last = (cfg.checkpoint_keep_last
                                     if keep_last is None
                                     else int(keep_last))
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


class LocalOptimizer(BaseOptimizer):
    """Single-device trainer (JAX ``LocalOptimizer``).

    ``model`` is moved to ``device`` (default the card; raises without
    CUDA unless ``device="cpu"``).  ``dataset`` is a ``DataSet`` or an
    ``(x, y)`` tuple of numpy arrays."""

    def __init__(self, model, dataset, criterion, batch_size: int = 32,
                 device="cuda"):
        self.device = resolve_device(device)
        super().__init__(model.to(self.device), dataset, criterion,
                         batch_size)
        # background writes: one writer thread, the write in flight, and
        # a failure recorded by the exception path's flush, raised at the
        # next _checkpoint/optimize call
        self.checkpoint_write_failures = 0
        self._ckpt_write_error = None
        self._ckpt_executor = None
        self._ckpt_future = None
        self._fault_injector = None
        self.max_retry = 5
        self._nonfinite_consec = 0
        # batches to skip at the next epoch's start: a resume from a
        # mid-epoch checkpoint replays from the batch its neval expects
        self._pending_fast_forward = 0
        # (batches waited for, seconds waited, batches) of the last epoch
        self.feed_stats = (0, 0.0, 0)
        self.metrics = Metrics()
        # per parameter (the trainer's order): does a frozen module own it
        self._frozen_mask = []
        self._regularized = False
        # the health monitor's cadence: does this step compute its (L, 4)
        # stats (set by the loop), and the stats the step left
        self._health_monitor = None
        self._health_now = False
        self._step_health = None
        self._obs_tracer = obs.get_tracer()
        self._obs_runtime = None
        self._obs_server = None
        self._obs_ledger = NULL_LEDGER
        self._elastic_session = None
        self._collective_footprint = None
        # the step the feed's first batch of an epoch trains
        self._feed_step0 = 1
        # the reference's state table; neval is the next iteration,
        # epoch_neval0 the neval of the current epoch's first batch
        self.state = {"epoch": 1, "neval": 1, "loss": None, "score": None,
                      "epoch_finished": 0, "nonfinite_skips": 0,
                      "epoch_neval0": 1}

    # ---- one step --------------------------------------------------------
    def _loss(self, names, params, inp, tgt, seed):
        """The f32 loss of one batch plus the model's regularization
        penalty, differentiable in ``params``; ``seed`` is the step's
        dropout seed."""
        loss = self.criterion.loss(self._output(names, params, inp, seed),
                                   tgt)
        return loss + self._regularization()

    def _regularization(self):
        """The model's penalty, or 0.0 without a walk of the module tree
        when no layer has a regularizer."""
        return self.model.regularization_loss() if self._regularized \
            else 0.0

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
        is ``_prepare_batch``'s, ``None`` for this trainer.  Its phases
        are the regions ``step.forward``, ``step.backward``,
        ``step.clip`` (with a clip set), ``step.update``, ``step.guard``
        (with ``guard``) and ``step.write``, in that order."""
        tensors = len(params)
        with annotate("step.forward"):
            mstate = self.model.state()
            loss = self._loss(names, params, inp, tgt, seed)
        with annotate("step.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, params)]
            frozen = self._frozen_mask
            if any(frozen):
                grads = [g * 0.0 if f else g for g, f in zip(grads, frozen)]
        # the health stats read the pre-clip gradient
        pre_clip = grads
        if self._clipper.active:
            with annotate("step.clip", tensors=tensors):
                grads = self._clipper(grads)
        with torch.no_grad():
            with annotate("step.update", tensors=tensors):
                old = [p.detach() for p in params]
                new_p, new_opt = self.optim_method.step(grads, old, opt_state)
                if any(frozen):
                    new_p = [o if f else q
                             for q, o, f in zip(new_p, old, frozen)]
            if guard:
                with annotate("step.guard", tensors=tensors):
                    ok = torch.isfinite(loss.detach())
                    for g in grads:
                        ok = ok & torch.isfinite(g).all()
                    new_p = _where(ok, new_p, [p.detach() for p in params])
                    new_opt = _where(ok, new_opt, opt_state)
                    self.model.set_state(
                        _where(ok, self.model.state(), mstate))
            else:
                ok = torch.ones((), dtype=torch.bool, device=loss.device)
            with annotate("step.write", tensors=tensors):
                if self._health_now:
                    from bigdl_tpu_torch.obs.health import tree_layer_stats

                    # new_p is after the guard: a skipped step shows no
                    # update
                    self._step_health = tree_layer_stats(pre_clip, old,
                                                         new_p)
                elif guard and self._health_monitor is not None:
                    from bigdl_tpu_torch.obs.health import (
                        DeferredStats, tree_layer_stats)

                    # read only if the guard tripped: then new_p (fresh
                    # tensors) holds the pre-step values and the update
                    # is 0
                    self._step_health = DeferredStats(
                        lambda g=pre_clip, q=new_p: tree_layer_stats(g, q, q))
                for p, q in zip(params, new_p):
                    p.copy_(q)
                # the step's per-tensor temporaries are freed here, so
                # their host time falls in this region, not after it
                del grads, pre_clip, old, new_p
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
    def _summary_resilience(self, step, **counters) -> None:
        """Resilience counters into the train summary, where it has
        ``add_resilience`` (a plain ``add_scalar`` object has not)."""
        add = getattr(self.train_summary, "add_resilience", None)
        if add is not None:
            add(step, **counters)

    def _raise_pending_ckpt_error(self) -> None:
        """Raise the background write failure the exception path's
        flush recorded: training must not go on against a checkpoint
        sink that stopped persisting."""
        err = self._ckpt_write_error
        if err is not None:
            from bigdl_tpu_torch.resilience.retry import CheckpointWriteError

            self._ckpt_write_error = None
            raise CheckpointWriteError(
                f"a background checkpoint write failed earlier "
                f"({self.checkpoint_write_failures} write failures in "
                f"all): {err!r}") from err

    def _topology(self) -> dict:
        """How the optimizer state of a checkpoint is laid out: local
        training keeps one entry per parameter tree leaf."""
        return {"world_size": 1, "shard_layout": "tree",
                "step": self.state["neval"]}

    def _checkpoint_extra(self) -> dict:
        """What a resume needs beyond the arrays; a stream's trained
        offset and watermark (the exactly-once commit point) under
        ``"stream"``."""
        extra = {"epoch": self.state["epoch"], "neval": self.state["neval"],
                 "epoch_neval0": self.state.get("epoch_neval0",
                                                self.state["neval"]),
                 "topology": self._topology()}
        stream_state = getattr(self.dataset, "stream_checkpoint_state", None)
        if stream_state is not None:
            extra["stream"] = stream_state()
        return extra

    def _checkpoint(self, method=None, sync: bool = False) -> None:
        """Write ``checkpoint_<epoch>_<neval>`` with ``method``'s state
        (the live optimizer method by default): now, or in the
        background after a host snapshot (unless ``sync``)."""
        if not self.checkpoint_path:
            return
        self._raise_pending_ckpt_error()
        from bigdl_tpu_torch.utils.serializer import (save_checkpoint,
                                                      snapshot_checkpoint,
                                                      write_checkpoint)

        tag = f"{self.state['epoch']}_{self.state['neval']}"
        prefix = os.path.join(self.checkpoint_path, f"checkpoint_{tag}")
        method = method or self.optim_method
        extra = self._checkpoint_extra()
        keep = self.checkpoint_keep_last
        if self.checkpoint_background and not sync:
            if self._ckpt_executor is None:
                from concurrent.futures import ThreadPoolExecutor

                self._ckpt_executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="bigdl-torch-ckpt")
            self._flush_checkpoints()       # at most one write in flight
            snap = snapshot_checkpoint(self.model, method, extra,
                                       to_host=True)
            self._ckpt_future = self._ckpt_executor.submit(
                write_checkpoint, snap, prefix, keep, True)
            log.info("checkpoint scheduled at epoch %s iter %s",
                     self.state["epoch"], self.state["neval"])
            return
        save_checkpoint(prefix, self.model, method, extra, keep_last=keep)
        log.info("checkpoint saved at epoch %s iter %s", self.state["epoch"],
                 self.state["neval"])

    def _flush_checkpoints(self, raise_errors: bool = True) -> None:
        """Wait for the background write in flight.  A failure is
        counted; it is raised as ``CheckpointWriteError`` (fatal to the
        retry policy: the JAX package re-raises the writer's own error),
        or with ``raise_errors=False`` (the exception path, where
        raising would hide the first error) recorded for the next
        ``_checkpoint``/``optimize`` call."""
        fut, self._ckpt_future = self._ckpt_future, None
        if fut is None:
            return
        try:
            fut.result()
        except Exception as e:
            self.checkpoint_write_failures += 1
            self._summary_resilience(
                self.state["neval"],
                checkpoint_write_failures=self.checkpoint_write_failures)
            obs.get_tracer().event(
                "resilience.checkpoint_write_failed",
                step=self.state["neval"], error=type(e).__name__,
                total=self.checkpoint_write_failures)
            obs.get_registry().counter(
                names.CHECKPOINT_WRITE_FAILURES_TOTAL,
                "Background checkpoint writes that raised").inc()
            self._ckpt_write_error = e
            if raise_errors:
                self._raise_pending_ckpt_error()
            log.exception("background checkpoint write failed (recorded; "
                          "raised at the next checkpoint or optimize)")

    def _write_param_histograms(self, step) -> None:
        """A histogram of each parameter into the train summary, tagged
        by its JAX leaf path (the reference's "Parameters" trigger)."""
        for path, leaf in T.leaves_with_paths(self.model.params()):
            self.train_summary.add_histogram(
                "/".join(path), leaf.detach().float().cpu().numpy(), step)

    def _elastic_shutdown(self, step: int) -> None:
        """Graceful preemption (JAX :344-404): the steps before ``step``
        are resolved; write a synchronous emergency checkpoint (a
        failure is recorded, never raised: nothing may mask the exit)
        and raise ``Preempted`` (``EXIT_PREEMPTED``).  ``optimize``'s
        ``finally`` still flushes a background write in flight."""
        from bigdl_tpu_torch.resilience import elastic

        signum = elastic.preemption_signal()
        # handled now: a later optimize() in this process must not
        # re-preempt on the old flag
        elastic.clear_preemption()
        log.warning("preemption requested (signal %s) at iter %d: "
                    "emergency checkpoint, then exit %d", signum, step,
                    elastic.EXIT_PREEMPTED)
        tracer = obs.get_tracer()
        prefix = None
        if self.checkpoint_path:
            self._flush_checkpoints(raise_errors=False)
            tag = f"{self.state['epoch']}_{self.state['neval']}"
            prefix = os.path.join(self.checkpoint_path, f"checkpoint_{tag}")
            try:
                self._checkpoint(sync=True)
                log.info("emergency checkpoint written: %s", prefix)
                tracer.event("elastic.emergency_checkpoint", step=step,
                             prefix=os.path.basename(prefix))
            except Exception as e:  # noqa: BLE001 - still exit preempted
                log.exception("emergency checkpoint failed; exiting "
                              "preempted without one")
                tracer.event("elastic.emergency_checkpoint_failed",
                             step=step, error=type(e).__name__)
                prefix = None
        obs.get_registry().counter(
            names.PREEMPTIONS_TOTAL,
            "Graceful preemption shutdowns (SIGTERM/SIGINT)").inc()
        tracer.event("elastic.preempted", step=step, signum=signum,
                     checkpoint=prefix and os.path.basename(prefix))
        raise elastic.Preempted(
            f"preempted (signal {signum}) at iter {step}; emergency "
            f"checkpoint: {prefix or 'none'}", step=step, checkpoint=prefix)

    def _detect_slow_step(self, n, dt, tracer, runtime) -> None:
        """A step slower than the step-time median times
        ``BIGDL_TORCH_SLOW_STEP_FACTOR`` (after 8 steps) emits a
        ``slow_step`` event with its child spans' durations from the
        tracer's ring and counts in ``bigdl_slow_steps_total`` (JAX
        :406-440)."""
        from bigdl_tpu_torch.config import ObsConfig

        factor = ObsConfig.from_env().slow_step_factor
        if factor <= 0:
            return
        res = runtime.step_times
        if res.count < 8:
            return
        med = res.percentiles((0.5,))[0.5]
        if med is None or med <= 0 or dt <= med * factor:
            return
        breakdown = {}
        for rec in tracer.recent():
            if rec.get("kind") != "span" or rec.get("name") in (
                    "iteration", "computing"):
                continue
            if (rec.get("attrs") or {}).get("step") == n:
                breakdown[rec["name"]] = round(
                    breakdown.get(rec["name"], 0.0)
                    + float(rec.get("dur_s", 0.0)), 6)
        log.warning("slow step %d: %.4fs vs median %.4fs (> %gx); "
                    "breakdown %s", n, dt, med, factor,
                    breakdown or "unavailable (tracing off)")
        tracer.event("slow_step", step=n, dur_s=round(dt, 6),
                     median_s=round(med, 6), factor=factor,
                     breakdown=breakdown)
        obs.get_registry().counter(
            names.SLOW_STEPS_TOTAL,
            "Steps exceeding median * BIGDL_SLOW_STEP_FACTOR").inc()

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
            # the JAX LocalOptimizer takes a loaded state as it is
            # (bigdl_tpu/optim/optimizer.py:557-561) and its first step
            # then fails on the flat vectors; this says why up front
            raise NotImplementedError(
                f"the optimizer state was written by a "
                f"{topo.get('shard_layout')!r} trainer; a LocalOptimizer "
                "resumes only from a tree state, as the JAX package's "
                "(resume it with a DistriOptimizer, or reset state=None)")
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
        ``pin``), each with its mask and its record count; each batch's
        preparation is a ``batch_prep`` span of the step it feeds (the
        epoch's k-th batch feeds step ``_feed_step0 + k``)."""
        tracer, step0 = self._obs_tracer, self._feed_step0
        for k, (inp, tgt) in enumerate(self.dataset.data(train=True)):
            n = int(np.asarray(inp).shape[0])
            with tracer.span("batch_prep", step=step0 + k):
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
        # a background write that failed in an earlier optimize surfaces
        # before any new work trusts the sink
        self._raise_pending_ckpt_error()
        from bigdl_tpu_torch.resilience.faults import get_injector

        from bigdl_tpu_torch.obs import health as _health
        from bigdl_tpu_torch.obs import prof as _obs_prof
        from bigdl_tpu_torch.obs import server as _obs_server
        from bigdl_tpu_torch.resilience import elastic as _elastic

        inj = get_injector()
        self._fault_injector = inj if inj.active else None
        tracer = self._obs_tracer = obs.get_tracer()
        self._obs_runtime = obs.get_runtime() if obs.active() else None
        # the goodput ledger: the shared no-op with observability off
        self._obs_ledger = obs.get_ledger()
        self._obs_server = _obs_server.ensure_server()
        # the sampling profiler starts with the loop (off: no thread);
        # BIGDL_TORCH_PROFILE traces iterations [1, 21) with torch.profiler
        _obs_prof.get_profiler()
        self._step_profiler = StepProfiler()
        if self._obs_server is not None:
            _obs_server.register_registry(self.metrics.registry)
        self._health_monitor = _health.monitor_from_config(
            self.model.params(), tracer=tracer, summary=self.train_summary)
        # a preemption listener (SIGTERM drains at the next step's top)
        # and, at world > 1, the heartbeat monitor
        self._elastic_session = _elastic.ElasticSession.from_config()
        try:
            model = self._optimize_loop()
        finally:
            # a trace still recording ends here: an exception mid-epoch
            # must not leave one running for DistriOptimizer's retry
            self._step_profiler.stop()
            self._elastic_session.close()
            self._elastic_session = None
            # the write in flight is durable (or its error recorded)
            # before optimize returns or the retry reads the directory;
            # no writer thread outlives the run
            self._flush_checkpoints(raise_errors=False)
            ex, self._ckpt_executor = self._ckpt_executor, None
            if ex is not None:
                ex.shutdown(wait=True)
            # the run's shards last, so the snapshot holds the final
            # counters (a failure the flush above recorded included)
            if obs.active():
                obs.flush(extra_registries=[self.metrics.registry])
        # normal completion: a background write's error reaches the caller
        self._raise_pending_ckpt_error()
        return model

    def _optimize_loop(self):
        cfg = TrainConfig.from_env()
        model = self.model
        model.train()
        param_names, params, tree = self._param_leaves()
        frozen = model.frozen_parameters()
        self._frozen_mask = [id(p) in frozen for p in params]
        self._regularized = any(
            getattr(m, "_regularizers", ()) for m in model.modules())
        self._init_opt_state(params, tree)
        opt = self.optim_method
        self._nonfinite_consec = 0
        # (n, loss, ok, batch size, dispatch time, health stats or None)
        pending = []
        val_trigger = self.validation_trigger
        ckpt_trigger = self.checkpoint_trigger
        summary = self.train_summary
        get_trigger = getattr(summary, "get_summary_trigger", None)
        param_trigger = get_trigger("Parameters") if get_trigger else None
        sync_per_step = any(getattr(t, "needs_loss", True)
                            for t in (self.end_when, val_trigger,
                                      ckpt_trigger, param_trigger)
                            if t is not None)
        tracer = self._obs_tracer
        runtime = self._obs_runtime
        ledger = self._obs_ledger
        monitor = self._health_monitor
        step_profiler = self._step_profiler
        footprint = self._collective_footprint
        note_step = None
        if self._obs_server is not None:
            from bigdl_tpu_torch.obs.server import note_step
        inj = self._fault_injector
        # a stream's trained frontier moves once per dispatched batch
        note_stream = getattr(self.dataset, "note_batch_trained", None)

        def resolve(n, loss_dev, ok_dev, bs, t0, stats=None):
            # the loop's one wait on the device
            with annotate("loss_read", step=n):
                loss_val = float(loss_dev)
            dt = time.perf_counter() - t0
            self.metrics.add("computing time", dt)
            if footprint is not None:
                footprint.commit()
            if runtime is not None:
                runtime.record_step(dt)
                tracer.complete("computing", t0, dt, step=n)
                self._detect_slow_step(n, dt, tracer, runtime)
            # one productive interval, `rework` under the resume mark
            ledger.record("step", t0, dt, step=n)
            if note_step is not None:
                note_step(n)
            self.state["loss"] = loss_val
            if monitor is not None:
                # before the skip escalation below, so a
                # NonFiniteStepError never beats the localization
                monitor.on_step(n, stats, bool(ok_dev), loss_val)
            if summary is not None:
                summary.add_scalar("Loss", loss_val, n)
                summary.add_scalar(
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
            self._summary_resilience(
                n, nonfinite_skips=self.state["nonfinite_skips"])
            tracer.event("resilience.nonfinite_skip", step=n, loss=loss_val,
                         consecutive=self._nonfinite_consec,
                         total=self.state["nonfinite_skips"])
            obs.get_registry().counter(
                names.NONFINITE_SKIPS_TOTAL,
                "Train steps skipped by the non-finite guard").inc()
            if self._nonfinite_consec >= cfg.max_nonfinite_skips:
                raise NonFiniteStepError(
                    f"{self._nonfinite_consec} consecutive non-finite "
                    f"training steps (iter {n})")

        def flush():
            while pending:
                resolve(*pending.pop(0))

        def waited(it):
            """The feed's items, each wait recorded."""
            while True:
                t_wait = time.perf_counter()
                item = next(it, None)
                if item is None:
                    return
                dt_wait = time.perf_counter() - t_wait
                self.metrics.add("data wait time", dt_wait)
                tracer.complete("data_wait", t_wait, dt_wait,
                                step=self.state["neval"])
                ledger.record("data_wait", t_wait, dt_wait,
                              step=self.state["neval"])
                yield item

        pin = self.device.type == "cuda"
        stop = False
        while not stop:
            epoch = self.state["epoch"]
            t_epoch = time.time()
            finished = True
            skip, self._pending_fast_forward = self._pending_fast_forward, 0
            self._feed_step0 = self.state["neval"] - skip
            feed = PrefetchIterator(self._host_batches(pin))
            batches = iter(feed)
            try:
                if skip > 0:
                    log.info("mid-epoch resume: skipping %d batches to "
                             "iter %d", skip, self.state["neval"])
                for _ in range(skip):
                    if next(batches, None) is None:
                        break
                for inp, tgt, mask, records in waited(batches):
                    n = self.state["neval"]
                    es = self._elastic_session
                    if es is not None and es.on_iteration(n):
                        # the steps in flight resolve, then the exit
                        flush()
                        self._elastic_shutdown(n)
                    with annotate("iteration", step=n):
                        if inj is not None and inj.on_step(n) == "nan_grad":
                            inp = torch.from_numpy(inj.poison_batch(inp))
                        t0 = time.perf_counter()
                        with self.metrics.timer("put batch time"), \
                                annotate("device_put", step=n):
                            inp_d, tgt_d, mask_d = self._put_batch(
                                inp, tgt, mask)
                        step_profiler.step()
                        self._health_now = (monitor is not None
                                            and monitor.wants(n))
                        t_disp = time.perf_counter()
                        # the batch copy: the host share of the window
                        # classifier, not a cause of its own
                        ledger.note_host_seconds(t_disp - t0)
                        with annotate("step_dispatch", step=n):
                            opt.state, loss, ok = self._train_step(
                                param_names, params, opt.state, inp_d,
                                tgt_d, mask_d, cfg.nonfinite_guard,
                                fold_in(DROPOUT_BASE_SEED, n))
                        if runtime is not None:
                            runtime.record_dispatch(
                                "train_step", time.perf_counter() - t_disp)
                        stats, self._step_health = self._step_health, None
                        if note_stream is not None:
                            note_stream()
                        # read the previous step's loss while this one runs
                        flush()
                        pending.append((n, loss, ok, records, t0, stats))
                        if sync_per_step:
                            flush()
                        if param_trigger is not None and param_trigger(
                                self.state):
                            self._write_param_histograms(n)
                        self.state["neval"] = n + 1
                        if val_trigger is not None and \
                                val_trigger(self.state):
                            flush()
                            t_eval = time.perf_counter()
                            with tracer.span("validation", step=n):
                                self._run_validation()
                            ledger.record("eval", t_eval,
                                          time.perf_counter() - t_eval,
                                          step=n)
                            model.train()
                        if ckpt_trigger is not None and \
                                ckpt_trigger(self.state):
                            flush()
                            with tracer.span("checkpoint", step=n):
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
                log.info("Metrics: %s", self.metrics.summary())
                if val_trigger is not None and val_trigger(self.state):
                    t_eval = time.perf_counter()
                    self._run_validation()
                    ledger.record("eval", t_eval,
                                  time.perf_counter() - t_eval)
                    model.train()
                if ckpt_trigger is not None and ckpt_trigger(self.state):
                    with tracer.span("checkpoint", epoch=epoch):
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


__all__ = ["BaseOptimizer", "LocalOptimizer", "NonFiniteStepError",
           "Optimizer"]
