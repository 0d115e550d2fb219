"""DistriOptimizer: synchronous data parallelism with ZeRO-1 updates.

Counterpart of ``bigdl_tpu/optim/distri_optimizer.py`` (:88-1001), one
process per GPU on ``torch.distributed`` (NCCL on the card, gloo on the
CPU; ``engine.py``).  The reference's data plane per iteration is, over
the flat parameter vector (the parameters in the JAX package's leaf
order, ``ravel_pytree``'s, padded to a multiple of the world size):

    grads  = autograd of the local loss × local batch
    gshard = reduce_scatter(flat(grads))         # "putGradients"
    gshard /= global batch; clip by the global norm
    wshard, state = optim.step(gshard, wshard)   # the owner's update
    weights = all_gather(wshard)                 # "sendWeight"

- **Wire.** ``wire_dtype="bfloat16"`` (the default,
  ``BIGDL_TORCH_WIRE_DTYPE``) casts the flat gradient to bf16 before
  the reduce-scatter; ``"float32"``/``"none"`` keep f32.
- **Clip and guard.** The clipper reads the squared norm summed over
  ranks (``all_reduce``); the non-finite guard skips the step on every
  rank when any rank's shard or loss is not finite (``all_reduce`` MIN).
- **State.** The optimizer state holds this rank's shard of each
  per-parameter entry (the method's ``per_param_keys``: a flat vector
  whose length is the shard's, or LBFGS's (16, shard) histories); the
  rest (counters, LBFGS's ``rho``) is whole on every rank.  A
  checkpoint gathers the shards and rank 0 writes the whole vector, so
  the file is the JAX package's ``zero1_flat`` layout (``_topology``:
  world size, ``flat_elems``, ``pad``).  Every method runs unchanged on
  the shard (a one-tensor list), so ``LarsSGD`` takes one trust ratio
  per rank's shard, as in the JAX package; ``LBFGS`` runs at world 1
  only (its two-loop recursion needs dot products over the whole
  vector, and the JAX package's own LBFGS is wrong on a 2-device mesh,
  ``ROADMAP.md`` queue 3).
- **Regularizers and freeze.** Each rank adds the whole penalty to its
  local loss before the sum over ranks, as JAX does (:823, :839).
  Frozen parameters are intervals of the flat vector (JAX :495-535):
  the gradient there is multiplied by 0 before the exchange, and the
  shard's update there is undone after the step.
- **BN.** The running statistics are averaged over ranks after each
  step, as ``pmean`` does there; the loss read is the ranks' mean.
- **Inputs.** A per-process dataset gives each rank its own rows; any
  other gives every rank the global batch and each takes its slice,
  padded to a multiple of the world by repeating the last row, with
  the padded rows masked out of the loss and the gradient mean
  (``_prepare_batch``).  The gather writes a flat buffer, which is
  copied into the parameters (a parameter made a view of it would sit
  at any 4-byte offset, and cuDNN picks its algorithms by alignment).
- **Checkpoints.** Every rank gathers the state's shards, then rank 0
  takes ``LocalOptimizer``'s path: a synchronous write, or a host
  snapshot handed to the background writer (``set_checkpoint(
  background=True)``).
- **Retry.** ``optimize`` retries a transient failure
  (``resilience/retry.py``, an ``InjectedFault`` of the fault plan
  among them): back off, reload the newest intact checkpoint, rewind
  ``epoch``/``neval``/``epoch_neval0`` and skip to the checkpoint's
  batch, or for a stream seek it back to the checkpoint's trained
  offset (``elastic.restore_stream``); a fatal one
  (``CheckpointWriteError`` among them) is raised at once.  Each
  attempt counts in ``bigdl_retry_attempts_total`` and the summary's
  "RetryCount".

Not ported yet (ROADMAP.md queue 1 item 6): the int8/fp8 wires and
error feedback, ``overlap_bucket_mb > 0``, hierarchical ``data_axes``
and a resume at another world size than the writer's
(``elastic.ensure_shard_layout``), each of which raises
``NotImplementedError``; the health monitor and the step spans (the
checkpoint spans and the resilience events are recorded).
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.config import TrainConfig
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer, _where

log = logging.getLogger("bigdl_tpu_torch.optim")

_UNCOMPRESSED = ("float32", "none")
_NOT_PORTED_WIRES = ("int8", "fp8_e4m3", "fp8_e5m2")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               "queue 1 item 6)")


def _per_sample_losses(crit, out, tgt):
    """The criterion of each row alone, as a vector: one batched call
    (``vmap`` over singleton batches, as the JAX step does), or a loop
    over the rows for a criterion that ``vmap`` cannot run."""
    def one(o, t):
        return crit.loss(o[None], t[None])

    try:
        return torch.func.vmap(one)(out, tgt)
    except Exception:  # noqa: BLE001 - any criterion vmap cannot batch
        return torch.stack([one(out[i], tgt[i])
                            for i in range(out.shape[0])])


class DistriOptimizer(LocalOptimizer):
    """Synchronous data-parallel trainer with ZeRO-1 sharded updates
    (JAX ``DistriOptimizer``), one process per GPU.  Joins the world
    through ``Engine.init(device)`` unless it was joined before."""

    def __init__(self, model, dataset, criterion, batch_size=32, mesh=None,
                 wire_dtype=None, data_axes=None, int8_block=None,
                 wire_block=None, wire_ef=None, overlap_bucket_mb=None,
                 device="cuda"):
        if mesh is not None:
            raise _not_ported("a device mesh (one process drives one GPU "
                              "here)")
        if data_axes and len(tuple(data_axes)) > 1:
            raise _not_ported("hierarchical data_axes")
        if wire_dtype is None:
            wire_dtype = TrainConfig.from_env().wire_dtype
        if wire_dtype in _NOT_PORTED_WIRES:
            raise _not_ported(f"the {wire_dtype!r} wire")
        if wire_dtype != "bfloat16" and wire_dtype not in _UNCOMPRESSED:
            raise ValueError(
                f"wire_dtype {wire_dtype!r} not supported; choose "
                "'bfloat16', 'float32' or 'none'")
        if wire_ef:
            raise _not_ported("wire error feedback")
        if overlap_bucket_mb is not None and float(overlap_bucket_mb) > 0:
            raise _not_ported("the bucketed gradient exchange "
                              "(overlap_bucket_mb > 0)")
        block = wire_block if wire_block is not None else int8_block
        if block is not None and int(block) < 1:
            raise ValueError(
                f"wire_block/int8_block must be positive, got {block}")
        if not Engine.is_initialized():
            Engine.init(device)
        if torch.device(device).type != Engine.device().type:
            raise ValueError(f"device {device!r}, but this process's world "
                             f"runs on {Engine.device()}")
        super().__init__(model, dataset, criterion, batch_size,
                         device=Engine.device())
        self.rank, self.n_shards = Engine.world()
        self.wire_dtype = wire_dtype
        self.int8_block = 512 if block is None else int(block)
        self._flat = None
        self._flat_views = None
        # merged [start, end) runs of frozen parameters in the flat vector
        self._frozen_intervals = []
        self._per_param = frozenset()
        self._flat_elems = None
        self._pad = 0
        self._warned_batch_sizes = set()

    # ---- layout and state ---------------------------------------------------
    def _topology(self) -> dict:
        return {"world_size": self.n_shards, "shard_layout": "zero1_flat",
                "step": self.state["neval"],
                "flat_elems": self._flat_elems, "pad": self._pad,
                "wire": {"dtype": self.wire_dtype, "block": self.int8_block,
                         "ef": False}}

    def _shard(self, full: torch.Tensor) -> torch.Tensor:
        s = full.numel() // self.n_shards
        return full[self.rank * s:(self.rank + 1) * s]

    def _init_opt_state(self, params, tree) -> None:
        """The flat parameter vector (the parameters in order, padded)
        and this rank's shard of the optimizer state: fresh, or cut from
        a whole ``zero1_flat`` state (a checkpoint's, or the one the
        last run left)."""
        dev = self.device
        if any(p.dtype != torch.float32 for p in params):
            raise TypeError("DistriOptimizer trains f32 parameters")
        elems = sum(p.numel() for p in params)
        n = self.n_shards
        self._flat_elems = elems
        self._pad = (-elems) % n
        padded = elems + self._pad
        with torch.no_grad():
            self._flat = torch.cat([p.detach().reshape(-1) for p in params]
                                   + [torch.zeros(self._pad, device=dev)])
        # views of the flat vector shaped as the parameters
        self._flat_views = [v.view_as(p) for v, p in zip(
            torch.split(self._flat[:elems], [p.numel() for p in params]),
            params)]
        shard_len = padded // n
        opt = self.optim_method
        from bigdl_tpu_torch.optim.optim_method import LBFGS

        if isinstance(opt, LBFGS) and n > 1:
            raise NotImplementedError(
                "LBFGS runs on DistriOptimizer at world 1 only: its "
                "two-loop recursion takes dot products over the whole "
                "parameter vector, and the JAX package's sharded LBFGS "
                "is wrong at world > 1 (ROADMAP.md queue 3)")
        self._per_param = opt.per_param_keys()
        self._frozen_intervals = self._frozen_runs(params)
        opt.param_tree = None
        if opt.state is None:
            local = opt.init_state([torch.zeros(shard_len, device=dev)])
            opt.state = {k: v[0] if isinstance(v, list) else v
                         for k, v in local.items()}
            return
        topo = getattr(opt, "loaded_topology", None) or {}
        if any(isinstance(v, (dict, list, tuple)) for v in opt.state.values()):
            raise ValueError(
                "optim_method.state was initialised for tree parameters "
                "(LocalOptimizer); reset it (state=None) before reusing the "
                "method with DistriOptimizer")
        if topo.get("world_size", n) != n:
            raise _not_ported(
                f"resuming a world-{topo.get('world_size')} state at world "
                f"{n} (elastic.ensure_shard_layout)")
        state = {}
        for k, v in opt.state.items():
            v = torch.as_tensor(v).to(dev)
            if k in self._per_param and v.dim() == 1:
                if v.numel() != padded:
                    raise ValueError(
                        f"optimizer state {k!r} holds {v.numel()} elements, "
                        f"the padded flat vector {padded}")
                v = self._shard(v).clone()
            state[k] = v
        opt.state = state

    def _frozen_runs(self, params) -> list:
        """[start, end) runs of the flat vector owned by frozen modules,
        adjacent runs merged (JAX :505-526)."""
        frozen = self.model.frozen_parameters()
        runs, off = [], 0
        for p in params:
            sz = p.numel()
            if id(p) in frozen and sz:
                if runs and runs[-1][1] == off:
                    runs[-1][1] = off + sz
                else:
                    runs.append([off, off + sz])
            off += sz
        return [tuple(r) for r in runs]

    def _gathered_state(self) -> dict:
        """The whole optimizer state: each shard vector gathered."""
        out = {}
        for k, v in self.optim_method.state.items():
            if k in self._per_param and v.dim() == 1:
                full = torch.empty(v.numel() * self.n_shards, dtype=v.dtype,
                                   device=v.device)
                dist.all_gather_into_tensor(full, v.contiguous())
                v = full
            out[k] = v
        return out

    def _checkpoint(self, method=None) -> None:
        """Every rank gathers the state's shards; rank 0 writes the
        whole of it, and the others wait for the file."""
        if not self.checkpoint_path:
            return
        method = copy.copy(self.optim_method)
        method.state = self._gathered_state()
        if self.rank == 0:
            super()._checkpoint(method)
        if self.n_shards > 1:
            dist.barrier()

    def _publish_optim_state(self) -> None:
        opt = self.optim_method
        opt.state = self._gathered_state()
        opt.loaded_topology = self._topology()

    # ---- the input ----------------------------------------------------------
    def _prepare_batch(self, inp, tgt):
        """Pad a batch the world does not divide by repeating its last
        row, with a mask of the real rows (the reference's
        SampleToMiniBatch padding), and take this rank's rows unless the
        dataset is per-process.  Runs on the feed's thread."""
        inp, tgt = np.asarray(inp), np.asarray(tgt)
        per_process = getattr(self.dataset, "per_process", False)
        divisor = 1 if per_process else self.n_shards
        bs = inp.shape[0]
        mask = None
        rem = bs % divisor
        if rem:
            pad_n = divisor - rem
            if bs not in self._warned_batch_sizes:
                self._warned_batch_sizes.add(bs)
                log.info("DistriOptimizer: batch of %d not divisible by the "
                         "%d-way split; padding with %d masked copies of the "
                         "last sample", bs, divisor, pad_n)
            inp = np.concatenate([inp, np.repeat(inp[-1:], pad_n, axis=0)])
            tgt = np.concatenate([tgt, np.repeat(tgt[-1:], pad_n, axis=0)])
            mask = np.concatenate([np.ones(bs, np.float32),
                                   np.zeros(pad_n, np.float32)])
        if not per_process:
            local = inp.shape[0] // self.n_shards
            rows = slice(self.rank * local, (self.rank + 1) * local)
            inp, tgt = inp[rows], tgt[rows]
            mask = None if mask is None else mask[rows]
        return inp, tgt, mask

    # ---- one step -----------------------------------------------------------
    def _local_loss(self, names, params, inp, tgt, seed, mask):
        """(the loss to differentiate, the loss to report) of this
        rank's rows: the mean times the local batch (so the summed
        gradient over ranks divided by the global batch is the mean),
        or under a mask the masked sum of per-sample losses."""
        out = self._output(names, params, inp, seed)
        crit = self.criterion
        if mask is not None:
            per = _per_sample_losses(crit, out, tgt)
            local_sum = torch.sum(per * mask)
            return local_sum + self._regularization(), local_sum
        per_mean = crit.loss(out, tgt)
        local_bs = self.batch_size // self.n_shards
        total = per_mean * local_bs if getattr(crit, "size_average", True) \
            else per_mean
        return total + self._regularization(), per_mean

    def _train_step(self, names, params, opt_state, inp, tgt, mask, guard,
                    seed):
        n = self.n_shards
        mstate = self.model.state()
        total, loss_aux = self._local_loss(names, params, inp, tgt, seed,
                                           mask)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        with torch.no_grad():
            g = torch.cat([torch.zeros(p.numel(), device=p.device)
                           if gr is None else gr.reshape(-1).float()
                           for gr, p in zip(grads, params)]
                          + [self._flat.new_zeros(self._pad)])
            for a, b in self._frozen_intervals:
                g[a:b] *= 0.0
            if self.wire_dtype == "bfloat16":
                g = g.to(torch.bfloat16)
            shard = g.new_empty(g.numel() // n)
            dist.reduce_scatter_tensor(shard, g)
            gshard = shard.float()
            if mask is not None:
                valid = mask.sum().reshape(1)
                dist.all_reduce(valid)
                valid = valid[0]
                gshard = gshard / valid
            else:
                gshard = gshard / self.batch_size
            sums = torch.stack([torch.sum(gshard * gshard),
                                loss_aux.detach().float()])
            dist.all_reduce(sums)
            gshard = self._clipper([gshard], global_sq=sums[0])[0]
            if guard:
                ok = (torch.isfinite(gshard).all()
                      & torch.isfinite(loss_aux.detach())).float()
                dist.all_reduce(ok, op=dist.ReduceOp.MIN)
                ok = ok > 0
            else:
                ok = torch.ones((), dtype=torch.bool, device=gshard.device)
            wshard = self._shard(self._flat)
            per_param = self._per_param
            listed = {k: [v] if k in per_param else v
                      for k, v in opt_state.items()}
            new_w, new_opt = self.optim_method.step([gshard], [wshard],
                                                    listed)
            new_w = new_w[0]
            new_opt = {k: v[0] if k in per_param else v
                       for k, v in new_opt.items()}
            if guard:
                new_w = torch.where(ok, new_w, wshard)
                new_opt = _where(ok, new_opt, opt_state)
            # frozen runs inside this rank's shard keep their values
            lo = self.rank * wshard.numel()
            for a, b in self._frozen_intervals:
                a, b = max(a - lo, 0), min(b - lo, wshard.numel())
                if a < b:
                    new_w[a:b] = wshard[a:b]
            dist.all_gather_into_tensor(self._flat, new_w.contiguous())
            torch._foreach_copy_(params, self._flat_views)
            if guard:
                self.model.set_state(_where(ok, self.model.state(), mstate))
            if n > 1:
                self._average_model_state()
            if mask is not None:
                loss = sums[1] / valid
            else:
                loss = sums[1] / n
        return new_opt, loss, ok

    def _average_model_state(self) -> None:
        """The floating buffers (BN running statistics) averaged over
        ranks in one all-reduce, as ``pmean`` keeps them equal."""
        from bigdl_tpu_torch.utils import tree as T

        pairs = [(p, v) for p, v in T.leaves_with_paths(self.model.state())
                 if v.is_floating_point()]
        if not pairs:
            return
        flat = torch.cat([v.reshape(-1).float() for _, v in pairs])
        dist.all_reduce(flat)
        flat /= self.n_shards
        out, off = [], 0
        for path, v in pairs:
            out.append((path, flat[off:off + v.numel()].view_as(v).to(
                v.dtype)))
            off += v.numel()
        self.model.set_state(T.unflatten(out))

    # ---- validation -----------------------------------------------------------
    def _evaluate(self):
        """Each rank folds its own rows of a per-process validation set;
        the results are summed over ranks before anyone reads them."""
        results = super()._evaluate()
        if self.n_shards == 1 or not getattr(self.validation_dataset,
                                             "per_process", False):
            return results
        out = []
        for r in results:
            t = torch.tensor([r.total, float(r.count)], dtype=torch.float64,
                             device=self.device)
            dist.all_reduce(t)
            out.append(type(r)(float(t[0]), int(t[1]), r.name))
        return out

    # ---- the retry ------------------------------------------------------------
    def optimize(self):
        """Train; on a transient failure with checkpoints set, back off,
        reload the newest intact checkpoint and go on from it (JAX
        :900-1001).  A fatal failure, or one without checkpoints, is
        raised at once; so is the last when the retry budget is spent.
        ``retries`` counts the reloads."""
        from bigdl_tpu_torch.resilience.elastic import restore_stream
        from bigdl_tpu_torch.resilience.retry import RetryPolicy, classify
        from bigdl_tpu_torch.utils.serializer import load_latest_checkpoint

        policy = RetryPolicy.from_config(max_retries=self.max_retry)
        counter = obs.get_registry().counter(
            names.RETRY_ATTEMPTS_TOTAL,
            "Training failures handled by the retry policy",
            labels=("classification", "error"))
        tracer = obs.get_tracer()
        self.retries = 0
        while True:
            try:
                return super().optimize()
            except Exception as e:
                kind = classify(e)
                err = type(e).__name__
                if not self.checkpoint_path or kind == "fatal":
                    counter.labels(classification=kind, error=err).inc()
                    tracer.event("resilience.failure", classification=kind,
                                 error=err, step=self.state["neval"],
                                 retried=False)
                    raise
                delay = policy.record_failure(e)
                counter.labels(classification="transient", error=err).inc()
                if delay is None:
                    log.error("retry budget exhausted after %d transient "
                              "failures; raising the last one",
                              policy.attempts)
                    tracer.event("resilience.retry_budget_exhausted",
                                 attempts=policy.attempts, error=err,
                                 step=self.state["neval"])
                    raise
                log.exception("transient training failure (%s); retry %d/%d "
                              "from the last intact checkpoint in %.2fs",
                              err, policy.attempts, self.max_retry, delay)
                tracer.event("resilience.retry", classification="transient",
                             error=err, attempt=policy.attempts,
                             max_retries=self.max_retry,
                             delay_s=round(delay, 4),
                             step=self.state["neval"])
                self._summary_resilience(self.state["neval"],
                                         retries=policy.attempts)
                if delay > 0:
                    time.sleep(delay)
                if self.n_shards > 1 and self.checkpoint_background:
                    # rank 0's writer has flushed (optimize's finally)
                    # before any rank lists the directory
                    dist.barrier()
                extra = load_latest_checkpoint(self.checkpoint_path,
                                               self.model, self.optim_method)
                self.retries += 1
                if "epoch" in extra:
                    self.state["epoch"] = extra["epoch"]
                if "neval" in extra:
                    self.state["neval"] = extra["neval"]
                self.state["epoch_neval0"] = extra.get("epoch_neval0",
                                                       self.state["neval"])
                self._pending_fast_forward = max(
                    0, self.state["neval"] - self.state["epoch_neval0"])
                # a stream seeks to the checkpoint's trained offset
                # instead: the records past it are read and trained again
                restore_stream(self, extra)


__all__ = ["DistriOptimizer"]
