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

- **Wire** (JAX :117-161, :555-600).  ``wire_dtype="bfloat16"`` (the
  default, ``BIGDL_TORCH_WIRE_DTYPE``) casts the flat gradient to bf16
  before the reduce-scatter; ``"float32"``/``"none"`` keep f32;
  ``"int8"``/``"fp8_e4m3"``/``"fp8_e5m2"`` run the staged ring of
  ``parallel/wire.py`` (blockwise scales, ``wire_block`` /
  ``BIGDL_TORCH_WIRE_BLOCK`` elements a scale, the flat vector padded
  to whole blocks a shard), as does any wire with error feedback
  (``wire_ef`` / ``BIGDL_TORCH_WIRE_EF``).  The EF residual is
  ``optim_method.state["wire_ef"]``: this rank's row of the JAX
  package's ``(world, padded)`` f32 array (flat coordinates), gathered
  whole into a checkpoint.  At world 1 the wire moves nothing and is
  the identity.
- **Buckets** (JAX :162-171, :243-262).  ``overlap_bucket_mb > 0``
  (``BIGDL_TORCH_OVERLAP_BUCKET_MB``) cuts the padded vector into
  buckets of about that many MiB, whole quanta each, exchanged last
  bucket first; each rank owns its chunk of every bucket, the shard-
  major layout the JAX package records as ``topology["buckets"]``, so
  the state vectors are in that order.  The plain-wire buckets are
  launched together after the backward, last first, with
  ``async_op=True``, and waited on before the update; the results are
  those of the one-bucket exchange laid out by buckets.
- **Hierarchical data axes** (JAX :103-115).  ``data_axes=("dcn",
  "data")`` over ``Engine.build_mesh({"dcn": a, "data": b})`` (or
  ``mesh=``): a reduce-scatter inside each ``data`` group, then one
  across each ``dcn`` group, the operand permuted from ``(a, b, c)``
  to ``(b, a, c)`` first so that rank ``(i, j)`` owns flat chunk ``i *
  b + j``, the JAX ``P(("dcn", "data"))`` owner; the all-gather runs
  the other way.  The staged ring over two axes raises, as there.
- **Byte footprint** (JAX :331-430): each step's wire bytes from
  shapes (``obs/collectives.py``), the bucket gauge, and the exposed
  fraction of the bytes with buckets.
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
  background=True)``).  A state written at another world size or
  bucket plan is re-laid by ``elastic.ensure_shard_layout`` (the EF
  residual reset to zeros).
- **Health** (JAX :484-488, :712-729): with ``BIGDL_TORCH_HEALTH_EVERY``
  set, every K-th step takes ``obs/health.flat_shard_stats`` of its
  shard (the pre-clip gradient, the weights and the update after the
  guard), one ``(L, 4)`` all-reduce.
- **Retry.** ``optimize`` retries a transient failure
  (``resilience/retry.py``, an ``InjectedFault`` of the fault plan
  among them): back off, reload the newest intact checkpoint, rewind
  ``epoch``/``neval``/``epoch_neval0`` and skip to the checkpoint's
  batch, or for a stream seek it back to the checkpoint's trained
  offset (``elastic.restore_stream``), and stamp the goodput ledger's
  rework mark (the replayed steps are ``rework``, JAX :991-994); a fatal
  one (``CheckpointWriteError`` among them) is raised at once.  Each
  attempt counts in ``bigdl_retry_attempts_total`` and the summary's
  "RetryCount".  The step's static collective bytes (and, with
  buckets, the exposed share) feed the goodput window classifier's
  comm estimate (JAX :383-415).

What still raises: a JAX ``Mesh`` object as ``mesh=`` (pass the port's
``Engine.build_mesh``), data axes that cover part of the world or are
not the mesh's axes in its order, the staged ring over two data axes
(as in the JAX package), and ``LBFGS`` at world > 1.
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.config import ObsConfig, TrainConfig
from bigdl_tpu_torch.engine import Engine, Mesh
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer, _where
from bigdl_tpu_torch.parallel import wire as W

log = logging.getLogger("bigdl_tpu_torch.optim")


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
        if mesh is not None and not isinstance(mesh, Mesh):
            raise NotImplementedError(
                f"mesh {type(mesh).__name__}: one process drives one GPU "
                "here; pass the port's Engine.build_mesh(...) (or none)")
        cfg = TrainConfig.from_env()
        if wire_dtype is None:
            wire_dtype = cfg.wire_dtype
        if wire_dtype not in W.WIRE_DTYPES and \
                wire_dtype not in W.UNCOMPRESSED:
            raise ValueError(
                f"wire_dtype {wire_dtype!r} not supported; choose "
                "'bfloat16', 'int8', 'fp8_e4m3', 'fp8_e5m2', 'float32' "
                "or 'none'")
        block = wire_block if wire_block is not None else int8_block
        if block is not None and int(block) < 1:
            raise ValueError(
                f"wire_block/int8_block must be positive, got {block}")
        if wire_dtype in W.WIRE_DTYPES:
            spec = W.WireSpec.from_config(dtype=wire_dtype, block=block,
                                          error_feedback=wire_ef)
        else:
            if wire_ef:
                raise ValueError(
                    "error feedback needs a compressed wire dtype "
                    f"(got {wire_dtype!r})")
            spec = None
        if not Engine.is_initialized():
            Engine.init(device)
        if torch.device(device).type != Engine.device().type:
            raise ValueError(f"device {device!r}, but this process's world "
                             f"runs on {Engine.device()}")
        super().__init__(model, dataset, criterion, batch_size,
                         device=Engine.device())
        self.rank, world = Engine.world()
        self.wire_dtype = wire_dtype
        self.wire = spec
        self.int8_block = spec.block if spec is not None else \
            int(block) if block is not None else cfg.wire_block
        # the staged ring (scaled dtypes, or any EF wire) runs over one
        # ring; plain bf16/f32 keep reduce_scatter_tensor
        self._staged_ring = spec is not None and (spec.scaled
                                                  or spec.error_feedback)
        self._hier = None
        if mesh is None and data_axes and len(tuple(data_axes)) > 1:
            mesh = Engine.mesh()
            if mesh is None:
                raise ValueError(
                    f"data_axes {tuple(data_axes)} name mesh axes; build "
                    "the mesh first (Engine.build_mesh) or pass mesh=")
        self.mesh = mesh
        self.axes = tuple(data_axes) if data_axes else (
            (mesh.axis_names[0],) if mesh is not None else ("data",))
        if mesh is not None:
            for a in self.axes:
                if a not in mesh.axis_names:
                    raise ValueError(f"data axis {a!r} not in mesh axes "
                                     f"{mesh.axis_names}")
            if self.axes != mesh.axis_names:
                raise NotImplementedError(
                    f"data axes {self.axes} over mesh axes "
                    f"{mesh.axis_names}: the port shards over every mesh "
                    "axis, in the mesh's order")
            if len(self.axes) > 2:
                raise NotImplementedError("more than two data axes")
        self.n_shards = world
        if len(self.axes) > 1:
            if self._staged_ring:
                raise NotImplementedError(
                    f"the {wire_dtype!r} staged-ring wire over hierarchical "
                    "data axes is not supported; use a single data axis or "
                    "bfloat16")
            outer, inner = self.axes
            self._hier = (mesh.shape[outer], mesh.shape[inner],
                          mesh.group(outer), mesh.group(inner))
        if overlap_bucket_mb is None:
            overlap_bucket_mb = cfg.overlap_bucket_mb
        self.overlap_bucket_mb = float(overlap_bucket_mb)
        self._buckets = None
        self._positions = None
        self._frozen_keep = None
        self._flat = None
        self._flat_views = None
        # merged [start, end) runs of frozen parameters in the flat vector
        self._frozen_intervals = []
        self._per_param = frozenset()
        self._flat_elems = None
        self._pad = 0
        self._boundaries = None
        self._warned_batch_sizes = set()

    # ---- layout and state ---------------------------------------------------
    def _topology(self) -> dict:
        """The checkpoint's layout tag (JAX :195-220): world size, the
        flat vector's true length and padding, the wire, and the bucket
        plan when there is more than one bucket."""
        topo = {"world_size": self.n_shards, "shard_layout": "zero1_flat",
                "step": self.state["neval"],
                "flat_elems": self._flat_elems, "pad": self._pad,
                "wire": {"dtype": self.wire_dtype, "block": self.int8_block,
                         "ef": bool(self.wire is not None
                                    and self.wire.error_feedback)}}
        if self._buckets is not None and len(self._buckets) > 1:
            topo["buckets"] = [[s, z] for s, z in self._buckets]
        return topo

    def _shard_slices(self):
        """(start, length) in the padded flat vector of this rank's
        chunk of each bucket, in bucket order."""
        n, r = self.n_shards, self.rank
        return [(s + r * (z // n), z // n) for s, z in self._buckets]

    def _shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a padded flat vector (its chunk of every
        bucket, concatenated)."""
        parts = [full[a:a + c] for a, c in self._shard_slices()]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _init_opt_state(self, params, tree) -> None:
        """The flat parameter vector (the parameters in order, padded
        to the wire's quantum), the bucket plan, and this rank's shard
        of the optimizer state: fresh, or cut from a whole
        ``zero1_flat`` state (a checkpoint's, or the one the last run
        left), re-laid first when its world or plan differ (JAX
        :222-329)."""
        from bigdl_tpu_torch.resilience import elastic

        dev = self.device
        if any(p.dtype != torch.float32 for p in params):
            raise TypeError("DistriOptimizer trains f32 parameters")
        elems = sum(p.numel() for p in params)
        n = self.n_shards
        scaled = self.wire is not None and self.wire.scaled
        quantum = n * self.int8_block if scaled else n
        self._flat_elems = elems
        self._pad = (-elems) % quantum
        padded = elems + self._pad
        target = int(self.overlap_bucket_mb * (1 << 20) / 4) \
            if self.overlap_bucket_mb > 0 else 0
        self._buckets = W.plan_buckets(padded, quantum, target)
        with torch.no_grad():
            self._flat = torch.cat([p.detach().reshape(-1) for p in params]
                                   + [torch.zeros(self._pad, device=dev)])
        # views of the flat vector shaped as the parameters
        self._flat_views = [v.view_as(p) for v, p in zip(
            torch.split(self._flat[:elems], [p.numel() for p in params]),
            params)]
        shard_len = padded // n
        self._positions = torch.cat([
            torch.arange(a, a + c, device=dev, dtype=torch.int64)
            for a, c in self._shard_slices()])
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
        keep = torch.ones(shard_len, dtype=torch.bool, device=dev)
        for lo, hi in self._frozen_intervals:
            keep &= ~((self._positions >= lo) & (self._positions < hi))
        self._frozen_keep = None if bool(keep.all()) else keep
        from bigdl_tpu_torch.obs import health as H

        self._boundaries = torch.as_tensor(
            np.cumsum(H.layer_sizes(self.model.params())), device=dev,
            dtype=torch.int64)
        opt.param_tree = None
        ef_on = self.wire is not None and self.wire.error_feedback
        if opt.state is None:
            local = opt.init_state([torch.zeros(shard_len, device=dev)])
            opt.state = {k: v[0] if isinstance(v, list) else v
                         for k, v in local.items()}
        else:
            if any(isinstance(v, (dict, list, tuple))
                   for v in opt.state.values()):
                raise ValueError(
                    "optim_method.state was initialised for tree "
                    "parameters (LocalOptimizer); reset it (state=None) "
                    "before reusing the method with DistriOptimizer")
            whole = elastic.ensure_shard_layout(
                opt.state, flat_elems=elems, pad=self._pad, n_shards=n,
                topology=getattr(opt, "loaded_topology", None),
                buckets=self._buckets, device=dev)
            state = {}
            for k, v in whole.items():
                v = torch.as_tensor(v).to(dev)
                if k == "wire_ef":
                    v = v[self.rank].clone()
                elif k in self._per_param and v.dim() == 1:
                    if v.numel() != padded:
                        raise ValueError(
                            f"optimizer state {k!r} holds {v.numel()} "
                            f"elements, the padded flat vector {padded}")
                    v = v[self.rank * shard_len:
                          (self.rank + 1) * shard_len].clone()
                state[k] = v
            opt.state = state
        # the EF residual: this rank's row, flat coordinates
        if ef_on:
            ef = opt.state.get("wire_ef")
            if ef is None or tuple(ef.shape) != (padded,):
                opt.state["wire_ef"] = torch.zeros(padded, device=dev)
        else:
            opt.state.pop("wire_ef", None)
        # the layout the state is in now: a later re-init re-lays from it
        opt.loaded_topology = self._topology()
        self._collective_footprint = self._collective_byte_footprint()

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
        """The whole optimizer state: each shard vector gathered (shard-
        major, the JAX ``P(axis)`` array), the EF rows stacked to
        ``(world, padded)``."""
        out = {}
        for k, v in self.optim_method.state.items():
            if k == "wire_ef" or (k in self._per_param and v.dim() == 1):
                full = torch.empty(v.numel() * self.n_shards, dtype=v.dtype,
                                   device=v.device)
                dist.all_gather_into_tensor(full, v.contiguous())
                v = full.view(self.n_shards, -1) if k == "wire_ef" else full
            out[k] = v
        return out

    def _checkpoint(self, method=None, sync: bool = False) -> None:
        """Every rank gathers the state's shards; rank 0 writes the
        whole of it, and the others wait for the file."""
        if not self.checkpoint_path:
            return
        method = copy.copy(self.optim_method)
        method.state = self._gathered_state()
        if self.rank == 0:
            super()._checkpoint(method, sync=sync)
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

    # ---- the exchange ---------------------------------------------------------
    def _reduce_scatter(self, x: torch.Tensor, async_op: bool = False):
        """This rank's reduced chunk of ``x`` (one bucket): one
        reduce-scatter over the world, or for two data axes one inside
        the inner group after the ``(a, b, c) -> (b, a, c)`` permute,
        then one across the outer group.  With ``async_op`` (one axis
        only) returns ``(chunk, work)``."""
        n = self.n_shards
        out = x.new_empty(x.numel() // n)
        if self._hier is None:
            work = dist.reduce_scatter_tensor(out, x, async_op=async_op)
            return (out, work) if async_op else out
        a, b, outer, inner = self._hier
        c = x.numel() // n
        xp = x.view(a, b, c).transpose(0, 1).contiguous().view(-1)
        mid = x.new_empty(a * c)
        dist.reduce_scatter_tensor(mid, xp, group=inner)
        dist.reduce_scatter_tensor(out, mid, group=outer)
        return (out, None) if async_op else out

    def _all_gather(self, chunk: torch.Tensor, out: torch.Tensor) -> None:
        """The inverse of :meth:`_reduce_scatter`: every rank's chunk
        into ``out`` (one bucket, flat order)."""
        if self._hier is None:
            dist.all_gather_into_tensor(out, chunk.contiguous())
            return
        a, b, outer, inner = self._hier
        c = chunk.numel()
        mid = chunk.new_empty(a * c)
        dist.all_gather_into_tensor(mid, chunk.contiguous(), group=outer)
        full = chunk.new_empty(b * a * c)
        dist.all_gather_into_tensor(full, mid, group=inner)
        out.copy_(full.view(b, a, c).transpose(0, 1).reshape(-1))

    def _exchange(self, g: torch.Tensor, ef):
        """(this rank's reduced shard in f32, the new EF row or None):
        one exchange a bucket, last bucket first (JAX :555-600)."""
        n = self.n_shards
        buckets = self._buckets
        pieces = [None] * len(buckets)
        new_ef = None
        if self._staged_ring:
            ef_pieces = [None] * len(buckets)
            for i in reversed(range(len(buckets))):
                s, z = buckets[i]
                ef_b = None if ef is None else ef[s:s + z].view(n, z // n)
                pieces[i], ef_pieces[i] = W.reduce_scatter(
                    g[s:s + z], None, n, self.wire, ef=ef_b)
            if ef is not None:
                new_ef = torch.cat([e.reshape(-1) for e in ef_pieces])
        else:
            if self.wire_dtype == "bfloat16":
                g = g.to(torch.bfloat16)
            works = []
            for i in reversed(range(len(buckets))):
                s, z = buckets[i]
                pieces[i], work = self._reduce_scatter(g[s:s + z],
                                                       async_op=True)
                works.append(work)
            for work in works:
                if work is not None:
                    work.wait()
        gshard = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        return gshard.float(), new_ef

    # ---- one step -----------------------------------------------------------
    def _train_step(self, names, params, opt_state, inp, tgt, mask, guard,
                    seed):
        n = self.n_shards
        mstate = self.model.state()
        total, loss_aux = self._local_loss(names, params, inp, tgt, seed,
                                           mask)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        ef_on = "wire_ef" in opt_state
        with torch.no_grad():
            g = torch.cat([torch.zeros(p.numel(), device=p.device)
                           if gr is None else gr.reshape(-1).float()
                           for gr, p in zip(grads, params)]
                          + [self._flat.new_zeros(self._pad)])
            for a, b in self._frozen_intervals:
                g[a:b] *= 0.0
            gshard, new_ef = self._exchange(
                g, opt_state["wire_ef"] if ef_on else None)
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
            # the health stats read the pre-clip gradient
            g_health = gshard
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
            # the EF residual is wire state: the method never sees it
            opt_in = {k: v for k, v in opt_state.items() if k != "wire_ef"}
            listed = {k: [v] if k in per_param else v
                      for k, v in opt_in.items()}
            new_w, new_opt = self.optim_method.step([gshard], [wshard],
                                                    listed)
            new_w = new_w[0]
            new_opt = {k: v[0] if k in per_param else v
                       for k, v in new_opt.items()}
            if ef_on:
                new_opt["wire_ef"] = new_ef if new_ef is not None \
                    else opt_state["wire_ef"]
            if guard:
                new_w = torch.where(ok, new_w, wshard)
                new_opt = _where(ok, new_opt, opt_state)
            # frozen runs inside this rank's shard keep their values
            if self._frozen_keep is not None:
                new_w = torch.where(self._frozen_keep, new_w, wshard)
            positions = (self._positions if len(self._buckets) > 1
                         else None)
            if self._health_now:
                from bigdl_tpu_torch.obs import health as H

                self._step_health = H.flat_shard_stats(
                    g_health, wshard, new_w, self.rank * wshard.numel(),
                    self._boundaries, positions=positions)
            elif guard and self._health_monitor is not None:
                from bigdl_tpu_torch.obs import health as H

                # read only if the guard tripped (on every rank at once:
                # ok is MIN-reduced); new_w is fresh and then holds the
                # shard's pre-step values
                offset = self.rank * wshard.numel()
                self._step_health = H.DeferredStats(
                    lambda: H.flat_shard_stats(
                        g_health, new_w, new_w, offset, self._boundaries,
                        positions=positions))
            off = 0
            for s, z in self._buckets:
                c = z // n
                self._all_gather(new_w[off:off + c], self._flat[s:s + z])
                off += c
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

    def _collective_byte_footprint(self):
        """The wire bytes of one step from shapes (JAX :331-430): the
        gradient exchange, the norm, guard, health and loss sums, the
        weight gather and the BN averages.  Publishes the per-step
        gauges, the bucket gauge, the exposed share of the bytes with
        buckets and the savings-ratio gauge; the loop commits it once a
        resolved step."""
        from bigdl_tpu_torch.obs import collectives as C

        n = self.n_shards
        padded = self._flat_elems + self._pad
        fp = C.StepFootprint()
        if self._staged_ring:
            ex = C.staged_ring_exchange_bytes(
                padded, n, self.int8_block, self.wire.wire_name)
            exchange = 0.0
            for name, b in ex.items():
                fp.add("ring_rs", name, b)
                exchange += b
        else:
            wire = "bfloat16" if self.wire_dtype == "bfloat16" \
                else "float32"
            exchange = C.reduce_scatter_bytes(padded, wire, n)
            fp.add("psum_scatter", wire, exchange)
        fp.add("psum", "float32", C.all_reduce_bytes(1, "float32", n))
        if TrainConfig.from_env().nonfinite_guard:
            fp.add("pmin", "float32", C.all_reduce_bytes(1, "float32", n))
        if self._health_monitor is not None:
            fp.add("psum", "float32", C.all_reduce_bytes(
                len(self._health_monitor.names) * 4, "float32", n))
        fp.add("pmean", "float32", C.all_reduce_bytes(1, "float32", n))
        fp.add("all_gather", "float32",
               C.all_gather_bytes(padded, "float32", n))
        from bigdl_tpu_torch.utils import tree as T

        for leaf in T.leaves(self.model.state()):
            if leaf.is_floating_point():
                fp.add("pmean", leaf.dtype, C.all_reduce_bytes(
                    leaf.numel(), leaf.dtype, n))
        registry = obs.get_registry()
        fp.bind(registry)
        # the goodput window classifier's comm seconds come from the
        # same static bytes (BIGDL_TORCH_WIRE_GBPS)
        ledger = self._obs_ledger
        ledger.set_comm_bytes_per_step(fp.total())
        n_buckets = len(self._buckets)
        registry.gauge(
            names.OVERLAP_BUCKETS,
            "Gradient-exchange buckets of the overlapped step "
            "(1 = monolithic, no overlap)").set(float(n_buckets))
        ledger.set_exposed_comm_bytes_per_step(None)
        if n_buckets > 1:
            hidden = exchange * (n_buckets - 1) / n_buckets
            exposed = fp.total() - hidden
            ledger.set_exposed_comm_bytes_per_step(exposed)
            registry.gauge(
                names.OVERLAP_EXPOSED_COMM_FRACTION,
                "Share of the per-step collective bytes NOT hidden "
                "under backward by the bucketed exchange").set(
                round(exposed / fp.total(), 6) if fp.total() else 0.0)
            gbps = ObsConfig.from_env().wire_gbps
            if gbps > 0:
                registry.gauge(
                    names.OVERLAP_EXPOSED_COMM_SECONDS,
                    "Estimated per-step collective seconds not hidden "
                    "by backward (exposed bytes / BIGDL_WIRE_GBPS)").set(
                    exposed / (gbps * 1e9))
        f32_exchange = C.reduce_scatter_bytes(padded, "float32", n)
        ratio = C.record_savings("grad", f32_exchange, exchange,
                                 registry=registry)
        tracer = obs.get_tracer()
        if tracer.enabled:
            tracer.event("collective.footprint",
                         wire_dtype=self.wire_dtype, n_shards=n,
                         padded_elems=padded,
                         bytes_per_step=round(fp.total(), 1),
                         savings_ratio=round(ratio, 4),
                         breakdown={k: round(v, 1)
                                    for k, v in fp.by_op().items()})
        return fp

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
                # goodput: the steps between the checkpoint and the
                # failure run again, as rework
                obs.get_ledger().stamp_resume(self.state["neval"])
                # the rewound step restarts /healthz's stall clock
                from bigdl_tpu_torch.obs import server as _obs_server

                if _obs_server.get_server() is not None:
                    _obs_server.note_step(self.state["neval"])


__all__ = ["DistriOptimizer"]
