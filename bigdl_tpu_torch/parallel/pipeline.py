"""Pipeline parallelism: a collective-permute schedule over a mesh axis.

Counterpart of ``bigdl_tpu/parallel/pipeline.py``.  N stages of one
shape live on the N ranks of an axis; microbatches stream in at stage
0, and at every step each rank applies its stage and sends the
activation to the next rank (``parallel/wire.ppermute``, differentiable:
the backward sends the cotangent back).  After M + N - 1 steps (M
microbatches, the GPipe fill/drain bubble) the last rank holds every
output, and a final sum broadcasts its buffer to every rank.

Where the JAX package runs the schedule inside ``shard_map`` as one
``fori_loop``, each rank here runs it eagerly on its own stage.  The
backward assumes what the JAX package's replicated output means: every
rank computes the same loss from the output, so the final sum's backward
passes the cotangent through unchanged.
"""

from __future__ import annotations

from typing import Callable

import torch

from bigdl_tpu_torch.parallel.tensor_parallel import (_ReduceFromGroup,
                                                      _tree_map)
from bigdl_tpu_torch.parallel.ulysses import _group_size


def pipeline_apply(stage_fn: Callable, stage_params, x, group):
    """Run the pipeline over ``group`` (the axis's process group; None
    is the world, or one rank without a process group; JAX :19-64).

    Args:
      stage_fn: (params, act) -> act, shape-preserving (one stage).
      stage_params: THIS rank's stage parameters.
      x: microbatched input (M, mb, ...), the same on every rank.
    Returns:
      (M, mb, ...) outputs of the last stage, the same on every rank.
    """
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import wire as W

    n = _group_size(group)
    idx = dist.get_rank(group) if n > 1 else 0
    m = x.shape[0]
    perm = [(j, j + 1) for j in range(n - 1)]
    # tensor conditions, as jnp.where: a rank's unused input (stage 0's
    # received activation) stays in the graph with a zero cotangent, so
    # every rank's backward runs every hop of the schedule
    first = torch.tensor(idx == 0, device=x.device)
    recv = torch.zeros_like(x[0])
    outs = [None] * m
    for t in range(m + n - 1):
        # stage 0 injects microbatch t (clamped: the drain steps feed
        # values that never reach the output buffer in time)
        inp = torch.where(first, x[min(t, m - 1)], recv)
        out = stage_fn(stage_params, inp)
        # the last rank emits microbatch t - (n - 1) at step t
        if t >= n - 1:
            outs[t - (n - 1)] = out
        if n > 1:
            recv = W.ppermute(out, group, perm, None)
    ybuf = torch.stack(outs)
    if n == 1:
        return ybuf
    # broadcast the last rank's buffer to every rank
    last = torch.tensor(idx == n - 1, device=x.device)
    return _ReduceFromGroup.apply(
        torch.where(last, ybuf, torch.zeros_like(ybuf)), group)


def pipelined(stage_fn: Callable, mesh, axis_name: str = "pipe"):
    """``f(stacked_params, x_microbatched)`` over ``mesh``'s
    ``axis_name`` (JAX :67-109):

    * stacked_params: the stage params tree with a leading stage dim of
      size ``mesh.shape[axis_name]`` on every leaf; each rank takes its
      own stage's slice (its gradient lands in that row);
    * x_microbatched: (M, mb, ...) input.

    Records the schedule's ``ppermute`` bytes (one microbatch a step,
    M + N - 1 steps) and the final ``psum``'s, as JAX does."""
    def run(stacked_params, x):
        from bigdl_tpu_torch.obs import collectives as C

        n = int(mesh.shape[axis_name])
        if n > 1:
            m = int(x.shape[0])
            mb_elems = x.numel() // max(1, m)
            C.record("ppermute", x.dtype,
                     C.ppermute_bytes(mb_elems, x.dtype, hops=m + n - 1),
                     axis_size=n)
            C.record("psum", x.dtype,
                     C.all_reduce_bytes(x.numel(), x.dtype, n), axis_size=n)
        idx = mesh.index(axis_name)
        params = _tree_map(lambda a: a[idx], stacked_params)
        return pipeline_apply(stage_fn, params, x, mesh.group(axis_name))

    return run


__all__ = ["pipeline_apply", "pipelined"]
