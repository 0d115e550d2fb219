"""Tensor parallelism over a mesh axis of ``torch.distributed`` ranks.

Counterpart of ``bigdl_tpu/parallel/tensor_parallel.py``.  The JAX
package places parameters with ``NamedSharding``s and lets GSPMD insert
the collectives.  The port has no GSPMD: each process is one rank of
the mesh (``Engine.build_mesh``), "placed on the mesh" means "this rank
holds its slice", and the collectives the layout implies are explicit.

* ``TRANSFORMER_TP_RULES`` (JAX :30-41): (path regex, spec) pairs,
  Megatron's layout.  ``wq/wk/wv`` and ``fc1`` are split on their rows
  (output features: each rank computes its own heads and hidden units),
  ``wo`` and ``fc2`` on their columns (their products are partial sums,
  all-reduced after), the embeddings on the feature dim and the vocab
  head on the vocab rows.  Weights are (out_features, in_features),
  applied as ``x @ W.T``.
* :func:`param_specs` mirrors a ``params()`` tree with a spec tuple per
  leaf (``()`` = replicated); an axis that does not divide its dim
  drops the leaf to replicated (JAX :75-86).
* :func:`shard_params` gives each rank its local slice of every split
  leaf (at its ``mesh.index(axis)``) and records the
  ``tp_shard_params`` bytes of the split leaves (JAX :103-114).
* :func:`tp_lm_forward` is the forward of a ``TransformerLM`` over
  those local shards, the port's counterpart of JAX's jitted
  ``model.apply`` on ``shard_params``' output.  Each collective is a
  ``torch.autograd.Function`` with Megatron's pairing: the identity
  whose backward all-reduces in front of a column-parallel product, the
  all-reduce whose backward is the identity after a row-parallel one,
  and a gather along the last dim whose backward takes this rank's
  slice (the feature-split embeddings, the vocab-split head).  Every
  rank computes the same replicated loss from the replicated logits;
  its backward then gives each rank the gradient of its own shards and
  the whole gradient of the replicated leaves.
* :func:`constrain` is an identity on values: it only records the
  ``sharding_constraint`` budget JAX records (:224-229).
* :func:`wire_psum` / :func:`gradient_psum`: the compressed all-reduce
  of ``parallel/wire`` over an axis's process group, and a tree of
  per-rank gradient contributions summed over a mesh axis with JAX's
  byte accounting (:165-191).  Where JAX takes every device's
  contribution stacked on a leading ``n`` dim, each rank here passes its
  own, with no leading dim (the convention of the ``*_sharded`` forms).
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.attention import layer_norm
from bigdl_tpu_torch.parallel.ulysses import _group_size

# (path regex, spec): specs are tuples of axis names / None, one entry
# per leading dim
TRANSFORMER_TP_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r"attn/w[qkv]$", ("model", None)),
    (r"attn/b[qkv]$", ("model",)),
    (r"attn/wo$", (None, "model")),
    # TransformerBlock MLP: fc1 column-parallel, fc2 row-parallel
    (r"fc1/weight$", ("model", None)),
    (r"fc1/bias$", ("model",)),
    (r"fc2/weight$", (None, "model")),
    # TransformerLM embeddings: split the feature dim
    (r"w[tp]e/weight$", (None, "model")),
    (r"head/weight$", ("model", None)),
)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else str(k))
    elif tree is not None:
        yield prefix, tree


def _match(path: str, rules: Iterable[Tuple[str, tuple]]):
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return None


def param_specs(params, mesh, rules=TRANSFORMER_TP_RULES):
    """The params tree with a spec tuple per leaf: the first matching
    rule's, or ``()`` (replicated) where none matches or an axis does
    not divide its dim.  ``mesh`` needs only ``.shape`` (axis -> size)."""
    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if tree is None:
            return None
        spec = _match(prefix, rules)
        if spec is not None:
            shape = tuple(tree.shape)
            if all(a is None or (i < len(shape)
                                 and shape[i] % int(mesh.shape[a]) == 0)
                   for i, a in enumerate(spec)):
                return tuple(spec)
        return ()

    return build(params)


def _local(leaf, spec, mesh):
    """This rank's slice of ``leaf`` under ``spec`` (a new tensor), or
    the leaf itself where nothing splits."""
    if not any(a is not None for a in spec):
        return leaf
    out = leaf.detach()
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = out.shape[dim] // int(mesh.shape[axis])
        out = out.narrow(dim, mesh.index(axis) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def local_tree(params, specs, mesh):
    """``params`` with every split leaf replaced by this rank's slice
    (replicated leaves stay the same tensors); no accounting."""
    if isinstance(params, dict):
        return {k: local_tree(v, specs[k], mesh) for k, v in params.items()}
    if params is None:
        return None
    return _local(params, specs, mesh)


def shard_params(params, mesh, rules=TRANSFORMER_TP_RULES):
    """This rank's local tree of ``params`` (a ``params()`` tree) under
    ``rules``: each split leaf sliced at the rank's mesh coordinate, the
    replicated ones as they are.  Records, per dtype, the bytes of every
    leaf that splits (the initial scatter the TP layout costs)."""
    from bigdl_tpu_torch.obs import collectives as C

    specs = param_specs(params, mesh, rules)
    moved: dict = {}
    for (_, leaf), (_, spec) in zip(_walk(params), _walk(specs)):
        if any(a is not None for a in spec):
            name = C._dtype_name(leaf.dtype)
            moved[name] = moved.get(name, 0.0) + (
                leaf.numel() * C.dtype_bytes(name))
    for name, nbytes in moved.items():
        C.record("tp_shard_params", name, nbytes)
    return local_tree(params, specs, mesh)


def wire_psum(x, group, wire=None, ef=None):
    """All-reduce of ``x`` over ``group`` (the axis's process group,
    where JAX names a shard_map axis) on the wire: with ``wire`` unset
    a plain all-reduce, with a compressed spec ``parallel/wire.psum``'s
    staged ring and quantized all-gather.  ``ef`` threads this rank's
    error-feedback residual; returns ``(value, new_ef)``."""
    from bigdl_tpu_torch.parallel import wire as W

    return W.psum(x, group, _group_size(group), W.resolve(wire), ef=ef)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [tree]


def gradient_psum(grads, mesh, axis: str = "model", wire=None):
    """Sum the ranks' gradient contributions over ``mesh``'s ``axis``
    with an opt-in compressed wire: the explicit form of the gradient
    psums a TP layout needs.  Each rank passes ITS OWN contribution
    (the JAX package takes all of them stacked on a leading ``n`` dim);
    every leaf must have the same shape on every rank of the axis.
    Returns the summed tree (f32).  Byte accounting from the shapes, as
    JAX's: uncompressed psums record the leaf dtype's ring all-reduce, a
    compressed wire the staged ring and quantized gather's bytes, and
    publishes the ``path="tp"`` savings ratio."""
    import torch.distributed as dist

    from bigdl_tpu_torch.obs import collectives as C
    from bigdl_tpu_torch.parallel import wire as W

    spec = W.resolve(wire)
    n = int(mesh.shape[axis])
    leaves = _tree_leaves(grads)
    if n > 1:
        shapes = [tuple(x.shape) for x in leaves]
        seen = [None] * n
        dist.all_gather_object(seen, shapes, group=mesh.group(axis))
        for r, other in enumerate(seen):
            if other != shapes:
                raise ValueError(
                    f"gradient_psum leaves need the same shapes on every "
                    f"{axis!r} rank ({n}); rank {mesh.index(axis)} has "
                    f"{shapes}, rank {r} {other}")
        baseline = wire_bytes = 0.0
        for leaf in leaves:
            sz = leaf.numel()
            baseline += C.all_reduce_bytes(sz, leaf.dtype, n)
            if spec is None:
                wire_bytes += C.all_reduce_bytes(sz, leaf.dtype, n)
            elif not spec.scaled:
                wire_bytes += C.all_reduce_bytes(sz, "bfloat16", n)
            else:
                padded, blk = W.psum_layout(sz, spec, n)
                ex = C.staged_ring_exchange_bytes(padded, n, blk,
                                                  spec.wire_name)
                wire_bytes += sum(ex.values())
                wire_bytes += C.all_gather_bytes(padded, spec.wire_name, n)
                wire_bytes += C.all_gather_bytes(padded // blk, "float32", n)
        name = spec.wire_name if spec is not None else "float32"
        C.record("psum", name, wire_bytes, axis_size=n)
        if spec is not None:
            C.record_savings("tp", baseline, wire_bytes)
    if n == 1:
        return _tree_map(lambda g: g.float(), grads)
    group = mesh.group(axis)
    return _tree_map(lambda g: W.psum(g, group, n, spec)[0].float(), grads)


def constrain(x, mesh, *spec_axes):
    """``with_sharding_constraint``'s counterpart: ``x`` as it is (a
    rank's tensor has no layout to pin), with the
    ``sharding_constraint`` budget JAX records: ``x``'s bytes when an
    axis named in the spec has more than one rank."""
    axes = [a for a in spec_axes if a is not None]
    if axes and any(int(mesh.shape[a]) > 1 for a in axes):
        from bigdl_tpu_torch.obs import collectives as C

        C.record("sharding_constraint", x.dtype,
                 x.numel() * C.dtype_bytes(x.dtype))
    return x


# ------------------------------------------------- the TP forward's collectives
class _CopyToGroup(torch.autograd.Function):
    """In front of a column-parallel product: the identity, whose
    backward all-reduces the partial input gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """After a row-parallel product: the all-reduce of the partial
    sums, whose backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """The ranks' slices concatenated along the last dim in rank order;
    the backward takes this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, n, idx):
        import torch.distributed as dist

        ctx.args = (n, idx)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, idx = ctx.args
        size = g.shape[-1] // n
        return g.narrow(-1, idx * size, size).contiguous(), None, None, None


def _split_on(spec, dim, axis) -> bool:
    return len(spec) > dim and spec[dim] == axis


def tp_lm_forward(model, params, tokens, mesh, *, axis: str = "model"):
    """Logits (B, T, vocab), the same on every rank of ``mesh``'s
    ``axis``, of ``model`` (a ``TransformerLM``, for its shapes, norms'
    eps and ``attn_impl``) over ``params``, this rank's local tree from
    :func:`shard_params` with ``TRANSFORMER_TP_RULES``.  Each rank's attention runs
    ``dot_product_attention`` over its H/n heads with the model's
    ``attn_impl``.  Differentiable in ``params`` (every rank then
    computes the same loss; see the module docstring).  No dropout: a
    model with ``dropout > 0`` in training mode raises."""
    from bigdl_tpu_torch.ops.attention import dot_product_attention

    if model.training and model.dropout > 0:
        raise ValueError("tp_lm_forward applies no dropout; call it on a "
                         "model with dropout 0 or in evaluate mode")
    n = int(mesh.shape[axis])
    group = mesh.group(axis)
    idx = mesh.index(axis)
    specs = param_specs(model.params(), mesh)
    heads = model.n_head

    def copy(x):
        return x if n == 1 else _CopyToGroup.apply(x, group)

    def reduce(x):
        return x if n == 1 else _ReduceFromGroup.apply(x, group)

    def gather(x):
        return x if n == 1 else _GatherFromGroup.apply(x, group, n, idx)

    def lin(x, w, b=None):
        y = torch.matmul(x, w.t())
        return y if b is None else y + b

    tok = tokens.long()
    t = tok.shape[1]
    wte, wpe = params["wte"]["weight"], params["wpe"]["weight"]
    te, pe = wte[tok], wpe[:t]
    te = gather(te) if _split_on(specs["wte"]["weight"], 1, axis) else te
    pe = gather(pe) if _split_on(specs["wpe"]["weight"], 1, axis) else pe
    x = te + pe[None]
    for i, block in enumerate(model.blocks()):
        p, sp = params[f"h{i}"], specs[f"h{i}"]
        pa = p["attn"]
        attn_split = _split_on(sp["attn"]["wq"], 0, axis)
        if attn_split and heads % n:
            raise ValueError(f"{heads} heads do not split over {n} "
                             f"{axis!r} ranks")
        h_loc = heads // n if attn_split else heads
        h = layer_norm(x, p["ln1"]["weight"], p["ln1"]["bias"],
                       block.ln1.eps)
        h = copy(h) if attn_split else h
        q, k, v = (lin(h, pa[w], pa.get(b)) for w, b in
                   (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        b_, t_, f = q.shape
        hd = f // h_loc

        def split(z):
            return z.reshape(b_, t_, h_loc, hd).transpose(1, 2)

        o = dot_product_attention(split(q), split(k), split(v),
                                  causal=block.attn.causal,
                                  scale=1.0 / math.sqrt(hd),
                                  impl=block.attn.attn_impl)
        o = o.transpose(1, 2).reshape(b_, t_, f)
        y = torch.matmul(o, pa["wo"].t())
        y = reduce(y) if _split_on(sp["attn"]["wo"], 1, axis) else y
        if pa.get("bo") is not None:
            y = y + pa["bo"]
        x = x + y
        h = layer_norm(x, p["ln2"]["weight"], p["ln2"]["bias"],
                       block.ln2.eps)
        fc1_split = _split_on(sp["fc1"]["weight"], 0, axis)
        h = copy(h) if fc1_split else h
        h = F.gelu(lin(h, p["fc1"]["weight"], p["fc1"].get("bias")),
                   approximate="tanh")
        h = torch.matmul(h, p["fc2"]["weight"].t())
        h = reduce(h) if _split_on(sp["fc2"]["weight"], 1, axis) else h
        if p["fc2"].get("bias") is not None:
            h = h + p["fc2"]["bias"]
        x = x + h
    h = layer_norm(x, params["ln_f"]["weight"], params["ln_f"]["bias"],
                   model.ln_f.eps)
    if _split_on(specs["head"]["weight"], 0, axis):
        return gather(torch.matmul(copy(h), params["head"]["weight"].t()))
    return torch.matmul(h, params["head"]["weight"].t())


__all__ = ["TRANSFORMER_TP_RULES", "param_specs", "shard_params",
           "local_tree", "wire_psum", "gradient_psum", "constrain",
           "tp_lm_forward"]
