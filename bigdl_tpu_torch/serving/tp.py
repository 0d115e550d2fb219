"""TP-sharded decode over the compressed-collective wire.

Counterpart of ``bigdl_tpu/serving/tp.py``.  Decode is memory-bound:
one token's matmuls stream every weight byte a step, so splitting the
weights ``tp`` ways divides each rank's bytes (and the KV cache, split
on the head axis) at the price of two small all-reduces a block,
Megatron's two, run through ``parallel.wire_psum`` so that an int8/fp8
wire compresses the only bytes serving puts between the cards.

Layout (``SERVE_TP_RULES``): attention wq/wk/wv rows (= heads) and fc1
rows split over ``model``; wo and fc2 columns split (their products are
partial sums, all-reduced after, and their biases added once, after the
reduction); embeddings, LayerNorms and the vocab head replicated, so
every rank computes the same logits and samples the same token.

Where the JAX package runs the step under ``shard_map`` on ``tp``
devices of one host, each rank here is a process of the mesh's
``model`` axis (``Engine.build_mesh({"model": tp})``) that runs the
step on its own shard; ``LMEngine(tp=...)`` makes group rank 0 the
leader that schedules and the others followers that replay its steps.
Prefill stays replicated: every rank runs the full model over the
prompt and writes its own heads' K/V into its pages.

The per-step wire footprint is static (``2 * n_layer`` all-reduces of
``(batch, dim)`` f32) and is recorded once at build time
(``bigdl_collective_bytes_total{op="serve_tp_psum"}`` plus the
``path="serve"`` wire-savings gauge).
"""

from __future__ import annotations

from bigdl_tpu_torch.parallel import wire as W
from bigdl_tpu_torch.parallel.tensor_parallel import (local_tree,
                                                      param_specs, wire_psum)

# Megatron row/col split for the serving decode step (paths of the
# TransformerLM params tree); everything unmatched is replicated
SERVE_TP_RULES = (
    (r"attn/w[qkv]$", ("model", None)),
    (r"attn/b[qkv]$", ("model",)),
    (r"attn/wo$", (None, "model")),
    (r"fc1/weight$", ("model", None)),
    (r"fc1/bias$", ("model",)),
    (r"fc2/weight$", (None, "model")),
)


def _account(n_layer: int, batch: int, dim: int, tp: int, spec):
    """Static per-step byte model of the 2L block reductions; records
    the counter and the ``path="serve"`` savings gauge once."""
    from bigdl_tpu_torch.obs import collectives as C

    elems = batch * dim
    baseline = C.all_reduce_bytes(elems, "float32", tp) * 2 * n_layer
    if spec is None:
        wire_bytes = baseline
        name = "float32"
    elif not spec.scaled:
        wire_bytes = C.all_reduce_bytes(elems, "bfloat16", tp) * 2 * n_layer
        name = "bfloat16"
    else:
        padded, blk = W.psum_layout(elems, spec, tp)
        ex = sum(C.staged_ring_exchange_bytes(
            padded, tp, blk, spec.wire_name).values())
        ex += C.all_gather_bytes(padded, spec.wire_name, tp)
        ex += C.all_gather_bytes(padded // blk, "float32", tp)
        wire_bytes = ex * 2 * n_layer
        name = spec.wire_name
    C.record("serve_tp_psum", name, wire_bytes, axis_size=tp)
    if spec is not None:
        C.record_savings("serve", baseline, wire_bytes)
    return wire_bytes


class TPDecodeStep:
    """The engine's decode step on this rank's shard.  ``shard(params)``
    is this rank's local tree of a full ``params()`` tree;
    ``step(local, kp, vp, tables, lengths, tokens, temps, active,
    generator, attn_impl=None, attn_block_pages=0)`` runs
    ``paged_decode_math`` on it
    over the pools of the rank's ``n_head / tp`` heads, the block
    reductions on the wire, and returns every slot's next token (the
    same on every rank)."""

    def __init__(self, model, mesh, tp: int, spec, page_size: int,
                 attn_impl: str):
        self.model = model
        self.mesh = mesh
        self.spec = spec
        self.page_size = page_size
        self.attn_impl = attn_impl
        self.n_head = int(model.n_head) // tp
        self.group = mesh.group("model")
        self._specs = param_specs(model.params(), mesh, SERVE_TP_RULES)

    def shard(self, params) -> dict:
        return local_tree(params, self._specs, self.mesh)

    def _psum(self, x):
        return wire_psum(x, self.group, self.spec)[0].to(x.dtype)

    def __call__(self, local, kp, vp, tables, lengths, tokens, temps,
                 active, generator, *, attn_impl=None,
                 attn_block_pages: int = 0):
        from bigdl_tpu_torch.serving.engine import paged_decode_math

        return paged_decode_math(
            self.model, self.page_size, kp, vp, tables, lengths, tokens,
            temps, active, generator,
            attn_impl=attn_impl or self.attn_impl,
            attn_block_pages=attn_block_pages, params=local,
            n_head=self.n_head, psum=self._psum)


def build_tp_decode_step(model, *, tp: int, wire=None, page_size: int,
                         max_batch: int, positions: int,
                         attn_impl: str = "auto"):
    """The engine's decode step sharded ``tp`` ways over the ``model``
    axis of ``Engine.mesh()``, whose size must be ``tp``: a
    :class:`TPDecodeStep`.  ``attn_impl`` is the paged
    decode-attention dispatch (``ops/decode_attention.py``); the step
    sees the LOCAL head shard, so the tuner's ``decode_attn`` site keys
    on the per-rank shape.  Records the per-step wire bytes."""
    from bigdl_tpu_torch.engine import Engine

    del positions  # the pools carry the shapes; kept for the API
    tp = int(tp)
    n_head, dim = int(model.n_head), int(model.dim)
    hidden = int(model.mlp_ratio) * dim
    if n_head % tp or hidden % tp:
        raise ValueError(
            f"tp={tp} must divide n_head={n_head} and the MLP hidden "
            f"{hidden}")
    mesh = Engine.mesh()
    n = 1 if mesh is None else int(mesh.shape.get("model", 1))
    if n != tp:
        raise ValueError(f"tp={tp} but the mesh's 'model' axis has {n} "
                         "ranks (Engine.build_mesh({'model': tp}) on every "
                         "rank)")
    spec = W.resolve(wire)
    _account(model.n_layer, max_batch, dim, tp, spec)
    return TPDecodeStep(model, mesh, tp, spec, page_size, attn_impl)


__all__ = ["SERVE_TP_RULES", "build_tp_decode_step"]
