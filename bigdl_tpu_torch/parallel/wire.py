"""Compressed collectives: one wire for every exchange.

Counterpart of ``bigdl_tpu/parallel/wire.py`` (:1-583).  One
:class:`WireSpec` (wire dtype ``bfloat16`` / ``int8`` / ``fp8_e4m3`` /
``fp8_e5m2``, blockwise scaling, optional error feedback) parameterizes
four collectives over a ``torch.distributed`` group (``None`` is the
world), where the JAX package names a ``shard_map`` axis:

* :func:`reduce_scatter`: the staged ring.  The partial sum of chunk
  ``c`` starts at rank ``c + 1`` and travels ``n - 1`` hops; each hop
  quantizes the partial (payload and per-block f32 scales on the wire),
  the receiver dequantizes and adds its own chunk in f32.  The hop is a
  ``send`` to rank ``(r + 1) % n`` and a ``recv`` from ``(r - 1) % n``
  (``lax.ppermute`` there); the payload travels as bytes
  (``.view(torch.uint8)``: NCCL has no float8 type) and the scales as a
  second message, in that order;
* :func:`psum`: the staged ring, then an all-gather of the quantized
  owner shards;
* :func:`all_to_all` / :func:`ppermute`: quantize, move payload and
  scales, dequantize; both differentiable (``torch.autograd.Function``),
  the backward riding the same wire the other way.

**Error feedback**: each rank keeps the quantization error it made last
round, one row per chunk in flat coordinates, and adds it back before
the next quantization (``ef`` of :func:`reduce_scatter`).

The arithmetic is the JAX package's, in its order: ``scale =
max(amax / qmax, 1e-30)``, ``q = x / scale``, ``round`` (half to even,
int8 only), ``clip(-qmax, qmax)``, the cast; a hop adds ``(recv +
chunk) + ef``.  The quantizers are plain torch ops, as they are
``jnp`` work outside any Pallas kernel there.  The planners
(:func:`padded_elems`, :func:`plan_buckets`, :func:`bucket_param_coords`,
:func:`buckets_equal`) are numpy and give the JAX package's layouts,
so checkpoints cross the packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "WireSpec",
    "WIRE_DTYPES",
    "UNCOMPRESSED",
    "resolve",
    "quantize",
    "dequantize",
    "roundtrip",
    "reduce_scatter",
    "psum_layout",
    "psum",
    "effective_block",
    "all_to_all",
    "ppermute",
    "padded_elems",
    "plan_buckets",
    "bucket_param_coords",
    "buckets_equal",
]

# wire dtype name -> (numpy spelling, symmetric clip max); bfloat16 is
# the scale-free member (the cast is the quantizer)
WIRE_DTYPES = {
    "bfloat16": ("bfloat16", None),
    "int8": ("int8", 127.0),
    "fp8_e4m3": ("float8_e4m3fn", 448.0),
    "fp8_e5m2": ("float8_e5m2", 57344.0),
}

# spellings of the uncompressed pass-through
UNCOMPRESSED = ("float32", "none")

_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """How bytes leave the card: wire dtype, blockwise scaling and
    error feedback (JAX :92-162).  ``block`` is the elements per scale
    of the scaled dtypes; ``error_feedback`` carries each rank's
    quantization residual across rounds (:func:`reduce_scatter`
    only)."""

    dtype: str = "bfloat16"
    block: int = 512
    error_feedback: bool = False

    def __post_init__(self):
        if self.dtype not in WIRE_DTYPES and self.dtype not in UNCOMPRESSED:
            raise ValueError(
                f"wire dtype {self.dtype!r} not supported; choose one of "
                f"{sorted(WIRE_DTYPES) + list(UNCOMPRESSED)}")
        if self.block < 1:
            raise ValueError(f"wire block must be positive, got "
                             f"{self.block}")
        if self.error_feedback and not self.compressed:
            raise ValueError(
                "error feedback needs a compressed wire dtype "
                f"(got {self.dtype!r}: nothing is quantized, there is "
                "no error to feed back)")

    @property
    def compressed(self) -> bool:
        """Anything that loses bits on the wire (bfloat16 included)."""
        return self.dtype in WIRE_DTYPES

    @property
    def scaled(self) -> bool:
        """Carries per-block f32 scales beside the payload."""
        return WIRE_DTYPES.get(self.dtype, (None, None))[1] is not None

    @property
    def wire_name(self) -> str:
        """The dtype name the byte accounting records (numpy's)."""
        if self.dtype in WIRE_DTYPES:
            return WIRE_DTYPES[self.dtype][0]
        return "float32"

    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def qmax(self) -> Optional[float]:
        return WIRE_DTYPES.get(self.dtype, (None, None))[1]

    @classmethod
    def from_config(cls, dtype: Optional[str] = None,
                    block: Optional[int] = None,
                    error_feedback: Optional[bool] = None) -> "WireSpec":
        """Unset fields from ``BIGDL_TORCH_WIRE_DTYPE`` /
        ``BIGDL_TORCH_WIRE_BLOCK`` / ``BIGDL_TORCH_WIRE_EF``."""
        from bigdl_tpu_torch.config import TrainConfig

        cfg = TrainConfig.from_env()
        return cls(
            dtype=cfg.wire_dtype if dtype is None else dtype,
            block=cfg.wire_block if block is None else int(block),
            error_feedback=(cfg.wire_ef if error_feedback is None
                            else bool(error_feedback)),
        )


def resolve(wire) -> Optional[WireSpec]:
    """A ``wire=`` argument as a spec: None stays None, a dtype string
    becomes a config-defaulted spec, a :class:`WireSpec` passes; an
    uncompressed spec becomes None."""
    if wire is None:
        return None
    if isinstance(wire, str):
        wire = WireSpec.from_config(dtype=wire)
    if not isinstance(wire, WireSpec):
        raise TypeError(f"wire must be a WireSpec, dtype string or None; "
                        f"got {type(wire).__name__}")
    return wire if wire.compressed else None


def padded_elems(n_elems: int, spec: Optional[WireSpec],
                 n_shards: int) -> int:
    """``n_elems`` padded to the wire's quantum: whole blocks a shard
    for the scaled dtypes, whole shards otherwise."""
    quantum = n_shards * (spec.block if spec is not None and spec.scaled
                          else 1)
    return n_elems + (-n_elems) % quantum


# ------------------------------------------------------------- buckets
def plan_buckets(padded: int, quantum: int, target_elems: int):
    """Contiguous ``(start, size)`` buckets of ``[0, padded)``, each a
    positive multiple of ``quantum`` and about ``target_elems`` long
    (JAX :190); ``target_elems <= 0`` gives the one monolithic
    bucket."""
    q = max(1, int(quantum))
    padded = int(padded)
    if padded % q:
        raise ValueError(f"padded length {padded} not a multiple of the "
                         f"alignment quantum {q}")
    if target_elems is None or int(target_elems) <= 0 or padded == 0:
        return [(0, padded)]
    per = max(q, ((int(target_elems) + q - 1) // q) * q)
    out = []
    start = 0
    while start < padded:
        size = min(per, padded - start)
        out.append((start, size))
        start += size
    return out


def bucket_param_coords(buckets, n_shards: int) -> np.ndarray:
    """The shard-major -> flat index map of a bucketed layout (JAX
    :219): the element at shard-major position ``p`` (rank ``p //
    shard_len``) is flat coordinate ``coords[p]``; the identity for one
    bucket."""
    buckets = [(int(s), int(z)) for s, z in buckets]
    n = int(n_shards)
    padded = sum(z for _, z in buckets)
    shard_len = padded // n
    coords = np.empty(padded, np.int64)
    for d in range(n):
        off = d * shard_len
        for s, z in buckets:
            c = z // n
            coords[off:off + c] = np.arange(s + d * c, s + (d + 1) * c,
                                            dtype=np.int64)
            off += c
    return coords


def buckets_equal(a, b) -> bool:
    """Do two bucket plans (None, or lists from a JSON manifest) lay
    the vector out alike?  None equals any one-bucket plan."""
    norm = lambda p: None if p is None or len(p) <= 1 \
        else [(int(s), int(z)) for s, z in p]
    return norm(a) == norm(b)


# ----------------------------------------------------------- quantizers
def _blocked(x: torch.Tensor, block: int):
    """(the flat operand zero-padded to whole blocks as rows, its
    padded length)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block), flat.numel()


def quantize(x: torch.Tensor, spec: WireSpec):
    """``(payload, scales)`` of ``x`` on the wire; ``scales`` is None
    for bfloat16 (a cast).  The scaled dtypes take the flat operand in
    ``block``-element groups (zero-padded): ``scale = max(amax / qmax,
    1e-30)``, so an element's error is at most its block's ``amax /
    (2 * qmax)`` (int8: amax / 254)."""
    if not spec.scaled:
        return x.to(torch.bfloat16), None
    xb, _ = _blocked(x.float(), spec.block)
    amax = xb.abs().amax(dim=1)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by
    # its reciprocal, one ulp from the division the CPU (and eager JAX)
    # make
    scale = torch.clamp_min(amax / amax.new_full((), spec.qmax), 1e-30)
    q = xb / scale[:, None]
    if spec.dtype == "int8":
        # a float->int cast truncates; the amax/254 bound needs the
        # nearest (half to even, as jnp.round)
        q = torch.round(q)
    payload = torch.clamp(q, -spec.qmax, spec.qmax).to(spec.torch_dtype())
    return payload, scale


def dequantize(payload: torch.Tensor, scales, spec: WireSpec, shape=None):
    """The f32 inverse of :func:`quantize`; ``shape`` restores the
    operand's shape (dropping the block padding)."""
    if scales is None:
        out = payload.float()
        return out if shape is None else out.reshape(shape)
    out = (payload.float() * scales[:, None]).reshape(-1)
    if shape is not None:
        n = 1
        for d in shape:
            n *= int(d)
        out = out[:n].reshape(shape)
    return out


def _qdq(x, spec):
    return dequantize(*quantize(x, spec), spec, shape=x.shape).to(x.dtype)


class _RoundTrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        return _qdq(x, spec)

    @staticmethod
    def backward(ctx, ct):
        return _qdq(ct, ctx.spec), None


def roundtrip(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` through the wire and back (what a receiver sees).  The
    backward compresses the cotangent through the same wire (JAX's
    ``custom_vjp``, :314)."""
    spec = resolve(spec)
    if spec is None:
        return x
    return _RoundTrip.apply(x, spec)


# ---------------------------------------------------------- point to point
def _group_info(group, n_shards: int):
    import torch.distributed as dist

    n = int(n_shards)
    if dist.get_world_size(group) != n:
        raise ValueError(f"group of {dist.get_world_size(group)} ranks, "
                         f"n_shards {n}")
    return dist.get_rank(group)


def _global(group, r: int) -> int:
    import torch.distributed as dist

    return r if group is None else dist.get_global_rank(group, r)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as its bytes (the wire of any dtype, float8 included)."""
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8)


def _sendrecv(t: torch.Tensor, dst: Optional[int], src: Optional[int],
              group) -> Optional[torch.Tensor]:
    """Send ``t`` to group rank ``dst`` and receive a tensor of its
    shape and dtype from ``src`` (either may be None); returns the
    received tensor or None."""
    import torch.distributed as dist

    ops, buf = [], None
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, _as_bytes(t), _global(group, dst),
                              group))
    if src is not None:
        buf = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                          device=t.device)
        ops.append(dist.P2POp(dist.irecv, buf, _global(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if buf is None:
        return None
    return buf.view(t.dtype).reshape(t.shape)


def _ring_hop(t: torch.Tensor, idx: int, n: int, group) -> torch.Tensor:
    """One ring hop: ``t`` to rank ``idx + 1``, the result from ``idx -
    1``."""
    return _sendrecv(t, (idx + 1) % n, (idx - 1) % n, group)


# ------------------------------------------------------ staged ring reduce
def reduce_scatter(g: torch.Tensor, group, n_shards: int, spec, ef=None):
    """The staged ring reduce-scatter with in-reduce quantization (JAX
    :340).  ``g`` is this rank's flat operand (length divisible by
    ``n_shards``, and by ``n_shards * block`` for the scaled dtypes);
    rank ``r`` gets the reduced chunk ``r``.  ``ef`` is this rank's
    residual, ``(n_shards, chunk)`` (row ``c`` for chunk ``c``), added
    before each quantization and replaced by the new error.  Returns
    ``(chunk, new_ef)``; at ``n_shards == 1`` ``(g in f32, ef)`` with
    no collective."""
    import torch.distributed as dist

    spec = resolve(spec)
    n = int(n_shards)
    if n == 1:
        return g.float(), ef
    idx = _group_info(group, n)
    if spec is None:
        out = g.new_empty(g.numel() // n)
        dist.reduce_scatter_tensor(out, g.contiguous(), group=group)
        return out.float(), ef
    if g.numel() % n:
        raise ValueError(f"operand length {g.numel()} not divisible by "
                         f"{n} shards")
    chunk_len = g.numel() // n
    if spec.scaled and chunk_len % spec.block:
        raise ValueError(
            f"chunk length {chunk_len} not divisible by wire block "
            f"{spec.block}; pad the operand to padded_elems() first")
    chunks = g.float().reshape(n, chunk_len)
    c = (idx - 1) % n
    acc = chunks[c]
    new_ef = None
    if ef is not None:
        acc = acc + ef[c]
        new_ef = torch.zeros_like(ef)
    for _hop in range(n - 1):
        payload, scales = quantize(acc, spec)
        if ef is not None:
            new_ef[c] = acc - dequantize(payload, scales, spec,
                                         shape=acc.shape)
        payload = _ring_hop(payload, idx, n, group)
        if scales is not None:
            scales = _ring_hop(scales, idx, n, group)
        recv = dequantize(payload, scales, spec, shape=acc.shape)
        c = (c - 1) % n
        acc = recv + chunks[c]
        if ef is not None:
            acc = acc + ef[c]
    # after n - 1 hops c == idx: the own chunk's last add was exact, so
    # its residual row stays zero
    return acc, new_ef


def psum_layout(n_elems: int, spec: WireSpec, n_shards: int):
    """``(padded_elems, effective_block)`` of a :func:`psum` operand:
    the block shrinks to a small operand's chunk (JAX :414)."""
    n = int(n_shards)
    chunk = -(-int(n_elems) // n)
    if not spec.scaled:
        return chunk * n, spec.block
    b = max(1, min(spec.block, chunk))
    chunk += (-chunk) % b
    return chunk * n, b


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """Tiled all-gather of ``t``'s rows (as bytes), rank-major."""
    import torch.distributed as dist

    src = _as_bytes(t)
    out = torch.empty(src.numel() * n, dtype=torch.uint8, device=t.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view(t.dtype).reshape((n * t.shape[0],) + tuple(t.shape[1:]))


def psum(x: torch.Tensor, group, n_shards: int, spec, ef=None):
    """Compressed all-reduce (JAX :424): the staged ring, then an
    all-gather of the quantized owner shards.  Returns ``(value,
    new_ef)``, the sum in ``x``'s shape (f32)."""
    import torch.distributed as dist

    spec = resolve(spec)
    n = int(n_shards)
    if n == 1:
        return x.float(), ef
    if spec is None:
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out, ef
    shape = x.shape
    flat = x.float().reshape(-1)
    padded, block = psum_layout(flat.numel(), spec, n)
    spec = WireSpec(spec.dtype, block, spec.error_feedback)
    if padded != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(padded - flat.numel())])
    shard, new_ef = reduce_scatter(flat, group, n, spec, ef=ef)
    payload, scales = quantize(shard, spec)
    payload = _all_gather(payload, n, group)
    if scales is not None:
        scales = _all_gather(scales, n, group)
    full = dequantize(payload, scales, spec)
    return full[:x.numel()].reshape(shape), new_ef


# ------------------------------------------------------ compressed moves
def effective_block(slice_elems: int, block: int) -> int:
    """The largest block <= ``block`` that divides ``slice_elems``
    (JAX :462)."""
    b = max(1, min(int(block), int(slice_elems)))
    while slice_elems % b:
        b -= 1
    return b


def _a2a_rows(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """``all_to_all`` of ``(n, ...)`` rows: row ``j`` goes to rank
    ``j``; the result's row ``j`` came from rank ``j``."""
    import torch.distributed as dist

    src = t.contiguous().reshape(n, -1).view(torch.uint8)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.view(t.dtype).reshape(t.shape)


def _tiled_a2a(v: torch.Tensor, n: int, group, sa: int, ca: int):
    """``lax.all_to_all(tiled=True)``: ``v`` split into ``n`` slices
    along ``sa``, slice ``j`` to rank ``j``, the received slices
    concatenated along ``ca`` in source order."""
    moved = torch.movedim(v, sa, 0)
    s_len = moved.shape[0]
    rows = moved.reshape((n, s_len // n) + tuple(moved.shape[1:]))
    recv = _a2a_rows(rows, n, group)
    return _reassemble(recv, moved.shape, n, sa, ca)


def _reassemble(recv, moved_shape, n, sa, ca):
    """(n, s_len / n, *rest) rows from each source -> the tiled concat
    layout of ``lax.all_to_all`` (JAX :521-536)."""
    s_len = moved_shape[0]
    recv = recv.reshape((n, s_len // n) + tuple(moved_shape[1:]))
    if ca == sa:
        out = recv.reshape((s_len,) + tuple(moved_shape[1:]))
    else:
        q = ca + (1 if ca < sa else 0)
        out = torch.movedim(recv, 0, q)
        shape = list(out.shape)
        shape[q:q + 2] = [shape[q] * shape[q + 1]]
        out = out.reshape(shape)
    return torch.movedim(out, 0, sa)


def _a2a_exchange(v, n, group, spec, sa, ca):
    if not spec.scaled:
        w = v.to(torch.bfloat16)
        return _tiled_a2a(w, n, group, sa, ca).to(v.dtype)
    moved = torch.movedim(v.float(), sa, 0)
    rows = moved.reshape(n, -1)
    b = effective_block(rows.shape[1], spec.block)
    row_spec = WireSpec(spec.dtype, b, False)
    payload, scales = quantize(rows, row_spec)
    payload = _a2a_rows(payload.reshape(n, -1), n, group)
    scales = _a2a_rows(scales.reshape(n, -1), n, group)
    recv = dequantize(payload.reshape(-1, b), scales.reshape(-1), row_spec)
    return _reassemble(recv, moved.shape, n, sa, ca).to(v.dtype)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, group, spec, sa, ca):
        ctx.args = (n, group, spec, sa, ca)
        return _a2a_exchange(x, n, group, spec, sa, ca)

    @staticmethod
    def backward(ctx, ct):
        n, group, spec, sa, ca = ctx.args
        # the transpose swaps split and concat; the cotangent rides the
        # same compressed wire home
        return (_a2a_exchange(ct.contiguous(), n, group, spec, ca, sa),
                None, None, None, None, None)


class _PlainAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, group, sa, ca):
        ctx.args = (n, group, sa, ca)
        return _tiled_a2a(x, n, group, sa, ca)

    @staticmethod
    def backward(ctx, ct):
        n, group, sa, ca = ctx.args
        return (_tiled_a2a(ct.contiguous(), n, group, ca, sa),
                None, None, None, None)


def all_to_all(x: torch.Tensor, group, n_shards: int, spec, *,
               split_axis: int = 0, concat_axis: int = 0):
    """``lax.all_to_all(tiled)`` with payload and per-block scales on
    the wire (JAX :473): each destination's slice is quantized in flat
    blocks (block shrunk to tile it, :func:`effective_block`).
    Differentiable."""
    spec = resolve(spec)
    n = int(n_shards)
    if n == 1:
        return x
    _group_info(group, n)
    if spec is None:
        return _PlainAllToAll.apply(x, n, group, split_axis, concat_axis)
    return _AllToAll.apply(x, n, group, spec, split_axis, concat_axis)


def _permute(v: torch.Tensor, idx: int, perm, group, spec):
    """One ``lax.ppermute``: ``v`` to this rank's destination, the
    source's value back (zeros where no rank sends here)."""
    dst = next((d for s, d in perm if s == idx), None)
    src = next((s for s, d in perm if d == idx), None)
    if spec is None:
        out = _sendrecv(v, dst, src, group)
        return torch.zeros_like(v) if out is None else out
    if not spec.scaled:
        out = _sendrecv(v.to(torch.bfloat16), dst, src, group)
        return (torch.zeros_like(v) if out is None
                else out.float().to(v.dtype))
    payload, scales = quantize(v, spec)
    payload = _sendrecv(payload, dst, src, group)
    scales = _sendrecv(scales, dst, src, group)
    if payload is None:
        return torch.zeros_like(v)
    return dequantize(payload, scales, spec, shape=v.shape).to(v.dtype)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, perm, group, spec):
        ctx.args = (idx, perm, group, spec)
        return _permute(x, idx, perm, group, spec)

    @staticmethod
    def backward(ctx, ct):
        idx, perm, group, spec = ctx.args
        inv = [(d, s) for s, d in perm]
        return (_permute(ct.contiguous(), idx, inv, group, spec),
                None, None, None, None)


def ppermute(x: torch.Tensor, group, perm, spec):
    """``lax.ppermute`` with payload and scales on the wire (JAX :548):
    ``perm`` is ``(source, destination)`` group ranks.  Differentiable:
    the cotangent takes the inverted permutation through the same
    wire."""
    import torch.distributed as dist

    spec = resolve(spec)
    perm = [(int(s), int(d)) for s, d in perm]
    idx = dist.get_rank(group)
    return _PPermute.apply(x, idx, perm, group, spec)
