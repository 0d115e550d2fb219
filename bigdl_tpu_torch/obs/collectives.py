"""Collective traffic accounting: bytes on the wire, from shapes.

Counterpart of ``bigdl_tpu/obs/collectives.py`` (:1-280), with its
numbers: every collective the trainer programs is costed from the
shapes it already holds, never by reading a device value.  The cost
model is the ring algorithm's bytes a rank sends for an ``n``-way
collective over a ``payload``-byte operand:

====================  =======================================
op                    bytes sent per rank
====================  =======================================
all-reduce            ``2 * payload * (n-1) / n``
reduce-scatter        ``payload * (n-1) / n``
all-gather            ``payload * (n-1) / n``
all-to-all            ``payload * (n-1) / n``
ppermute              ``payload`` per hop
====================  =======================================

Hierarchical data axes are costed with ``n`` their product (the one-
ring upper bound).  :func:`record` accounts one collective;
:class:`StepFootprint` is the per-step form ``DistriOptimizer`` builds
once and ``commit()``s per resolved step (``bigdl_collective_bytes_
total{op,dtype}``, the per-step gauges and the savings-ratio gauge of
``obs/names.py``).
"""

from __future__ import annotations

import math
from typing import Optional
from bigdl_tpu_torch.obs import names

# dtypes numpy cannot name (bfloat16, float8), plus the common spellings;
# numpy's itemsize for everything else
_DTYPE_BYTES = {
    "bfloat16": 2, "float16": 2, "half": 2,
    "float32": 4, "float": 4, "int32": 4, "uint32": 4,
    "float64": 8, "int64": 8, "uint64": 8,
    "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "float8_e4m3": 1,
    "float8_e4m3b11_fnuz": 1, "float8_e5m2fnuz": 1, "float8_e4m3fnuz": 1,
    "float4_e2m1fn": 1,
}


def _dtype_name(dtype) -> str:
    """The numpy spelling of a dtype given as a string, a numpy dtype
    or a torch dtype (``torch.float32`` -> ``"float32"``)."""
    if isinstance(dtype, str):
        return dtype
    name = getattr(dtype, "name", None)
    if name is not None:
        return name
    return str(dtype).replace("torch.", "")


def dtype_bytes(dtype) -> int:
    """Bytes per element of a dtype given as a string, a numpy dtype
    or a torch dtype."""
    name = _dtype_name(dtype)
    b = _DTYPE_BYTES.get(name)
    if b is not None:
        return b
    import numpy as np

    return int(np.dtype(name).itemsize)


def all_reduce_bytes(n_elems: int, dtype, axis_size: int) -> float:
    """psum / pmean / pmin / pmax: ring all-reduce wire bytes per
    device (reduce-scatter + all-gather phases)."""
    if axis_size <= 1:
        return 0.0
    return 2.0 * n_elems * dtype_bytes(dtype) * (axis_size - 1) / axis_size


def reduce_scatter_bytes(n_elems: int, dtype, axis_size: int) -> float:
    """psum_scatter over a ``n_elems`` global operand."""
    if axis_size <= 1:
        return 0.0
    return float(n_elems) * dtype_bytes(dtype) * (axis_size - 1) / axis_size


def all_gather_bytes(n_elems: int, dtype, axis_size: int) -> float:
    """all_gather producing a ``n_elems`` global result (each device
    ships its shard around the ring ``n-1`` times)."""
    if axis_size <= 1:
        return 0.0
    return float(n_elems) * dtype_bytes(dtype) * (axis_size - 1) / axis_size


def all_to_all_bytes(n_elems: int, dtype, axis_size: int) -> float:
    """all_to_all of a ``n_elems`` per-device operand: every device
    keeps 1/n locally and ships the rest."""
    if axis_size <= 1:
        return 0.0
    return float(n_elems) * dtype_bytes(dtype) * (axis_size - 1) / axis_size


def ppermute_bytes(n_elems: int, dtype, hops: int = 1) -> float:
    """ppermute: the full per-device payload moves every hop."""
    return float(n_elems) * dtype_bytes(dtype) * max(0, hops)


def int8_blockwise_exchange_bytes(padded_elems: int, axis_size: int,
                                  block: int) -> dict:
    """Wire bytes of the round-5 quantize-once exchange (one all_to_all
    pair): int8 payload + f32 per-block scales.  ``padded_elems`` must
    be divisible by ``axis_size * block`` (the optimizer pads to that
    quantum).  Kept as the historical a2a-shaped model; the staged ring
    the optimizer now runs moves the same totals
    (:func:`staged_ring_exchange_bytes`)."""
    n_blocks = padded_elems // axis_size // block
    return {
        "int8": all_to_all_bytes(padded_elems, "int8", axis_size),
        "float32": all_to_all_bytes(axis_size * n_blocks, "float32",
                                    axis_size),
    }


def fp8_blockwise_exchange_bytes(padded_elems: int, axis_size: int,
                                 block: int,
                                 dtype: str = "float8_e4m3fn") -> dict:
    """fp8 analogue of :func:`int8_blockwise_exchange_bytes`: 1-byte
    payload + f32 per-block scales through one all_to_all pair."""
    n_blocks = padded_elems // axis_size // block
    return {
        dtype: all_to_all_bytes(padded_elems, dtype, axis_size),
        "float32": all_to_all_bytes(axis_size * n_blocks, "float32",
                                    axis_size),
    }


def staged_ring_exchange_bytes(padded_elems: int, axis_size: int,
                               block: int, dtype: str) -> dict:
    """Per-device wire bytes of the in-reduce staged ring
    (``parallel/wire.reduce_scatter``): the partial for every chunk
    rides ``n-1`` hops, each hop shipping one ``padded/n``-element
    payload in the wire dtype plus (for the scaled dtypes) its
    ``padded/(n*block)`` f32 scales — the per-hop scale overhead is the
    price of re-quantizing inside the reduction.  Totals equal the
    quantize-once all_to_all model: in-reduce staging costs no extra
    bytes, it moves the SAME bytes through every reduction stage."""
    n = int(axis_size)
    if n <= 1:
        return {dtype: 0.0}
    chunk = padded_elems // n
    hops = n - 1
    out = {dtype: float(hops * chunk) * dtype_bytes(dtype)}
    if dtype not in ("bfloat16", "float16", "float32"):
        out["float32"] = float(hops * (chunk // block)) * 4.0
    return out


_SAVINGS_META = (
    names.COLLECTIVE_WIRE_SAVINGS_RATIO,
    "Uncompressed exchange bytes over what the configured wire "
    "actually ships, per exchange path (grad = DistriOptimizer's "
    "ZeRO-1 exchange, tp/moe/ring = the opt-in compressed wires)",
)


def record_savings(path: str, baseline_bytes: float, wire_bytes: float,
                   registry=None) -> float:
    """Publish the savings gauge of one exchange path:
    ``baseline_bytes`` (what the uncompressed exchange would ship) over
    ``wire_bytes`` (what the configured wire ships).  Returns the
    ratio (1.0 when nothing is compressed or nothing moves)."""
    ratio = (float(baseline_bytes) / float(wire_bytes)
             if wire_bytes else 1.0)
    if registry is None:
        from bigdl_tpu_torch import obs

        registry = obs.get_registry()
    registry.gauge(*_SAVINGS_META, labels=("path",)).labels(
        path=path).set(ratio)
    return ratio


# --------------------------------------------------------------- recording
_COUNTER_META = (
    names.COLLECTIVE_BYTES_TOTAL,
    "Wire bytes programmed into collectives, from static shapes "
    "(ring-algorithm cost model; no device reads)",
)
_GAUGE_META = (
    names.COLLECTIVE_BYTES_PER_STEP,
    "Static per-train-step wire bytes of the optimizer's collective "
    "footprint",
)


def _counter(registry=None):
    if registry is None:
        from bigdl_tpu_torch import obs

        registry = obs.get_registry()
    return registry.counter(*_COUNTER_META, labels=("op", "dtype"))


def record(op: str, dtype, nbytes: float, *, axis_size: Optional[int] = None,
           registry=None) -> float:
    """One collective: add ``nbytes`` to the labelled counter and emit
    a ``collective`` trace event (nothing when tracing is off)."""
    name = _dtype_name(dtype)
    nbytes = float(nbytes)
    _counter(registry).labels(op=op, dtype=name).inc(nbytes)
    from bigdl_tpu_torch import obs

    tracer = obs.get_tracer()
    if tracer.enabled:
        attrs = {"op": op, "dtype": name, "bytes": round(nbytes, 1)}
        if axis_size is not None:
            attrs["axis_size"] = int(axis_size)
        tracer.event("collective", **attrs)
    return nbytes


class StepFootprint:
    """The collective byte budget of one train step: built once when
    the trainer sets its step up, ``commit()``-ed once per resolved
    step.  Children are bound once, so a commit is a few locked float
    adds."""

    def __init__(self):
        self.entries: list = []   # [(op, dtype, bytes_per_step)]
        self._bound: list = []    # [(counter_child, bytes)]

    def add(self, op: str, dtype, nbytes: float) -> "StepFootprint":
        name = _dtype_name(dtype)
        nbytes = float(nbytes)
        if nbytes > 0:
            self.entries.append((op, name, nbytes))
        return self

    def total(self) -> float:
        return math.fsum(b for _, _, b in self.entries)

    def by_op(self) -> dict:
        out: dict = {}
        for op, name, b in self.entries:
            key = f"{op}:{name}"
            out[key] = out.get(key, 0.0) + b
        return out

    def bind(self, registry=None) -> "StepFootprint":
        """Resolve counter children once and publish the static
        per-step gauges; idempotent re-binds replace the cache."""
        if registry is None:
            from bigdl_tpu_torch import obs

            registry = obs.get_registry()
        counter = _counter(registry)
        gauge = registry.gauge(*_GAUGE_META, labels=("op", "dtype"))
        merged: dict = {}
        for op, name, b in self.entries:
            merged[(op, name)] = merged.get((op, name), 0.0) + b
        self._bound = []
        for (op, name), b in merged.items():
            self._bound.append((counter.labels(op=op, dtype=name), b))
            gauge.labels(op=op, dtype=name).set(b)
        return self

    def commit(self):
        """Account one executed step (the training loop, per resolved step)."""
        for child, b in self._bound:
            child.inc(b)
