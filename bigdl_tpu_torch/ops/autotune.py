"""Kernel auto-tuner: a cached, measured, regression-gated dispatch.

Counterpart of ``bigdl_tpu/ops/autotune.py``.  Each ``impl="auto"`` site
of the port resolves its impl per shape through one search:

* **candidates**: per call site, the static policy's choice and the
  other impls the site has, in the port's words ("reference"/"kernel"
  where the JAX package says "lax"/"pallas"):

  - ``attn`` (``ops.attention.dot_product_attention``): "reference"
    (``_reference_attention``) and, only for inputs on a CUDA device,
    "kernel" (``flash_attention``, the flash forward and backward
    kernels).  The kernels have one tile shape, so there is one kernel
    candidate where the JAX package has a grid of block plans;
  - ``conv_bn_1x1`` / ``conv_bn_kxk`` (``ops.conv_bn.conv_bn_stats``):
    "kernel" (the hand-written kernel, the static choice) and "xla"
    (``F.conv2d`` with f32 accumulation, then the two centred sums);
  - ``decode_attn`` (``ops.decode_attention.paged_decode_attention``):
    "dense" (static), "fused_p{bp}" for the JAX package's page blocks
    and, on a CUDA device, "kernel" (the paged flash-decode kernel);
  - ``int8_mm`` (``ops.quantized_matmul.int8_matmul``): "int8" (static)
    and "dequant".

* **costing**: the port has no compiler cost analysis, so every
  candidate is priced by an analytic model of its FLOPs and bytes
  (``_attn_cost``, ``_conv_cost``, ``decode_hbm_bytes``), scored as
  ``flops / peak + bytes / bandwidth``.  The model only ranks; an impl
  flips away from the static policy on the model alone only when it
  scores under ``_MODEL_MARGIN`` of the static candidate;
* **measurement** (``BIGDL_TORCH_TUNER_MEASURE=1``, given the caller's
  tensors): each candidate runs on detached clones of them (forward
  and backward of a ``sum(out²)`` loss where the site is
  differentiable), one warm-up, then ``measure_iters`` runs timed with
  CUDA events on the card or the host clock on the CPU.  Never while a
  CUDA graph is being captured (the counterpart of JAX's "never inside
  a jit trace"): then the model decides;
* **never lose to the static policy**: losses go static, and so do
  ties, which here are differences under ``_MEASURE_MARGIN`` of the
  static time (the JAX package takes any faster candidate); a measured
  winner is gated through ``obs.regress.check`` against the static
  candidate's time (``BIGDL_TORCH_REGRESS_TOLERANCE``);
* **cache**: JSON under ``BIGDL_TORCH_TUNER_CACHE``, keyed on
  ``site|shape|dtype|platform[|extra]``; the platform is "gpu" for
  tensors on a CUDA device and "cpu" otherwise, so a decision taken on
  the card never steers a CPU run.  A corrupt file serves the static
  policy and is never overwritten.

The tuner never sinks a step over what it owns: a failure in cache I/O,
telemetry or the decision logic returns None, which the site reads as
its static policy.  A kernel candidate is not covered: a build or launch
error in a CUDA kernel raises (:class:`KernelCandidateError`) instead of
being scored as slow.  Every decision is counted in
``bigdl_tuner_decisions_total{site,impl}`` and emitted as a
``tuner.decision`` event; cache traffic rides
``bigdl_tuner_cache_{hits,misses}_total`` and each timed candidate
``bigdl_tuner_measurements_total``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.obs import names

# (peak FLOP/s, memory bytes/s) for the roofline score.  Only the
# ranking inside one decision matters.  "gpu": the H100 SXM's dense
# bf16 tensor-core rate and HBM3 bandwidth (NVIDIA H100 80GB HBM3 at
# its 700 W limit), the figures of PERF.md's bound; "cpu": JAX's.
_PEAKS = {
    "gpu": (989e12, 3.35e12),
    "cpu": (2.0e11, 3.0e10),
}

# a model-only decision may flip the impl away from the static policy
# only when its score is under this fraction of the static one's
_MODEL_MARGIN = 0.5

# a measured candidate beats the static one only when it is faster by
# more than this fraction of the static time; a smaller difference is a
# tie and goes static.  The conv+BN sites' two arms came within 0.4% on
# the H100 and swapped between runs (PERF.md), so a winner by
# noise would decide which arm runs at a shape.
_MEASURE_MARGIN = 0.05

_lock = threading.Lock()
_cache = None
_cache_path = None


class KernelCandidateError(RuntimeError):
    """A CUDA kernel candidate failed to build or launch while it was
    measured.  Raised, never swallowed: the tuner does not hide a
    broken kernel behind the static policy."""


# --------------------------------------------------------------------------
# config / obs plumbing
# --------------------------------------------------------------------------


def _cfg():
    from bigdl_tpu_torch.config import TunerConfig

    return TunerConfig.from_env()


def enabled() -> bool:
    """Is the tuner on (``BIGDL_TORCH_TUNER=1``)?  Read at call time,
    the switch alone: every ``impl="auto"`` call asks."""
    from bigdl_tpu_torch.config import tuner_enabled

    return tuner_enabled()


def platform(device=None) -> str:
    """"gpu" for a CUDA device, "cpu" otherwise; with no device, "gpu"
    where CUDA is available."""
    if device is not None:
        return "gpu" if torch.device(device).type == "cuda" else "cpu"
    return "gpu" if torch.cuda.is_available() else "cpu"


def _device_of(arrays, device=None):
    if device is not None:
        return device
    for a in arrays or ():
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _counter(name, desc, **labels):
    try:
        from bigdl_tpu_torch import obs

        c = obs.get_registry().counter(name, desc,
                                       labels=tuple(labels) or ())
        (c.labels(**labels) if labels else c).inc()
    except Exception:  # noqa: BLE001 — telemetry never sinks dispatch
        pass


def _event(name, **attrs):
    try:
        from bigdl_tpu_torch import obs

        obs.get_tracer().event(name, **attrs)
    except Exception:  # noqa: BLE001 — telemetry never sinks dispatch
        pass


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return getattr(torch, dtype)
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _dtype_name(dtype) -> str:
    return str(_torch_dtype(dtype)).replace("torch.", "")


def _itemsize(dtype) -> int:
    return torch.empty(0, dtype=_torch_dtype(dtype)).element_size()


# --------------------------------------------------------------------------
# decision cache
# --------------------------------------------------------------------------


class TunerCache:
    """JSON decision store ``{"version": 1, "decisions": {key: rec}}``.

    A corrupt or truncated file sets ``corrupt``: every miss then serves
    the static policy and nothing is written, so the file stays as it
    was.  Writes go to a temporary file renamed over the store."""

    VERSION = 1

    def __init__(self, path: Optional[str]):
        self.path = path
        self.decisions: dict = {}
        self.corrupt = False
        self.hits = 0
        self.misses = 0
        if path and os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as fh:
                    doc = json.load(fh)
                if (not isinstance(doc, dict)
                        or doc.get("version") != self.VERSION
                        or not isinstance(doc.get("decisions"), dict)):
                    raise ValueError("bad tuner cache schema")
                self.decisions = doc["decisions"]
            except (OSError, ValueError):
                self.corrupt = True

    def get(self, key: str) -> Optional[dict]:
        rec = self.decisions.get(key)
        if rec is not None:
            self.hits += 1
            _counter(names.TUNER_CACHE_HITS_TOTAL,
                     "Tuner decisions served from the cache")
        else:
            self.misses += 1
            _counter(names.TUNER_CACHE_MISSES_TOTAL,
                     "Tuner cache misses (fresh searches)")
        return rec

    def put(self, key: str, rec: dict):
        if self.corrupt:
            return  # never overwrite a corrupt store
        self.decisions[key] = rec
        if not self.path:
            return
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"version": self.VERSION,
                           "decisions": self.decisions}, fh)
            os.replace(tmp, self.path)
        except OSError:
            pass  # the in-memory decisions still serve this process

    def stats(self) -> dict:
        return {"path": self.path, "entries": len(self.decisions),
                "hits": self.hits, "misses": self.misses,
                "corrupt": self.corrupt}


def get_cache() -> TunerCache:
    """The process cache, rebuilt when ``BIGDL_TORCH_TUNER_CACHE``
    changes."""
    global _cache, _cache_path
    path = _cfg().cache_path
    with _lock:
        if _cache is None or path != _cache_path:
            _cache = TunerCache(path)
            _cache_path = path
        return _cache


def reset():
    """Drop the cache object; the next access reloads the file."""
    global _cache, _cache_path
    with _lock:
        _cache = None
        _cache_path = None


def cache_key(site: str, shape_sig: str, dtype, plat: Optional[str] = None,
              extra: str = "") -> str:
    """``site|shape|dtype|platform[|extra]``, the JAX package's format."""
    key = f"{site}|{shape_sig}|{_dtype_name(dtype)}|{plat or platform()}"
    return f"{key}|{extra}" if extra else key


# --------------------------------------------------------------------------
# costing / measurement
# --------------------------------------------------------------------------


def _score(flops: float, bytes_: float, plat: Optional[str] = None) -> float:
    peak_f, peak_b = _PEAKS.get(plat or platform(), _PEAKS["cpu"])
    return flops / peak_f + bytes_ / peak_b


def _concrete(arrays) -> bool:
    """Tensors to time on, outside a CUDA graph capture."""
    if arrays is None:
        return False
    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


class _Probe:
    """One candidate as the measurement runs it: ``fn`` on the inputs
    (a differentiable site: forward and backward of ``sum(out²)``
    through the floating inputs ``grad`` names by position)."""

    def __init__(self, fn, grad=()):
        self.fn = fn
        self.grad = tuple(grad)

    def __call__(self, *args):
        out = self.fn(*args)
        if not self.grad:
            return out
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum(o.float().square().sum() for o in outs)
        return torch.autograd.grad(loss, [args[i] for i in self.grad])


def _clones(arrays, grad):
    """Detached copies of the caller's tensors, made once a candidate:
    the measurement never reaches the caller's autograd graph."""
    out = []
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            a = a.detach().clone()
            if i in grad:
                a.requires_grad_(True)
        out.append(a)
    return out


def _measure(probe, args, iters: int) -> float:
    """Mean seconds of one call of ``probe`` over ``iters`` runs after
    a warm-up run (which also builds a kernel on first use); CUDA events
    on the card, the host clock on the CPU.  Autograd is on whatever the
    caller's mode (a prefill under ``no_grad``, an eval pass): the probe
    differentiates its own clones."""
    with torch.inference_mode(False), torch.enable_grad():
        return _timed(probe, args, iters)


def _timed(probe, args, iters):
    n = max(1, int(iters))
    xs = _clones(args, getattr(probe, "grad", ()))
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in xs)
    probe(*xs)
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            probe(*xs)
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3 / n
    else:
        t0 = time.perf_counter()
        for _ in range(n):
            probe(*xs)
        secs = (time.perf_counter() - t0) / n
    _counter(names.TUNER_MEASUREMENTS_TOTAL,
             "Wall-clock candidate probes run by the auto-tuner")
    return secs


def _gate_measured(tuned_label: str, tuned_s: float, static_label: str,
                   static_s: float, plat: Optional[str] = None) -> dict:
    """Gate a measured winner against the static candidate through
    ``obs.regress.check``."""
    from bigdl_tpu_torch.obs import regress

    plat = plat or platform()
    fresh = {"source": f"tuned:{tuned_label}", "round": None,
             "platform": plat, "value": None, "step_time_s": tuned_s,
             "step_time_p95_s": None, "compile_count": None}
    base = [{"source": f"static:{static_label}", "round": 0,
             "platform": plat, "value": None, "step_time_s": static_s,
             "step_time_p95_s": None, "compile_count": None}]
    v = regress.check(fresh, base)
    return {"status": v["status"],
            "ratio": v.get("step_time_ratio"),
            "violations": v.get("violations", [])}


def _resolve(site, key, candidates, static_label, analytic, probes,
             arrays, plat: Optional[str] = None):
    """The search: cache, then (score | measure), gate, cache.

    ``candidates``: {label: payload}; ``analytic``: {label: (flops,
    bytes)}; ``probes``: {label: callable on ``arrays``}.  A kernel
    candidate (payload impl "kernel") that raises while it is measured
    raises :class:`KernelCandidateError`; any other candidate that
    raises drops out of the measurement."""
    plat = plat or platform(_device_of(arrays))
    cache = get_cache()
    with _lock:
        rec = cache.get(key)
    if rec is not None:
        _emit(site, rec, "cache")
        return rec

    if cache.corrupt:
        rec = dict(candidates[static_label], site=site, key=key,
                   label=static_label, source="corrupt_cache",
                   static=static_label)
        _emit(site, rec, "corrupt_cache")
        return rec

    cfg = _cfg()
    scores = {label: _score(fl, by, plat)
              for label, (fl, by) in analytic.items()}

    measured = {}
    if cfg.measure and _concrete(arrays):
        for label, probe in probes.items():
            if label not in candidates:
                continue
            try:
                measured[label] = _measure(probe, arrays, cfg.measure_iters)
            except Exception as e:  # noqa: BLE001
                if candidates[label].get("impl") == "kernel":
                    raise KernelCandidateError(
                        f"{site} candidate {label!r} failed: {e}") from e
                measured.pop(label, None)

    gate = None
    if measured and static_label in measured:
        winner = min(measured, key=lambda c: measured[c])
        if measured[winner] >= (1 - _MEASURE_MARGIN) \
                * measured[static_label]:
            winner = static_label  # ties (within the margin) go static
        elif winner != static_label:
            gate = _gate_measured(winner, measured[winner],
                                  static_label, measured[static_label], plat)
            if gate["status"] == "violation":
                winner = static_label
        source = "measured"
    else:
        winner = min(scores, key=lambda c: scores[c]) if scores \
            else static_label
        if winner not in candidates or \
                scores.get(winner, 0) >= scores.get(static_label,
                                                    float("inf")):
            winner = static_label  # the model must beat static to deviate
        elif (candidates[winner].get("impl")
                != candidates[static_label].get("impl")
                and scores[winner] >= _MODEL_MARGIN
                * scores[static_label]):
            winner = static_label  # an impl flip needs a decisive margin
        source = "model"

    rec = dict(candidates[winner], site=site, key=key, label=winner,
               source=source, platform=plat, ts=round(time.time(), 3),
               static=static_label,
               scores={c: round(s, 9) for c, s in scores.items()})
    if measured:
        rec["measured_s"] = {c: round(s, 9) for c, s in measured.items()}
    if gate:
        rec["gate"] = gate
    with _lock:
        cache.put(key, rec)
    _emit(site, rec, source)
    return rec


def _emit(site, rec, source):
    _counter(names.TUNER_DECISIONS_TOTAL,
             "Auto-tuner dispatch decisions, by call site and chosen "
             "impl", site=site, impl=rec.get("impl", "?"))
    _event("tuner.decision", site=site, key=rec.get("key"),
           impl=rec.get("impl"), label=rec.get("label"), source=source,
           static=rec.get("static"))


# --------------------------------------------------------------------------
# site: attention (forward and backward: one decision covers both)
# --------------------------------------------------------------------------


def decide_attention(q_shape, k_shape, dtype, *, causal: bool,
                     seq_offset: int, static_impl: str, plan=None,
                     arrays=None, device=None) -> Optional[dict]:
    """The decision for ``dot_product_attention(impl="auto")``:
    ``{"impl": "reference"|"kernel"}`` with its provenance, or None for
    the static policy.  ``plan`` is ``static_dispatch``'s (always None
    in the port: the kernels have one tile shape); ``device`` stands in
    for ``arrays``' device when no tensors are given."""
    try:
        from bigdl_tpu_torch.ops import attention as A

        b, h, tq, d = (int(s) for s in q_shape)
        tk = int(k_shape[-2])
        if not isinstance(seq_offset, int):
            return None
        plat = platform(_device_of(arrays, device))
        key = cache_key("attn", f"b{b}h{h}tq{tq}tk{tk}d{d}", dtype, plat,
                        extra=f"c{int(causal)}o{seq_offset}")
        scale = d ** -0.5
        candidates = {"reference": {"impl": "reference"}}
        analytic = {"reference": _attn_cost("reference", b, h, tq, tk, d,
                                            dtype, causal)}
        probes = {"reference": _Probe(
            lambda q, k, v: A._reference_attention(
                q, k, v, causal=causal, scale=scale, seq_offset=seq_offset),
            grad=(0, 1, 2))}
        # the kernel only where it runs: on the card, in a dtype and at
        # a head size it takes (the CPU's plain version is not what the
        # model prices, and JAX never proposes Pallas there either)
        if plat == "gpu" and d in A.HEAD_DIMS and \
                _torch_dtype(dtype) in (torch.float32, torch.bfloat16):
            candidates["kernel"] = {"impl": "kernel"}
            analytic["kernel"] = _attn_cost("kernel", b, h, tq, tk, d,
                                            dtype, causal)
            probes["kernel"] = _Probe(
                lambda q, k, v: A.flash_attention(
                    q, k, v, causal=causal, scale=scale,
                    seq_offset=seq_offset),
                grad=(0, 1, 2))
        static_label = ("kernel" if static_impl == "kernel"
                        and "kernel" in candidates else "reference")
        return _resolve("attn", key, candidates, static_label, analytic,
                        probes, arrays, plat=plat)
    except KernelCandidateError:
        raise
    except Exception:  # noqa: BLE001 — the tuner must never sink a step
        return None


def _attn_cost(impl, b, h, tq, tk, d, dtype, causal):
    """Analytic (flops, bytes) of forward plus backward (the backward
    rebuilds the scores: 3.5x the forward's 4·D FLOPs a (q, k) pair).
    The reference computes and stores the whole (Tq, Tk) f32 plane
    whatever the mask, four round trips of it (scores and probabilities
    forward, their gradients backward); the kernel skips the tiles past
    the causal diagonal and moves q, k, v, out and their gradients (JAX
    ``_attn_cost`` for a kernel that streams no superblocks)."""
    item = _itemsize(dtype)
    bh = b * h
    io = bh * (2 * tq + 2 * tk) * d * item          # q, k, v, out
    if impl == "reference":
        flops = 4.0 * bh * tq * tk * d * 3.5
        return flops, 3 * io + 4.0 * bh * tq * tk * 4
    cf = 0.5 if causal else 1.0
    flops = 4.0 * bh * tq * tk * d * cf * 3.5
    kv_stream = bh * 2 * tk * d * item
    q_stream = bh * 2 * tq * d * item
    return flops, 3 * io + 2 * kv_stream + q_stream


# --------------------------------------------------------------------------
# site: fused conv + BN statistics (1x1 / kxk)
# --------------------------------------------------------------------------


def decide_conv_bn(x_shape, w_shape, dtype, *, stride: int, pad: int,
                   arrays=None, device=None) -> Optional[dict]:
    """The decision for ``conv_bn_stats(impl="auto")``:
    ``{"impl": "kernel"|"xla"}`` with its provenance, or None for the
    static kernel.  JAX's ``block_o`` has no counterpart: the kernels'
    tiles are fixed."""
    try:
        from bigdl_tpu_torch.ops import conv_bn as C

        n, c, h, wd = (int(s) for s in x_shape)
        w_shape = tuple(int(s) for s in w_shape)
        o = w_shape[0]
        k = 1 if len(w_shape) == 2 else w_shape[2]
        site = "conv_bn_1x1" if k == 1 else "conv_bn_kxk"
        item = _itemsize(dtype)
        plat = platform(_device_of(arrays, device))
        key = cache_key(site, f"n{n}c{c}h{h}w{wd}o{o}k{k}s{stride}p{pad}",
                        dtype, plat)
        path = C.kernel_path(x_shape, w_shape, stride=stride, pad=pad,
                             itemsize=item)
        candidates = {"xla": {"impl": "xla"}, "kernel": {"impl": "kernel"}}
        analytic = {lbl: _conv_cost(lbl, path, n, c, h, wd, o, k, stride,
                                    pad, item) for lbl in candidates}
        probes = {lbl: _conv_probe(C, stride, pad, lbl)
                  for lbl in candidates}
        return _resolve(site, key, candidates, "kernel", analytic, probes,
                        arrays, plat=plat)
    except KernelCandidateError:
        raise
    except Exception:  # noqa: BLE001 — the tuner must never sink a step
        return None


def _conv_probe(C, stride, pad, impl):
    def fn(x, w, shift):
        return C.conv_bn_stats(x, w, shift, stride=stride, pad=pad,
                               impl=impl)

    return _Probe(fn, grad=(0, 1))


def _conv_cost(impl, path, n, c, h, wd, o, k, stride, pad, item):
    """Analytic (flops, bytes) of the fused forward plus backward (the
    backward is the same cuDNN conv gradients for both).  "xla" writes
    the conv's f32 output and reads it again for the statistics, and a
    narrower input is widened to f32 copies first; the bf16 kxk kernel
    writes and reads its NHWC copy of x (channels padded to 8)."""
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    flops = 2.0 * n * c * k * k * ho * wo * o * 3.0   # fwd + 2x bwd
    x_b = n * c * h * wd * item
    y_b = n * o * ho * wo * item
    w_b = o * c * k * k * item
    common = 3 * (x_b + y_b) + 2 * w_b                # fwd + bwd I/O
    if impl == "xla":
        widen = 2 * n * c * h * wd * 4 if item < 4 else 0
        return flops, common + 2 * n * o * ho * wo * 4 + widen
    layout = (2 * n * h * wd * (-(-c // 8) * 8) * item
              if item == 2 and path == "cuda_kxk" else 0)
    return flops, common + layout


# --------------------------------------------------------------------------
# site: paged decode attention (the serving hot path)
# --------------------------------------------------------------------------


def decide_decode_attn(q_shape, page_size: int, maxp: int, dtype, *,
                       kv_dtype=None, arrays=None,
                       device=None) -> Optional[dict]:
    """The decision for ``paged_decode_attention(impl="auto")`` and the
    engine's per-bucket choice: ``{"impl": "dense"|"fused"|"kernel",
    "block_pages": int}`` with its provenance, or None for the static
    dense path.  Every candidate is priced by ``decode_hbm_bytes`` (JAX
    ``use_hlo=False``)."""
    try:
        from bigdl_tpu_torch.ops import decode_attention as D

        b, h, d = (int(s) for s in q_shape)
        p, maxp = int(page_size), int(maxp)
        kv_dtype = dtype if kv_dtype is None else kv_dtype
        item = _itemsize(kv_dtype)
        plat = platform(_device_of(arrays, device))
        key = cache_key("decode_attn", f"b{b}h{h}d{d}p{p}m{maxp}", dtype,
                        plat)
        flops = 4.0 * b * h * maxp * p * d
        candidates = {"dense": {"impl": "dense", "block_pages": 0}}
        analytic = {"dense": (flops, D.decode_hbm_bytes(
            "dense", b, h, d, p, maxp, item))}
        probes = {"dense": _decode_probe(D, p, "dense", 0)}
        fused_bytes = D.decode_hbm_bytes("fused", b, h, d, p, maxp, item)
        for bp in sorted({maxp, 1, min(4, maxp)}, reverse=True):
            if maxp % bp:
                continue
            label = f"fused_p{bp}"
            candidates[label] = {"impl": "fused", "block_pages": bp}
            analytic[label] = (flops, fused_bytes)
            probes[label] = _decode_probe(D, p, "fused", bp)
        if plat == "gpu" and d in D.HEAD_DIMS:
            candidates["kernel"] = {"impl": "kernel", "block_pages": 0}
            analytic["kernel"] = (flops, D.decode_hbm_bytes(
                "kernel", b, h, d, p, maxp, item))
            probes["kernel"] = _decode_probe(D, p, "kernel", 0)
        return _resolve("decode_attn", key, candidates, "dense", analytic,
                        probes, arrays, plat=plat)
    except KernelCandidateError:
        raise
    except Exception:  # noqa: BLE001 — the tuner must never sink a step
        return None


def _decode_probe(D, page_size, impl, block_pages):
    def fn(q, kp, vp, tables, lengths):
        out = D.paged_decode_attention(q, kp, vp, tables, lengths,
                                       page_size=page_size, impl=impl,
                                       block_pages=block_pages)
        return out.float().square().sum()

    return _Probe(fn)


# --------------------------------------------------------------------------
# site: int8 matmul
# --------------------------------------------------------------------------


def decide_int8_mm(x_shape, w_shape, dtype, *, arrays=None,
                   device=None) -> Optional[dict]:
    """The decision for ``int8_matmul(impl="auto")``:
    ``{"impl": "int8"|"dequant"}`` with its provenance, or None for the
    static int8 path (JAX :699-755)."""
    try:
        m = 1
        for s in x_shape[:-1]:
            m *= int(s)
        k = int(x_shape[-1])
        n = int(w_shape[0])
        plat = platform(_device_of(arrays, device))
        key = cache_key("int8_mm", f"m{m}k{k}n{n}", dtype, plat)
        flops = 2.0 * m * k * n
        x_b = m * k * 4.0
        out_b = m * n * 4.0
        analytic = {
            # the 1-byte weight, the activations' quantization round trip
            "int8": (flops, n * k + n * 4 + x_b + 2.0 * m * k + out_b),
            # the 1-byte weight, its f32 copy written and read
            "dequant": (flops, n * k + n * 4 + 8.0 * n * k + x_b + out_b),
        }
        candidates = {"int8": {"impl": "int8"},
                      "dequant": {"impl": "dequant"}}
        probes = {lbl: _int8_mm_probe(lbl) for lbl in candidates}
        return _resolve("int8_mm", key, candidates, "int8", analytic,
                        probes, arrays, plat=plat)
    except Exception:  # noqa: BLE001 — the tuner must never sink a step
        return None


def _int8_mm_probe(impl):
    def fn(x, w_q, w_scale):
        from bigdl_tpu_torch.ops.quantized_matmul import int8_matmul

        y = int8_matmul(x, w_q, w_scale, impl=impl, device=x.device)
        return y.float().square().sum()

    return _Probe(fn)


# --------------------------------------------------------------------------
# pre-warming + reporting
# --------------------------------------------------------------------------


def _randn(rs, shape, dtype, device, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(
        np.float32)).to(device=device, dtype=_torch_dtype(dtype))


def prewarm_attention(b, h, tq, tk, d, dtype="float32", *, causal=True,
                      seed=0, device="cuda"):
    """One ``impl="auto"`` attention on random inputs of this shape
    (measured when ``BIGDL_TORCH_TUNER_MEASURE=1``); returns the
    output."""
    from bigdl_tpu_torch.common import resolve_device
    from bigdl_tpu_torch.ops.attention import dot_product_attention

    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    q, k, v = (_randn(rs, (b, h, t, d), dtype, dev) for t in (tq, tk, tk))
    return dot_product_attention(q, k, v, causal=causal, impl="auto")


def prewarm_conv_bn(n, c, h, w, o, k, *, stride=1, pad=0, dtype="float32",
                    seed=0, device="cuda"):
    """One ``impl="auto"`` fused conv + BN statistics on random inputs;
    returns (y, s1, s2)."""
    from bigdl_tpu_torch.common import resolve_device
    from bigdl_tpu_torch.ops.conv_bn import conv_bn_stats

    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    x = _randn(rs, (n, c, h, w), dtype, dev)
    wt = _randn(rs, (o, c, k, k), dtype, dev, 0.1)
    shift = _randn(rs, (o,), "float32", dev)
    return conv_bn_stats(x, wt, shift, stride=stride, pad=pad, impl="auto")


def prewarm_decode_attn(b, h, d, *, page_size=16, maxp=4, num_pages=None,
                        dtype="float32", seed=0, device="cuda"):
    """One ``impl="auto"`` paged decode over a random page pool with
    ragged lengths; returns the output."""
    from bigdl_tpu_torch.common import resolve_device
    from bigdl_tpu_torch.ops.decode_attention import paged_decode_attention

    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    pool = int(num_pages or (b * maxp + 1))
    q = _randn(rs, (b, h, d), dtype, dev)
    kp = _randn(rs, (pool, h, page_size, d), dtype, dev)
    vp = _randn(rs, (pool, h, page_size, d), dtype, dev)
    lengths = torch.from_numpy(rs.randint(1, maxp * page_size, (b,)).astype(
        np.int32)).to(dev)
    tables = torch.from_numpy(rs.randint(1, pool, (b, maxp)).astype(
        np.int32)).to(dev)
    return paged_decode_attention(q, kp, vp, tables, lengths,
                                  page_size=page_size, impl="auto")


def prewarm_int8_mm(m, k, n, *, dtype="float32", seed=0, device="cuda"):
    """One ``impl="auto"`` int8 matmul of random activations against a
    random weight quantized per output channel; returns the output."""
    from bigdl_tpu_torch.common import resolve_device
    from bigdl_tpu_torch.ops.quantized_matmul import (int8_matmul,
                                                      quantize_per_channel)

    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    x = _randn(rs, (m, k), dtype, dev)
    w = _randn(rs, (n, k), "float32", dev, 0.1)
    w_q, w_s = quantize_per_channel(w, axis=0)
    return int8_matmul(x, w_q, w_s, impl="auto", device=dev)


def summary() -> dict:
    """The cache and its decisions (JAX :826-840)."""
    cache = get_cache()
    with _lock:
        decisions = [
            {"key": k, "site": r.get("site"), "impl": r.get("impl"),
             "label": r.get("label"), "source": r.get("source"),
             "static": r.get("static"),
             "measured_s": r.get("measured_s"),
             "gate": r.get("gate")}
            for k, r in sorted(cache.decisions.items())]
    return {"enabled": enabled(), "cache": cache.stats(),
            "decisions": decisions}


__all__ = ["KernelCandidateError", "TunerCache", "cache_key",
           "decide_attention", "decide_conv_bn", "decide_decode_attn",
           "decide_int8_mm", "enabled", "get_cache", "platform",
           "prewarm_attention", "prewarm_conv_bn", "prewarm_decode_attn",
           "prewarm_int8_mm", "reset", "summary"]
