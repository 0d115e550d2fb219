"""Continuous-batching LM decode engine.

Counterpart of ``bigdl_tpu/serving/engine.py``:

* **slots**: up to ``max_batch`` requests decode together in one step
  over the paged KV cache (``serving/cache.py``);
* **continuous admission**: at every step boundary free slots are
  refilled from the request queue; ``admission="static"`` drains the
  whole batch first;
* **prefill/decode split**: a new request's prompt runs one batched
  forward (``TransformerBlock.prefill``) padded with token 0 to a pow2
  bucket of the page size, writes its K/V pages and yields its first
  token; the shared decode step then advances every active slot one
  token (``paged_decode_math``);
* **int8 decode** (``int8=True``): the decode step's matmuls (q/k/v/o,
  fc1, fc2, the head) run on per-output-channel int8 twins of the
  weights through ``ops.quantized_matmul.int8_matmul``; the attention
  stays on the paged decode and the prefill stays float;
* **TP-sharded decode** (``tp=N``, ``serving/tp.py``): the decode step
  runs on Megatron row/col-split weights, each rank of the mesh's
  ``model`` axis on its own shard and ``n_head / N`` heads of the page
  pools, the block reductions on ``parallel/wire``.  The JAX package
  drives ``N`` devices from one host process; here each rank is a
  process (``Engine.build_mesh({"model": N})`` on every rank, then an
  ``LMEngine(tp=N)`` on every rank).  Group rank 0 is the leader: it
  alone takes ``submit`` and owns the scheduler (queue, slots, page
  tables, admission, preemption, drain), and before every prefill and
  every decode step it broadcasts the step's host inputs over a gloo
  group of the same ranks (the control plane, which also works where
  the data group is NCCL).  The other ranks are followers: ``follow()``
  (or ``start()``) replays those steps on their shard until the
  leader's ``close()``.  Prefill stays replicated (every rank runs the
  whole model over the prompt and writes its own heads' K/V); every
  rank's generator is seeded alike and the logits agree after the
  reductions, so every rank samples the same token;
* **preemption**: if the page pool runs out mid-decode, the youngest
  request gives its pages back and re-queues with its generated prefix
  folded into the prompt;
* **drain and hot swap**: ``drain()`` closes admissions and checkpoints
  what is unfinished as ``HandoffRecord``s (``serving/drain.py``);
  ``swap_weights`` copies new weights to the device on the caller's
  thread and flips them in between two decode steps;
* **request tracing** (JAX :523-540, :688-728): with the request
  collector on (``BIGDL_TORCH_REQTRACE_SAMPLE`` > 0) ``submit`` begins
  the caller's trace or mints one, and completion splits the engine's
  e2e exactly into queue + prefill + preempt + decode spans (decode is
  the remainder) before the tail sampler decides; a kept trace's id
  rides the e2e histogram as an exemplar.  With the collector off a
  caller's context is only carried into a handoff record, and the
  engine keeps no trace state;
* **a stream of its own** on the card: every prefill, decode step and
  weight copy of the engine is queued on it, so engines that share a
  card (a router's replicas in one process) do not wait at a step's
  token read for each other's queued kernels.

The engine stamps the serving families of ``obs/names.py`` in the
process registry (latency histograms, token, request, preemption and
swap counters, the occupancy gauge) and the tracer's ``serve.*`` events
and decode-step spans (``serving/spans.py``).  PyTorch runs eagerly, so
there is no per-bucket compile cache: each prefill bucket and decode
page bucket is just a shape.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.config import ServeConfig
from bigdl_tpu_torch.nn.attention import layer_norm
from bigdl_tpu_torch.obs import names, reqtrace
from bigdl_tpu_torch.ops.decode_attention import (decode_hbm_bytes,
                                                  paged_decode_attention,
                                                  used_page_bucket)
from bigdl_tpu_torch.ops.quantized_matmul import (int8_matmul,
                                                  quantize_per_channel)
from bigdl_tpu_torch.serving import spans
from bigdl_tpu_torch.serving.batcher import RequestQueue, ServeRequest
from bigdl_tpu_torch.serving.cache import PagedKVCache
# the error a drained or closed engine finishes an unfinished request
# with, so that a router can replay it elsewhere (its home is drain.py)
from bigdl_tpu_torch.serving.drain import HANDOFF_ERROR, drain_engine
from bigdl_tpu_torch.utils.convert import params_from_jax

DECODE_ATTN_IMPLS = ("auto", "dense", "fused", "kernel")

LAT_META = (names.REQUEST_LATENCY_SECONDS,
            "Request latency by engine and kind (ttft = time to first "
            "token, per_token = mean inter-token, e2e = submit to done)")


def _quantize_tree(params, n_layer: int) -> dict:
    """Per-output-channel int8 twins ``(codes, scale)`` of every decode
    matmul weight of a ``TransformerLM.params()`` tree (JAX :61-78)."""
    q = {}
    for i in range(n_layer):
        pb = params[f"h{i}"]
        q[f"h{i}"] = {
            "attn": {w: quantize_per_channel(pb["attn"][w], axis=0)
                     for w in ("wq", "wk", "wv", "wo")},
            "fc1": quantize_per_channel(pb["fc1"]["weight"], axis=0),
            "fc2": quantize_per_channel(pb["fc2"]["weight"], axis=0)}
    q["head"] = quantize_per_channel(params["head"]["weight"], axis=0)
    return q


def _nested(params) -> dict:
    """A flat ``state_dict()`` (dotted keys) as the nested tree of
    ``params()``; a nested tree as it is."""
    if not any("." in k for k in params):
        return params
    out: dict = {}
    for key, v in params.items():
        *parents, leaf = key.split(".")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _placed(target, tree, pairs, path="") -> dict:
    """``tree`` laid out as ``target`` (a ``params()`` tree), each leaf
    a copy on its parameter's device and in its dtype (numpy leaves
    through ``params_from_jax``); appends (parameter, new tensor) to
    ``pairs``."""
    out = {}
    for k, p in target.items():
        at = f"{path}/{k}" if path else k
        if not isinstance(tree, dict) or tree.get(k) is None:
            raise KeyError(f"weight tree lacks {at}")
        if isinstance(p, dict):
            out[k] = _placed(p, tree[k], pairs, at)
            continue
        leaf = tree[k]
        if not isinstance(leaf, torch.Tensor):
            leaf = params_from_jax(leaf)
        new = leaf.to(device=p.device, dtype=p.dtype, copy=True)
        if new.shape != p.shape:
            raise ValueError(f"swap_weights: {at} has shape "
                             f"{tuple(new.shape)}, not {tuple(p.shape)}")
        pairs.append((p, new))
        out[k] = new
    return out


def _control_group(mesh):
    """(the control plane's gloo group over this rank's line of the
    mesh's ``model`` axis, the line leader's global rank).  The data
    group serves where it is gloo; otherwise every rank makes a gloo
    group for every line, in the same order (``new_group`` is
    collective)."""
    import torch.distributed as dist

    group = mesh.group("model")
    leader = dist.get_global_rank(group, 0)
    if dist.get_backend(group) == "gloo":
        return group, leader
    ctrl = None
    others = [a for a in mesh.axis_names if a != "model"]
    world = dist.get_world_size()
    for r0 in range(world):
        c0 = mesh.coords(r0)
        if c0["model"]:
            continue
        line = sorted((r for r in range(world)
                       if all(mesh.coords(r)[a] == c0[a] for a in others)),
                      key=lambda r: mesh.coords(r)["model"])
        g = dist.new_group(line, backend="gloo")
        if mesh.rank in line:
            ctrl = g
    return ctrl, leader


def _pick(logits, temps, generator):
    """Greedy argmax (first maximal index) where ``temps == 0``, a
    categorical draw from ``generator`` elsewhere."""
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    hot = temps > 0.0
    if bool(hot.any()):
        t = torch.where(hot, temps, torch.ones_like(temps))
        probs = torch.softmax(logits.float() / t[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
        nxt = torch.where(hot, sampled.to(torch.int32), nxt)
    return nxt


@torch.no_grad()
def paged_decode_math(model, page_size: int, kp, vp, tables, lengths,
                      tokens, temps, active, generator, *,
                      attn_impl: str = "dense", attn_block_pages: int = 0,
                      qparams=None, params=None, n_head=None, psum=None):
    """One decode step over the paged cache for every slot.  Mirrors
    ``TransformerBlock.decode_step``: the slot's new K/V are written at
    position ``lengths`` BEFORE attending, so ``length + 1`` positions
    attend; ``wpe`` is indexed by ``lengths``.  ``kp``/``vp`` are the
    (L, pages, H, P, Dh) pools, updated in place; ``tables`` may be the
    used-page bucket.  With ``qparams`` (``_quantize_tree``) the
    matmuls run ``int8_matmul`` on the twins, biases and LayerNorms in
    float (JAX :81-176).  The weights come from ``params`` (a
    ``params()`` tree; default the model's own).  A TP rank passes its
    local tree (``serving/tp.py``), its LOCAL head count as ``n_head``
    and the block reduction as ``psum``: the row-parallel products of
    wo and fc2 are reduced, and their biases added once, after it,
    while fc1's bias stays local (JAX :81-83, :149-163).  Returns the
    next token of every slot (0 where ``active`` is False)."""
    blocks = model.blocks()
    if params is None:
        params = model.params()
    heads = blocks[0].attn.n_head if n_head is None else int(n_head)
    head_dim = blocks[0].attn.head_dim
    bsz = tokens.shape[0]
    scale = 1.0 / math.sqrt(head_dim)
    dev = tokens.device

    def lin(h, w, b=None, qw=None):
        y = (torch.matmul(h, w.t()) if qw is None
             else int8_matmul(h, qw[0], qw[1], impl="auto", device=dev))
        return y if b is None else y + b

    pos = lengths.long()
    x = (params["wte"]["weight"][tokens.long()]
         + params["wpe"]["weight"][pos])[:, None, :]
    pidx = tables.long().gather(1, (pos // page_size)[:, None])[:, 0]
    off = pos % page_size
    for i, block in enumerate(blocks):
        p = params[f"h{i}"]
        pa = p["attn"]
        qb = {"attn": {}} if qparams is None else qparams[f"h{i}"]
        h = layer_norm(x, p["ln1"]["weight"], p["ln1"]["bias"],
                       block.ln1.eps)
        q, k, v = (lin(h, pa[w], pa.get("b" + w[1]), qb["attn"].get(w))
                   for w in ("wq", "wk", "wv"))
        qh = q.reshape(bsz, heads, head_dim)
        # the new token's K/V go into the pools in place (the JAX
        # package returns new pools via .at[].set with donation)
        kp[i, pidx, :, off] = k.reshape(bsz, heads, head_dim).to(kp.dtype)
        vp[i, pidx, :, off] = v.reshape(bsz, heads, head_dim).to(vp.dtype)
        o = paged_decode_attention(qh, kp[i], vp[i], tables, lengths,
                                   page_size=page_size, scale=scale,
                                   impl=attn_impl,
                                   block_pages=attn_block_pages)
        y = lin(o.reshape(bsz, 1, heads * head_dim), pa["wo"],
                qw=qb["attn"].get("wo"))
        if psum is not None:
            y = psum(y)
        x = x + (y if pa.get("bo") is None else y + pa["bo"])
        h = layer_norm(x, p["ln2"]["weight"], p["ln2"]["bias"],
                       block.ln2.eps)
        h = lin(h, p["fc1"]["weight"], p["fc1"].get("bias"), qb.get("fc1"))
        h = lin(F.gelu(h, approximate="tanh"), p["fc2"]["weight"],
                qw=qb.get("fc2"))
        if psum is not None:
            h = psum(h)
        x = x + (h if p["fc2"].get("bias") is None else h + p["fc2"]["bias"])
    h = layer_norm(x, params["ln_f"]["weight"], params["ln_f"]["bias"],
                   model.ln_f.eps)
    logits = lin(h, params["head"]["weight"],
                 qw=None if qparams is None else qparams["head"])[:, 0, :]
    nxt = _pick(logits, temps, generator)
    return torch.where(active, nxt, torch.zeros_like(nxt))


class _Active:
    """Host bookkeeping for one occupied slot."""

    __slots__ = ("req", "remaining", "last_token", "order")

    def __init__(self, req, remaining, last_token, order):
        self.req = req
        self.remaining = remaining
        self.last_token = last_token
        self.order = order


class LMEngine:
    """Continuous-batching decode over a :class:`PagedKVCache`.

    ``decode_attn``: "auto" ("dense", or with ``BIGDL_TORCH_TUNER=1``
    the tuner's ``decode_attn`` decision for each used-page bucket),
    "dense", "fused" (the online softmax over page blocks in torch) or
    "kernel" (the paged flash-decode).  The model's ``attn_impl``
    decides the prefill attention.  ``int8`` (default ``BIGDL_TORCH_SERVE_INT8``) runs the
    decode matmuls on int8 twins.  ``tp`` shards the decode step over
    the ``model`` axis of ``Engine.mesh()``, whose size it must be, with
    ``wire`` (a ``parallel.wire`` spec or dtype) on its reductions; each
    rank builds its engine on the full model, group rank 0 leads and
    the others ``follow()`` (module docstring).  ``weight_version``
    names the weights served (``/healthz``, handoff records).
    ``device`` defaults to the card; the model must already live on
    it."""

    def __init__(self, model, *, max_batch: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 eos_id: Optional[int] = None,
                 slo_s: Optional[float] = None,
                 admission: Optional[str] = None,
                 decode_attn: Optional[str] = None,
                 decode_bucket: Optional[bool] = None,
                 int8: Optional[bool] = None, tp: int = 1, wire=None,
                 seed: int = 0, weight_version: str = "v0", device="cuda"):
        cfg = ServeConfig.from_env()
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.max_batch = int(max_batch or cfg.max_batch)
        self.page_size = int(page_size or cfg.page_size)
        self.decode_attn = decode_attn or cfg.decode_attn
        if self.decode_attn not in DECODE_ATTN_IMPLS:
            raise ValueError(
                f"decode_attn must be auto|dense|fused|kernel, got "
                f"{self.decode_attn!r}")
        self.decode_bucket = (cfg.decode_bucket if decode_bucket is None
                              else bool(decode_bucket))
        self.int8 = cfg.int8 if int8 is None else bool(int8)
        self.eos_id = eos_id
        self.slo_s = cfg.slo_s if slo_s is None else float(slo_s)
        self.admission = admission or cfg.admission
        if self.admission not in ("continuous", "static"):
            raise ValueError(
                f"admission must be continuous|static, got "
                f"{self.admission!r}")
        self.max_len = int(model.max_len)
        self.n_layer = model.n_layer
        self.n_head = int(model.n_head)
        self.head_dim = model.dim // self.n_head
        self.tp = int(tp or 1)
        if self.int8 and self.tp > 1:
            raise ValueError("int8 decode and tp-sharded decode are "
                             "currently exclusive")
        self._tp_step = None
        self._tp_rank = 0
        if self.tp > 1:
            from bigdl_tpu_torch.serving.tp import build_tp_decode_step

            self._tp_step = build_tp_decode_step(
                model, tp=self.tp, wire=wire, page_size=self.page_size,
                max_batch=self.max_batch, positions=self.max_len,
                attn_impl=self.decode_attn)
            self._tp_rank = self._tp_step.mesh.index("model")
            self._ctrl, self._leader = _control_group(self._tp_step.mesh)
        if cache_dtype is None:
            cache_dtype = model.wte.weight.dtype
        pages = num_pages or cfg.num_pages or (
            1 + self.max_batch * -(-self.max_len // self.page_size))
        # a TP rank's pools hold its own n_head / tp heads
        self.cache = PagedKVCache(
            self.n_layer, self.n_head // self.tp, self.head_dim,
            page_size=self.page_size, num_pages=pages,
            max_slots=self.max_batch, max_len=self.max_len,
            dtype=cache_dtype, device=self.device)
        self.queue = RequestQueue(queue_capacity or cfg.queue_capacity)
        self._slots: List[Optional[_Active]] = [None] * self.max_batch
        self._stash: collections.deque = collections.deque()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        if self._stream is not None:
            # the weights and the cache were written on the caller's
            # stream
            self._stream.wait_stream(
                torch.cuda.current_stream(self.device))
        self._order = 0
        self._steps = 0
        self._occ_sum = 0.0
        self._tokens_total = 0
        self._preemptions = 0
        self._t_first_work: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self.completed: List[dict] = []
        self._slo_window: collections.deque = collections.deque(maxlen=256)
        self.weight_version = str(weight_version)
        self.manifest_sha: Optional[str] = None
        self.swaps = 0
        self.draining = False
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        # callers waiting in locked(): the step loop stands aside
        self._waiters = 0
        self._waiters_lock = threading.Lock()
        self._last_bucket = self.cache.max_pages_per_slot
        # (impl, block_pages) each used-page bucket resolves to
        self._impl_by_bucket = {}
        self._decode_ms_sum = 0.0
        # the step thread's CPU time: wall minus it is the time the
        # thread waited (for the interpreter lock, the device or the OS)
        self._decode_cpu_ms_sum = 0.0
        self._last_step_bytes: Optional[float] = None
        self._qparams = (_quantize_tree(model.params(), self.n_layer)
                         if self.int8 else None)
        # this rank's shard of the weights; a follower's swaps, staged
        # until the leader announces them
        self._tp_local = (None if self._tp_step is None
                          else self._tp_step.shard(model.params()))
        self._staged: collections.deque = collections.deque()
        self._staged_cv = threading.Condition()
        self._closed = False
        self._weight_bytes = self._decode_weight_bytes()
        from bigdl_tpu_torch.obs import prof as _obs_prof

        # the sampling profiler starts with the engine when
        # BIGDL_TORCH_PROF_HZ > 0 (unset: one config read, no thread)
        _obs_prof.get_profiler()
        reg = obs.get_registry()
        self._lat = reg.histogram(*LAT_META, labels=("engine", "kind"))
        self._tokens_counter = reg.counter(
            names.SERVE_TOKENS_TOTAL, "Tokens generated by the LM "
            "decode engine")
        self._req_counter = reg.counter(
            names.SERVE_REQUESTS_TOTAL,
            "Requests completed, by engine and status",
            labels=("engine", "status"))
        self._occ_gauge = reg.gauge(
            names.SERVE_BATCH_OCCUPANCY,
            "Mean fraction of decode slots occupied per step")
        self._preempt_counter = reg.counter(
            names.SERVE_PREEMPTIONS_TOTAL,
            "Requests preempted (pages reclaimed, request re-queued) "
            "on KV-page exhaustion")
        self._swap_counter = reg.counter(
            names.SERVE_WEIGHT_SWAPS_TOTAL,
            "Live weight hot-swaps completed, by promoted version",
            labels=("version",))

    def _decode_weight_bytes(self) -> float:
        """Weight bytes one decode step streams: every parameter byte
        once; an int8 engine counts each parameter of two or more
        dimensions at 1 byte a weight, as the JAX engine counts it
        (:335-358; the per-channel scales are left out)."""
        return float(sum(
            p.numel() * (1 if self._qparams is not None and p.ndim >= 2
                         else p.element_size())
            for p in self.model.parameters()))

    # ------------------------------------------------------------ hot swap
    def swap_weights(self, params, *, version: str,
                     manifest_sha: Optional[str] = None) -> None:
        """Hot-swap the served weights between decode steps (JAX
        :361-404).

        ``params`` is a ``TransformerLM.params()`` tree, the JAX
        package's (numpy leaves, taken through ``params_from_jax``) or
        the port's (tensors), or a port ``state_dict()``.  The
        host-to-device copy and, for an int8 engine, the requantization
        run on the CALLER's thread (on the engine's stream, so they are
        done before any later step reads them); under the engine lock
        each parameter then takes its new tensor (a pointer flip).
        Slots, page tables and in-flight decodes survive: requests
        already decoding continue on the new weights over their
        old-weights KV prefix; requests admitted after the swap decode
        as ``generate()`` on the new weights.

        At ``tp > 1`` every rank calls it with the same weights (and
        slices its shard on the caller's thread): the leader flips at
        once and announces the flip with its next prefill or step; a
        follower stages the weights and flips at that step."""
        pairs: list = []
        if self._stream is not None:
            self._stream.wait_stream(
                torch.cuda.current_stream(self.device))
        with self._on_stream():
            tree = _placed(self.model.params(), _nested(params), pairs)
            qparams = (_quantize_tree(tree, self.n_layer) if self.int8
                       else None)
            local = (None if self._tp_step is None
                     else self._tp_step.shard(tree))
        if self._stream is not None:
            # the copies read the caller's tensors, which the caller may
            # free once this returns
            self._stream.synchronize()
        staged = (pairs, qparams, local, str(version), manifest_sha)
        if self._tp_rank:
            with self._staged_cv:
                self._staged.append(staged)
                self._staged_cv.notify_all()
            return
        with self.locked():
            self._flip(*staged)

    def _flip(self, pairs, qparams, local, version, manifest_sha) -> None:
        # the old weights are freed here; every step ends in a token read
        # that syncs the engine's stream, so no kernel still reads them
        for p, new in pairs:
            p.data = new
        self._qparams = qparams
        self._tp_local = local
        self._weight_bytes = self._decode_weight_bytes()
        self.weight_version = version
        self.manifest_sha = manifest_sha
        self.swaps += 1
        self._swap_counter.labels(version=version).inc()
        obs.get_tracer().event(spans.EVENT_WEIGHT_SWAP, version=version,
                               sha=manifest_sha or "", swaps=self.swaps)

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def _prefill(self, payload: List[int], bucket: int, pages: List[int],
                 temperature: float) -> int:
        """Prefill one prompt padded with token 0 to ``bucket``: write
        its ``bucket // P`` pages (those past the allocation point at
        trash page 0) and return the first token, read from row t0-1.  A
        TP rank runs the whole model and writes its own heads."""
        self._announce("prefill", list(payload), bucket, list(pages),
                       float(temperature))
        model, dev, p = self.model, self.device, self.page_size
        hl = self.cache.n_head
        h0 = self._tp_rank * hl
        t0 = len(payload)
        n_write = bucket // p
        prompt = torch.zeros((1, bucket), dtype=torch.int32)
        prompt[0, :t0] = torch.as_tensor(payload, dtype=torch.int32)
        page_arg = torch.zeros((n_write,), dtype=torch.long)
        page_arg[:len(pages)] = torch.as_tensor(pages, dtype=torch.long)
        prompt, page_arg = prompt.to(dev), page_arg.to(dev)
        x = model.wpe(model.wte(prompt))
        for i, block in enumerate(model.blocks()):
            x, kh, vh = block.prefill(x)
            # (1, H, bucket, Dh) -> (pages, H, P, Dh), written into the
            # pools in place
            shape = (hl, n_write, p, self.head_dim)
            self.cache.kp[i, page_arg] = kh[0, h0:h0 + hl].reshape(
                shape).transpose(0, 1).to(self.cache.dtype)
            self.cache.vp[i, page_arg] = vh[0, h0:h0 + hl].reshape(
                shape).transpose(0, 1).to(self.cache.dtype)
        logits = model.head(model.ln_f(x[:, t0 - 1:t0, :]))[:, 0, :]
        temps = torch.full((1,), float(temperature), device=dev)
        return int(_pick(logits, temps, self._gen)[0])

    def _bucket(self, t0: int) -> int:
        b = self.page_size
        while b < t0:
            b *= 2
        return min(b, -(-self.max_len // self.page_size) * self.page_size)

    # ------------------------------------------------------------- clients
    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0,
               timeout: Optional[float] = None,
               trace=None) -> ServeRequest:
        """Queue a request.  ``trace`` (an ``obs.reqtrace``
        ``RequestTraceContext``) rides the request into a drain's
        handoff record; with the request collector on, the engine begins
        that trace (or mints one) and records the request's spans."""
        if self.draining:
            raise RuntimeError("engine is draining — admissions closed")
        if self._tp_rank:
            raise RuntimeError("a tp engine takes submit on its leader "
                               "(group rank 0); this rank follows")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + {max_new_tokens} new tokens "
                f"exceeds max_len {self.max_len}")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # a request that can never fit the page pool even alone would
        # preempt-loop forever: reject it at the door
        worst = self.cache.pages_for(len(prompt) + int(max_new_tokens))
        if worst > self.cache.num_pages - 1:
            raise ValueError(
                f"request needs {worst} KV pages but the pool has "
                f"{self.cache.num_pages - 1}")
        col = reqtrace.get_collector()
        if col.enabled:
            if trace is None:
                trace = col.new_context()
            col.begin(trace)
        req = ServeRequest(payload=prompt,
                           max_new_tokens=int(max_new_tokens),
                           temperature=float(temperature),
                           trace=trace)
        if col.enabled:
            req._tr_admits = []    # [{t, dur, bucket, prompt_len, slot}]
            req._tr_preempts = []  # [t_preempted]
        return self.queue.submit(req, timeout=timeout)

    # ----------------------------------------------------------- admission
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def active_count(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def _admit(self, wait_s: float = 0.0) -> int:
        free = self._free_slots()
        if not free:
            return 0
        if self.admission == "static" and self.active_count():
            return 0  # static batching: drain fully before refilling
        wanted = len(free)
        incoming = list(self._stash)
        self._stash.clear()
        if len(incoming) < wanted:
            incoming.extend(
                self.queue.take(wanted - len(incoming), timeout=wait_s))
        admitted = 0
        for req in incoming:
            free = self._free_slots()
            # pages are allocated for the PROMPT, not the pow2 bucket;
            # the bucket's padded tail writes to the trash page
            if not free or not self.cache.can_admit(len(req.payload)):
                self._stash.append(req)  # head-of-line, retried first
                continue
            self._prefill_into(free[0], req)
            admitted += 1
        return admitted

    def _prefill_into(self, slot: int, req: ServeRequest):
        t_admit = time.monotonic()
        t0 = len(req.payload)
        bucket = self._bucket(t0)
        pages = self.cache.alloc(slot, t0)
        tok = self._prefill(req.payload, bucket, pages, req.temperature)
        self.cache.lengths[slot] = t0
        admits = getattr(req, "_tr_admits", None)
        if admits is not None:
            admits.append({"t": t_admit, "dur": time.monotonic() - t_admit,
                           "bucket": bucket, "prompt_len": t0,
                           "slot": slot})
        if req.t_first is None:
            req.t_first = time.monotonic()
            self._lat.labels(engine="lm", kind="ttft").observe(
                req.t_first - req.t_submit)
        req.tokens.append(tok)
        self._tokens_total += 1
        self._tokens_counter.inc()
        if self._t_first_work is None:
            self._t_first_work = time.monotonic()
        self._order += 1
        act = _Active(req, req.max_new_tokens - 1, tok, self._order)
        self._slots[slot] = act
        obs.get_tracer().event(spans.EVENT_ADMIT, slot=slot,
                               request=req.id, prompt_len=t0,
                               bucket=bucket)
        if act.remaining <= 0 or tok == self.eos_id:
            self._complete(slot)

    def _preempt_youngest(self) -> Optional[int]:
        """Free the youngest active slot's pages; its request re-queues
        with the generated prefix folded into the prompt."""
        victims = [(s.order, i) for i, s in enumerate(self._slots)
                   if s is not None]
        if not victims:
            return None
        _, slot = max(victims)
        act = self._slots[slot]
        req = act.req
        gen = req.max_new_tokens - act.remaining
        req.payload = list(req.payload) + [int(t) for t in
                                           req.tokens[-gen:]]
        req.max_new_tokens = act.remaining
        self.cache.release(slot)
        self._slots[slot] = None
        self._stash.appendleft(req)
        self._preemptions += 1
        self._preempt_counter.inc()
        preempts = getattr(req, "_tr_preempts", None)
        if preempts is not None:
            preempts.append(time.monotonic())
        obs.get_tracer().event(spans.EVENT_PREEMPT, slot=slot,
                               request=req.id, owed=act.remaining)
        return slot

    # ---------------------------------------------------------------- step
    def _complete(self, slot: int, error: Optional[str] = None):
        act = self._slots[slot]
        self.cache.release(slot)
        self._slots[slot] = None
        req = act.req
        now = time.monotonic()
        exemplar = None
        if getattr(req, "_tr_admits", None) is not None:
            # the spans reach the collector BEFORE finish() wakes the
            # client, so a router in this process finishes the trace
            # after the engine has
            if self._finalize_trace(req, error, now):
                exemplar = {"trace_id": req.trace.trace_id}
        req.finish(error, t_done=now)
        self._t_last_done = req.t_done
        n_tok = len(req.tokens)
        self._lat.labels(engine="lm", kind="e2e").observe(
            req.e2e_s, exemplar=exemplar)
        if n_tok > 1:
            self._lat.labels(engine="lm", kind="per_token").observe(
                (req.t_done - req.t_first) / (n_tok - 1))
        self._req_counter.labels(
            engine="lm", status="error" if error else "ok").inc()
        self.completed.append(
            {"id": req.id, "e2e_s": req.e2e_s, "ttft_s": req.ttft_s,
             "tokens": n_tok})
        if self.slo_s > 0:
            self._slo_window.append(1.0 if req.e2e_s <= self.slo_s else 0.0)

    def _finalize_trace(self, req: ServeRequest, error: Optional[str],
                        now: float) -> bool:
        """Split the request's engine e2e (``now - t_submit``) into its
        spans and pass them through the tail sampler.  The partition is
        exact: queue + prefill + preempt + decode == e2e, decode being
        the remainder.  Returns whether the trace was kept."""
        col = reqtrace.get_collector()
        ctx = req.trace
        e2e = max(0.0, now - req.t_submit)
        admits, preempts = req._tr_admits, req._tr_preempts
        queue = (max(0.0, admits[0]["t"] - req.t_submit)
                 if admits else e2e)
        prefill = sum(a["dur"] for a in admits)
        col.span(ctx, spans.SPAN_QUEUE, req.t_submit, queue, engine="lm")
        for a in admits:
            col.span(ctx, spans.SPAN_PREFILL, a["t"], a["dur"],
                     slot=a["slot"], bucket=a["bucket"],
                     prompt_len=a["prompt_len"], engine="lm")
        # each preemption pairs with the NEXT admission: the gap is what
        # the preemption cost this request
        preempt_wait = 0.0
        for i, tp in enumerate(preempts):
            if i + 1 < len(admits):
                gap = max(0.0, admits[i + 1]["t"] - tp)
                preempt_wait += gap
                col.span(ctx, spans.SPAN_PREEMPT, tp, gap, engine="lm")
        decode = max(0.0, e2e - queue - prefill - preempt_wait)
        t_dec = req.t_first if req.t_first is not None else now
        col.span(ctx, spans.SPAN_DECODE, t_dec, decode,
                 tokens=len(req.tokens), engine="lm")
        kept, _ = col.finish(
            ctx, request=str(req.router_id or req.id), error=error,
            preempted=bool(preempts),
            slo_violation=(self.slo_s > 0 and e2e > self.slo_s),
            handoff=(error == HANDOFF_ERROR), e2e_s=e2e)
        return kept

    def _step(self) -> bool:
        active_slots = [i for i, s in enumerate(self._slots)
                        if s is not None]
        if not active_slots:
            return False
        # grow pages where the next position crosses a page boundary;
        # exhaustion preempts the youngest request (possibly this one)
        for slot in list(active_slots):
            if self._slots[slot] is None:
                continue
            while self.cache.needs_growth(slot):
                if self.cache.grow(slot):
                    continue
                victim = self._preempt_youngest()
                if victim is None or victim == slot:
                    break
        active_slots = [i for i, s in enumerate(self._slots)
                        if s is not None]
        if not active_slots:
            return False
        tokens = np.zeros((self.max_batch,), np.int32)
        temps = np.zeros((self.max_batch,), np.float32)
        active = np.zeros((self.max_batch,), bool)
        for i in active_slots:
            tokens[i] = self._slots[i].last_token
            temps[i] = self._slots[i].req.temperature
            active[i] = True
        if self.decode_bucket:
            longest = max(int(self.cache.lengths[i]) for i in active_slots)
            bucket = used_page_bucket(longest, self.page_size,
                                      self.cache.max_pages_per_slot)
        else:
            bucket = self.cache.max_pages_per_slot
        self._last_bucket = bucket
        impl, block_pages = self._decode_impl_for(bucket)
        t0 = time.perf_counter()
        c0 = time.thread_time()
        # a live tracer span around the step, dispatch to resolved tokens
        with obs.get_tracer().span(spans.SPAN_STEP_DECODE, bucket=bucket,
                                   active=len(active_slots)):
            nxt = self._decode(
                np.ascontiguousarray(self.cache.page_tables[:, :bucket]),
                self.cache.lengths.copy(), tokens, temps, active, impl,
                block_pages)
        step_ms = (time.perf_counter() - t0) * 1000.0
        self._steps += 1
        self._decode_ms_sum += step_ms
        self._decode_cpu_ms_sum += (time.thread_time() - c0) * 1000.0
        self._last_step_bytes = (self._weight_bytes + self.n_layer
                                 * decode_hbm_bytes(
                                     impl, self.max_batch, self.n_head,
                                     self.head_dim, self.page_size, bucket,
                                     self.cache.kp.element_size())
                                 ) / len(active_slots)
        self._occ_sum += len(active_slots) / self.max_batch
        self._occ_gauge.set(self._occ_sum / self._steps)
        for i in active_slots:
            act = self._slots[i]
            tok = int(nxt[i])
            self.cache.lengths[i] += 1
            act.last_token = tok
            act.remaining -= 1
            act.req.tokens.append(tok)
            self._tokens_total += 1
            self._tokens_counter.inc()
            if act.remaining <= 0 or tok == self.eos_id:
                self._complete(i)
        return True

    def _decode(self, tables, lengths, tokens, temps, active, impl: str,
                block_pages: int):
        """One decode step from its host inputs (numpy; ``tables`` the
        used-page bucket) on this rank's weights, the leader announcing
        them first.  Returns the next tokens (numpy)."""
        self._announce("step", tables, lengths, tokens, temps, active, impl,
                       block_pages)
        args = [torch.from_numpy(a).to(self.device)
                for a in (tables, lengths, tokens, temps, active)]
        if self._tp_step is None:
            nxt = paged_decode_math(
                self.model, self.page_size, self.cache.kp, self.cache.vp,
                *args, self._gen, attn_impl=impl,
                attn_block_pages=block_pages, qparams=self._qparams)
        else:
            nxt = self._tp_step(self._tp_local, self.cache.kp,
                                self.cache.vp, *args, self._gen,
                                attn_impl=impl, attn_block_pages=block_pages)
        return nxt.cpu().numpy()

    def _announce(self, kind: str, *args) -> None:
        """The leader's broadcast of a prefill's or step's host inputs,
        with its swap count, to its followers (nothing at tp = 1 and on
        a follower)."""
        if self._tp_step is not None and self._tp_rank == 0:
            import torch.distributed as dist

            dist.broadcast_object_list([(kind, self.swaps) + args],
                                       src=self._leader, group=self._ctrl)

    def follow(self) -> None:
        """A follower's loop: replay the leader's prefills and decode
        steps on this rank's shard, after the swaps each announces,
        until the leader's ``close()``."""
        if self._tp_step is None or self._tp_rank == 0:
            raise RuntimeError("follow() runs on a follower rank of a "
                               "tp > 1 engine")
        import torch.distributed as dist

        while True:
            box = [None]
            dist.broadcast_object_list(box, src=self._leader,
                                       group=self._ctrl)
            kind, swaps, *args = box[0]
            if kind == "stop":
                return
            staged = []
            while self.swaps + len(staged) < swaps:
                # swap_weights on this rank stages what the leader flips
                with self._staged_cv:
                    while not self._staged:
                        self._staged_cv.wait()
                    staged.append(self._staged.popleft())
            # the flips and the step under the engine lock, as the
            # leader's swap_weights and pump take them
            with self._lock, self._on_stream():
                for one in staged:
                    self._flip(*one)
                if kind == "prefill":
                    self._prefill(*args)
                else:
                    self._decode(*args)
                    self._steps += 1

    def _decode_impl_for(self, bucket: int):
        """(impl, block_pages) of the decode attention at this used-page
        bucket (JAX ``_decode_impl_for``, serving/engine.py:425-449),
        resolved once a bucket: ``decode_attn`` as given, or for "auto"
        the static dense path, or with the tuner on its ``decode_attn``
        decision for (max_batch, heads, head_dim, page size, bucket) on
        the engine's device, at a TP rank's local heads (JAX :439)."""
        hit = self._impl_by_bucket.get(bucket)
        if hit is not None:
            return hit
        impl, block_pages = self.decode_attn, 0
        if impl == "auto":
            impl = "dense"
            from bigdl_tpu_torch.ops import autotune

            if autotune.enabled():
                rec = autotune.decide_decode_attn(
                    (self.max_batch, self.n_head // self.tp, self.head_dim),
                    self.page_size, bucket, self.model.wte.weight.dtype,
                    kv_dtype=self.cache.kp.dtype, device=self.device)
                if rec is not None:
                    impl = rec.get("impl", "dense")
                    block_pages = int(rec.get("block_pages") or 0)
        self._impl_by_bucket[bucket] = (impl, block_pages)
        return impl, block_pages

    # ---------------------------------------------------------- driving
    def _on_stream(self):
        """Queue what follows on the engine's stream (no-op on the
        CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def pump(self, wait_s: float = 0.0) -> bool:
        """One admission + decode cycle; True while there is work."""
        with self._lock, self._on_stream():
            self._admit(wait_s=wait_s if not self.active_count() else 0.0)
            stepped = self._step()
            return stepped or bool(self._stash) \
                or self.queue.depth() > 0

    def run_until_idle(self, timeout_s: float = 60.0):
        """Drive synchronously until queue + slots drain."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self.pump(wait_s=0.01):
                if self.queue.depth() == 0 and not self.active_count() \
                        and not self._stash:
                    return
        raise TimeoutError(f"engine not idle after {timeout_s:g}s")

    def start(self):
        """Drive the engine on a background thread until close() (a
        follower's thread runs ``follow()``)."""
        if self._thread is not None:
            return self
        self._stop = False
        if self._tp_rank:
            self._thread = threading.Thread(
                target=self.follow, name="bigdl-torch-serve-lm-follow",
                daemon=True)
            self._thread.start()
            return self

        def loop():
            while not self._stop:
                if self._waiters:
                    time.sleep(0.0005)
                elif not self.pump(wait_s=0.02):
                    time.sleep(0.002)

        self._thread = threading.Thread(
            target=loop, name="bigdl-torch-serve-lm", daemon=True)
        self._thread.start()
        return self

    @contextlib.contextmanager
    def locked(self):
        """Hold the engine lock from outside the step loop (a drain, a
        swap).  The loop takes the lock again as soon as it lets go of
        it, so a plain acquire from another thread could wait until the
        engine goes idle; while a caller waits here, the loop stands
        aside at its next step boundary."""
        with self._waiters_lock:
            self._waiters += 1
        try:
            with self._lock:
                yield
        finally:
            with self._waiters_lock:
                self._waiters -= 1

    def drain(self, deadline_s: float = 10.0):
        """Stop admissions, let in-flight decodes finish within the
        deadline, checkpoint the rest (``serving/drain.py``).  Returns
        the ``HandoffRecord`` list a router replays elsewhere exactly
        once."""
        return drain_engine(self, deadline_s=deadline_s)

    def close(self):
        """Stop the loop and the queue; requests still queued or in
        flight finish with ``HANDOFF_ERROR`` so no client waits on
        them.  A TP leader then ends its followers' loops; a follower
        waits for that end."""
        self._stop = True
        if self._thread is not None:
            # a follower's loop ends only at its leader's close
            self._thread.join(timeout=None if self._tp_rank else 5.0)
            self._thread = None
        self.queue.close()
        with self._lock:
            for i, s in enumerate(self._slots):
                if s is not None:
                    self._complete(i, error=HANDOFF_ERROR)
            pending = list(self._stash) + self.queue.take(
                self.queue.capacity)
            self._stash.clear()
            for req in pending:
                req.finish(HANDOFF_ERROR)
            if not self._closed:
                self._announce("stop")
            self._closed = True

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        e2e = [c["e2e_s"] for c in self.completed]
        ttft = [c["ttft_s"] for c in self.completed
                if c["ttft_s"] is not None]
        busy = None
        if self._t_first_work is not None and self._t_last_done:
            busy = self._t_last_done - self._t_first_work

        def pct(vals, q):
            return float(np.percentile(vals, q)) if vals else None

        return {
            "requests": len(self.completed),
            "tokens": self._tokens_total,
            "steps": self._steps,
            "busy_s": busy,
            "tokens_per_s": (self._tokens_total / busy if busy else None),
            "occupancy_mean": (self._occ_sum / self._steps
                               if self._steps else None),
            "queue_depth": self.queue.depth(),
            "kv_pages_in_use": self.cache.pages_in_use(),
            "kv_pages_total": self.cache.num_pages - 1,
            "draining": self.draining,
            "weight_version": self.weight_version,
            "manifest_sha": self.manifest_sha,
            "weight_swaps": self.swaps,
            "int8": self.int8,
            "tp": self.tp,
            "preemptions": self._preemptions,
            "e2e_p50_s": pct(e2e, 50), "e2e_p99_s": pct(e2e, 99),
            "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
            "slo_ratio": (sum(self._slo_window) / len(self._slo_window)
                          if self._slo_window else None),
            "admission": self.admission,
            "decode_attn": self.decode_attn,
            "decode_bucket": self.decode_bucket,
            "last_bucket_pages": self._last_bucket,
            "decode_ms_mean": (self._decode_ms_sum / self._steps
                               if self._steps else None),
            "decode_cpu_ms_mean": (self._decode_cpu_ms_sum / self._steps
                                   if self._steps else None),
            "decode_hbm_bytes_per_token": self._last_step_bytes,
        }


__all__ = ["LMEngine", "LAT_META", "paged_decode_math", "HANDOFF_ERROR"]
