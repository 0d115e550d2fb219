"""Continuous-batching LM decode engine.

Counterpart of ``bigdl_tpu/serving/engine.py`` on the float path with
one device (the JAX package's ``tp=1``, ``int8=False``):

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
* **preemption**: if the page pool runs out mid-decode, the youngest
  request gives its pages back and re-queues with its generated prefix
  folded into the prompt.

PyTorch runs eagerly, so there is no per-bucket compile cache: each
prefill bucket and decode page bucket is just a shape.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.config import ServeConfig
from bigdl_tpu_torch.ops.decode_attention import (decode_hbm_bytes,
                                                  paged_decode_attention,
                                                  used_page_bucket)
from bigdl_tpu_torch.serving.batcher import RequestQueue, ServeRequest
from bigdl_tpu_torch.serving.cache import PagedKVCache

# the error a request still queued or in flight at close() finishes
# with, so that a router can replay it elsewhere
HANDOFF_ERROR = "handoff"

DECODE_ATTN_IMPLS = ("auto", "dense", "kernel")


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
                      attn_impl: str = "dense"):
    """One decode step over the paged cache for every slot.  Mirrors
    ``TransformerBlock.decode_step``: the slot's new K/V are written at
    position ``lengths`` BEFORE attending, so ``length + 1`` positions
    attend; ``wpe`` is indexed by ``lengths``.  ``kp``/``vp`` are the
    (L, pages, H, P, Dh) pools, updated in place; ``tables`` may be the
    used-page bucket.  Returns the next token of every slot (0 where
    ``active`` is False)."""
    blocks = model.blocks()
    attn0 = blocks[0].attn
    heads, head_dim = attn0.n_head, attn0.head_dim
    bsz = tokens.shape[0]
    scale = 1.0 / math.sqrt(head_dim)
    pos = lengths.long()
    x = (model.wte.weight[tokens.long()] + model.wpe.weight[pos])[:, None, :]
    pidx = tables.long().gather(1, (pos // page_size)[:, None])[:, 0]
    off = pos % page_size
    for i, block in enumerate(blocks):
        attn = block.attn
        q, k, v = attn.project_qkv(block.ln1(x))
        qh = q.reshape(bsz, heads, head_dim)
        # the new token's K/V go into the pools in place (the JAX
        # package returns new pools via .at[].set with donation)
        kp[i, pidx, :, off] = k.reshape(bsz, heads, head_dim).to(kp.dtype)
        vp[i, pidx, :, off] = v.reshape(bsz, heads, head_dim).to(vp.dtype)
        o = paged_decode_attention(qh, kp[i], vp[i], tables, lengths,
                                   page_size=page_size, scale=scale,
                                   impl=attn_impl)
        x = x + attn.out_proj(o.reshape(bsz, 1, heads * head_dim))
        x = block.mlp(x)
    logits = model.head(model.ln_f(x))[:, 0, :]
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

    ``decode_attn``: "auto" (= "dense"), "dense" or "kernel" (the paged
    flash-decode).  The model's ``attn_impl`` decides the prefill
    attention.  ``device`` defaults to the card; the model must already
    live on it."""

    def __init__(self, model, *, max_batch: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 eos_id: Optional[int] = None,
                 slo_s: Optional[float] = None,
                 admission: Optional[str] = None,
                 decode_attn: Optional[str] = None,
                 decode_bucket: Optional[bool] = None, seed: int = 0,
                 device="cuda"):
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
                f"decode_attn must be auto|dense|kernel, got "
                f"{self.decode_attn!r}")
        self.decode_bucket = (cfg.decode_bucket if decode_bucket is None
                              else bool(decode_bucket))
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
        if cache_dtype is None:
            cache_dtype = model.wte.weight.dtype
        pages = num_pages or cfg.num_pages or (
            1 + self.max_batch * -(-self.max_len // self.page_size))
        self.cache = PagedKVCache(
            self.n_layer, self.n_head, self.head_dim,
            page_size=self.page_size, num_pages=pages,
            max_slots=self.max_batch, max_len=self.max_len,
            dtype=cache_dtype, device=self.device)
        self.queue = RequestQueue(queue_capacity or cfg.queue_capacity)
        self._slots: List[Optional[_Active]] = [None] * self.max_batch
        self._stash: collections.deque = collections.deque()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._order = 0
        self._steps = 0
        self._occ_sum = 0.0
        self._tokens_total = 0
        self._preemptions = 0
        self._t_first_work: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self.completed: List[dict] = []
        self._slo_window: collections.deque = collections.deque(maxlen=256)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        self._last_bucket = self.cache.max_pages_per_slot
        self._decode_ms_sum = 0.0
        self._last_step_bytes: Optional[float] = None
        self._weight_bytes = float(sum(
            p.numel() * p.element_size() for p in model.parameters()))

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def _prefill(self, payload: List[int], bucket: int, pages: List[int],
                 temperature: float) -> int:
        """Prefill one prompt padded with token 0 to ``bucket``: write
        its ``bucket // P`` pages (those past the allocation point at
        trash page 0) and return the first token, read from row t0-1."""
        model, dev, p = self.model, self.device, self.page_size
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
            shape = (self.n_head, n_write, p, self.head_dim)
            self.cache.kp[i, page_arg] = kh[0].reshape(shape).transpose(
                0, 1).to(self.cache.dtype)
            self.cache.vp[i, page_arg] = vh[0].reshape(shape).transpose(
                0, 1).to(self.cache.dtype)
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
               timeout: Optional[float] = None) -> ServeRequest:
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
        req = ServeRequest(payload=prompt,
                           max_new_tokens=int(max_new_tokens),
                           temperature=float(temperature))
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
        t0 = len(req.payload)
        bucket = self._bucket(t0)
        pages = self.cache.alloc(slot, t0)
        tok = self._prefill(req.payload, bucket, pages, req.temperature)
        self.cache.lengths[slot] = t0
        if req.t_first is None:
            req.t_first = time.monotonic()
        req.tokens.append(tok)
        self._tokens_total += 1
        if self._t_first_work is None:
            self._t_first_work = time.monotonic()
        self._order += 1
        act = _Active(req, req.max_new_tokens - 1, tok, self._order)
        self._slots[slot] = act
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
        return slot

    # ---------------------------------------------------------------- step
    def _complete(self, slot: int, error: Optional[str] = None):
        act = self._slots[slot]
        self.cache.release(slot)
        self._slots[slot] = None
        req = act.req
        req.finish(error)
        self._t_last_done = req.t_done
        self.completed.append(
            {"id": req.id, "e2e_s": req.e2e_s, "ttft_s": req.ttft_s,
             "tokens": len(req.tokens)})
        if self.slo_s > 0:
            self._slo_window.append(1.0 if req.e2e_s <= self.slo_s else 0.0)

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
        tables, lengths = self.cache.device_tables(pages=bucket)
        dev = self.device
        t0 = time.perf_counter()
        nxt = paged_decode_math(
            self.model, self.page_size, self.cache.kp, self.cache.vp,
            tables, lengths, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(temps).to(dev),
            torch.from_numpy(active).to(dev), self._gen,
            attn_impl=self.decode_attn).cpu().numpy()
        step_ms = (time.perf_counter() - t0) * 1000.0
        self._steps += 1
        self._decode_ms_sum += step_ms
        impl = "dense" if self.decode_attn in ("auto", "dense") else "kernel"
        self._last_step_bytes = (self._weight_bytes + self.n_layer
                                 * decode_hbm_bytes(
                                     impl, self.max_batch, self.n_head,
                                     self.head_dim, self.page_size, bucket,
                                     self.cache.kp.element_size())
                                 ) / len(active_slots)
        self._occ_sum += len(active_slots) / self.max_batch
        for i in active_slots:
            act = self._slots[i]
            tok = int(nxt[i])
            self.cache.lengths[i] += 1
            act.last_token = tok
            act.remaining -= 1
            act.req.tokens.append(tok)
            self._tokens_total += 1
            if act.remaining <= 0 or tok == self.eos_id:
                self._complete(i)
        return True

    # ---------------------------------------------------------- driving
    def pump(self, wait_s: float = 0.0) -> bool:
        """One admission + decode cycle; True while there is work."""
        with self._lock:
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
        """Drive the engine on a background thread until close()."""
        if self._thread is not None:
            return self
        self._stop = False

        def loop():
            while not self._stop:
                if not self.pump(wait_s=0.02):
                    time.sleep(0.002)

        self._thread = threading.Thread(
            target=loop, name="bigdl-torch-serve-lm", daemon=True)
        self._thread.start()
        return self

    def close(self):
        """Stop the loop and the queue; requests still queued or in
        flight finish with ``HANDOFF_ERROR`` so no client waits on
        them."""
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
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
            "decode_hbm_bytes_per_token": self._last_step_bytes,
        }


__all__ = ["LMEngine", "paged_decode_math", "HANDOFF_ERROR"]
