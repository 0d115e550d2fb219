"""Paged KV cache: the memory substrate of continuous batching.

Counterpart of ``bigdl_tpu/serving/cache.py``.  K/V live in fixed-size
pages; each request owns only the pages its tokens fill (a per-slot
page table), and pages return to a free list the moment it completes.

* ``kp``/``vp``: ``(n_layer, num_pages, n_head, page_size, head_dim)``
  tensors on the device, in the cache dtype.  The engine writes them in
  place (the JAX package rebuilt them with ``.at[].set`` and donation);
* page table ``(max_slots, max_pages_per_slot)`` int32 and lengths
  ``(max_slots,)`` int32 live on the host and ship to the device per
  step;
* page 0 is the reserved **trash page**: unallocated table entries and
  the padded tail of a bucketed prefill write there, and the decode
  mask (``position <= length``) keeps it from ever being read into a
  live slot's output.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.common import resolve_device


class PagedKVCache:
    """Host-side page allocator + device-side paged K/V buffers."""

    def __init__(self, n_layer: int, n_head: int, head_dim: int, *,
                 page_size: int = 16, num_pages: int = 64,
                 max_slots: int = 8, max_len: int = 256,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.device = resolve_device(device)
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        # every slot must be able to address a full-length sequence
        self.max_pages_per_slot = -(-self.max_len // self.page_size)
        # page 0 is the reserved trash page, never allocated
        self.num_pages = max(int(num_pages), 2)
        self.dtype = dtype
        shape = (self.n_layer, self.num_pages, self.n_head,
                 self.page_size, self.head_dim)
        self.kp = torch.zeros(shape, dtype=dtype, device=self.device)
        self.vp = torch.zeros(shape, dtype=dtype, device=self.device)
        self.page_tables = np.zeros(
            (self.max_slots, self.max_pages_per_slot), np.int32)
        self.lengths = np.zeros((self.max_slots,), np.int32)
        self._free: List[int] = list(range(1, self.num_pages))
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.max_slots)]

    # --------------------------------------------------------- allocator
    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.page_size))

    def free_pages(self) -> int:
        return len(self._free)

    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        return len(self._free) >= self.pages_for(n_tokens)

    def alloc(self, slot: int, n_tokens: int) -> List[int]:
        """Give ``slot`` enough pages for ``n_tokens``; returns the page
        ids (raises on exhaustion: the engine checks ``can_admit``
        first and preempts on decode-time growth failure)."""
        need = self.pages_for(n_tokens)
        if len(self._free) < need:
            raise RuntimeError(
                f"KV cache exhausted: need {need} pages, "
                f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        self._slot_pages[slot] = pages
        row = np.zeros((self.max_pages_per_slot,), np.int32)
        row[:need] = pages
        self.page_tables[slot] = row
        self.lengths[slot] = 0
        return pages

    def grow(self, slot: int) -> bool:
        """One more page for ``slot`` (its length is about to cross a
        page boundary).  False on exhaustion: the engine preempts."""
        if not self._free:
            return False
        pages = self._slot_pages[slot]
        if len(pages) >= self.max_pages_per_slot:
            return False
        page = self._free.pop()
        pages.append(page)
        self.page_tables[slot, len(pages) - 1] = page
        return True

    def needs_growth(self, slot: int) -> bool:
        """True when the next token's position lands past the slot's
        allocated pages."""
        return (int(self.lengths[slot]) // self.page_size
                >= len(self._slot_pages[slot]))

    def release(self, slot: int):
        """Request finished (or preempted): pages back to the pool, the
        table row points at the trash page again."""
        self._free.extend(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.page_tables[slot] = 0
        self.lengths[slot] = 0

    # ------------------------------------------------------ device state
    def device_tables(self, pages: Optional[int] = None):
        """(page_tables, lengths) as int32 device tensors for the next
        step; ``pages`` slices the table to its first N columns (the
        engine's used-page bucket)."""
        tables = self.page_tables
        if pages is not None and pages < self.max_pages_per_slot:
            tables = tables[:, :int(pages)]
        return (torch.from_numpy(np.ascontiguousarray(tables)).to(self.device),
                torch.from_numpy(self.lengths.copy()).to(self.device))


def gather_pages(pages, page_table):
    """``(num_pages, H, P, Dh)`` pages + ``(B, maxp)`` table ->
    ``(B, H, maxp*P, Dh)`` per-slot contiguous K/V (positions past a
    slot's length are trash and must be masked by the caller)."""
    b, maxp = page_table.shape
    g = pages[page_table.long()]               # (B, maxp, H, P, Dh)
    g = g.transpose(1, 2)                      # (B, H, maxp, P, Dh)
    return g.reshape(b, g.shape[1], maxp * g.shape[3], g.shape[4])


__all__ = ["PagedKVCache", "gather_pages"]
