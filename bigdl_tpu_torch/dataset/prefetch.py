"""The trainers' input feed: a producer thread and pinned batches.

Counterpart of ``bigdl_tpu/native/__init__.py``'s ``PrefetchIterator``
(:233), kept here because the port has no C library.  A daemon thread
pulls batches from an iterable (decoding an image folder, slicing a
rank's rows) while the card runs the current step, and, for a CUDA
trainer, copies each batch into page-locked memory (``pin_memory()``),
so the step's ``.to(device, non_blocking=True)`` is an asynchronous
DMA instead of a pageable copy that blocks the host.

Every batch gets fresh pinned tensors, and the producer never writes a
tensor it has handed over.  A non-blocking copy records its stream on
the pinned block in PyTorch's caching host allocator, so the block is
not reused before the copy is done even after the batch is dropped.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch


def to_host_tensor(a, pin: bool) -> Optional[torch.Tensor]:
    """A numpy array (or tensor) as a CPU tensor, page-locked if
    ``pin``; ``None`` stays ``None``."""
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


class PrefetchIterator:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.
    ``waits`` counts the items the consumer had to wait for (the queue
    was empty when it asked) and ``wait_s`` the seconds it waited."""

    def __init__(self, iterable, depth: int = 2):
        self._iterable = iterable
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.waits = 0
        self.items = 0
        self.wait_s = 0.0

    def _put(self, item) -> bool:
        """A bounded put that gives up once the consumer has stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        try:
            for item in self._iterable:
                if not self._put(item):
                    return          # the consumer stopped early
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            self._err = e
        finally:
            self._put(self._done)

    def __iter__(self):
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="bigdl-torch-prefetch")
        self._thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    item = self._queue.get()
                    self.waits += 1
                    self.wait_s += time.perf_counter() - t0
                if item is self._done:
                    if self._err is not None:
                        raise self._err
                    return
                self.items += 1
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the producer and wait for its thread to end."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=30)


__all__ = ["PrefetchIterator", "to_host_tensor"]
