"""Unbounded streaming datasets: continuous training input.

Counterpart of ``bigdl_tpu/dataset/stream.py`` (the whole module).
Three pieces:

* :class:`StreamSource`: a **replayable** record source; ``read(off)``
  yields records from an absolute offset, any number of times.  The
  training checkpoint is the commit point, and the source can always
  be re-read from it.
* :class:`BoundedBuffer`: one producer thread pulls the source into a
  bounded in-memory queue.  A full buffer **backpressures** the
  producer (it waits, it does not drop); the live depth is the
  ``bigdl_stream_buffer_depth`` gauge and each wait counts in
  ``bigdl_stream_backpressure_waits_total``.
* :class:`StreamDataSet`: the ``DataSet`` the trainers consume.  It
  assembles fixed-size batches, carries a per-record watermark (the
  event time up to which the stream has been trained) and two offsets:
  the *yielded* frontier (what left the iterator, possibly prefetched
  ahead by the trainer's feed thread) and the *trained* frontier
  (advanced by :meth:`StreamDataSet.note_batch_trained`, which the
  trainers call once a dispatched batch).

**Exactly-once over crashes**: ``stream_checkpoint_state`` (the
trained offset and watermark) rides the checkpoint's ``extra`` and its
manifest, and ``DistriOptimizer``'s retry calls ``stream_restore``
(through ``resilience/elastic.restore_stream``), which seeks the source
back to the trained offset and drops everything prefetched past it.
The records between the checkpoint and a crash are read and trained
again against the restored weights, so each is in the surviving
trajectory once.  The knobs are ``BIGDL_TORCH_STREAM_BUFFER`` and
``BIGDL_TORCH_STREAM_EPOCH_RECORDS``.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.obs import names

log = logging.getLogger("bigdl_tpu_torch.dataset")


class StreamRecord(NamedTuple):
    """One stream record: absolute ``offset`` (the record id), payload,
    and the source-assigned ``event_time`` the watermark tracks."""

    offset: int
    features: np.ndarray
    label: np.ndarray
    event_time: float


class StreamSource:
    """Replayable record source.

    ``read(offset)`` must yield :class:`StreamRecord`\\ s with
    consecutive offsets starting at ``offset``, and must be callable
    any number of times (resume = re-read).  A bounded source's
    iterator simply ends; an unbounded one never does.
    """

    def read(self, offset: int) -> Iterator[StreamRecord]:
        raise NotImplementedError

    def available(self) -> Optional[int]:
        """Records currently available (the ingest frontier), or None
        when unknown.  Lets the dataset export consumer lag."""
        return None


class SyntheticStream(StreamSource):
    """Deterministic synthetic stream for tests and smokes.

    Record ``i`` is a pure function of ``(seed, i)``: a replay from
    any offset is bit-identical, the property the exactly-once audits
    key on, and the records are the JAX package's.  The task is a
    learnable linear separation.  ``rate`` (records per second)
    simulates arrival time: ``read`` blocks until record ``i`` has
    "arrived", so a slow stream starves the buffer and a fast one
    fills it.
    """

    def __init__(self, feature_dim: int = 16, n_classes: int = 4,
                 seed: int = 0, limit: Optional[int] = None,
                 rate: Optional[float] = None, clock=time.monotonic):
        self.feature_dim = int(feature_dim)
        self.n_classes = int(n_classes)
        self.seed = int(seed)
        self.limit = None if limit is None else int(limit)
        self.rate = None if rate in (None, 0) else float(rate)
        self._clock = clock
        self._t0 = clock()
        # a fixed projection makes labels a deterministic function of
        # features, so the task is learnable and loss curves comparable
        rs = np.random.RandomState(self.seed)
        self._w = rs.randn(self.feature_dim, self.n_classes)

    def record(self, i: int) -> StreamRecord:
        rs = np.random.RandomState((self.seed * 1000003 + i) % (1 << 31))
        x = rs.randn(self.feature_dim).astype(np.float32)
        y = np.float32(int(np.argmax(x @ self._w)) + 1)  # 1-based labels
        return StreamRecord(i, x, y, float(i))

    def available(self) -> Optional[int]:
        if self.rate is None:
            return self.limit
        arrived = int((self._clock() - self._t0) * self.rate)
        return arrived if self.limit is None else min(self.limit, arrived)

    def read(self, offset: int) -> Iterator[StreamRecord]:
        i = int(offset)
        if self.rate is not None:
            avail = self.available()
            if avail is not None and avail < i:
                # a resumed consumer reads RETAINED history instantly:
                # records below its first offset already arrived in a
                # previous attempt's lifetime — rebase the arrival
                # clock so only the live edge is rate-limited
                self._t0 = self._clock() - i / self.rate
        while self.limit is None or i < self.limit:
            if self.rate is not None:
                # arrival simulation: record i exists only after i/rate
                while True:
                    avail = self.available()
                    if avail is None or avail > i:
                        break
                    time.sleep(min(0.05, 1.0 / self.rate))
            yield self.record(i)
            i += 1


_END = object()  # buffer sentinel: the source's iterator ended


class BoundedBuffer:
    """Bounded producer/consumer queue between a source and the batch
    assembler.

    One daemon producer thread pulls ``source.read(offset)``; a full
    buffer makes it *wait* (backpressure — counted in
    ``bigdl_stream_backpressure_waits_total``), never drop.  The
    consumer blocks in :meth:`get` until a record (or the end sentinel)
    arrives.  The live depth is published as the
    ``bigdl_stream_buffer_depth`` gauge (``/metrics``)."""

    def __init__(self, source: StreamSource, capacity: int):
        self.source = source
        self.capacity = max(1, int(capacity))
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        reg = obs.get_registry()
        self._depth_gauge = reg.gauge(
            names.STREAM_BUFFER_DEPTH,
            "Records buffered between the stream source and the trainer")
        self._bp_counter = reg.counter(
            names.STREAM_BACKPRESSURE_WAITS_TOTAL,
            "Producer waits on a full stream buffer")

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def start(self, offset: int):
        self._thread = threading.Thread(
            target=self._produce, args=(int(offset),),
            name="bigdl-torch-stream-producer", daemon=True)
        self._thread.start()
        return self

    def _produce(self, offset: int):
        try:
            for rec in self.source.read(offset):
                with self._cond:
                    while len(self._q) >= self.capacity and not self._stop:
                        self._bp_counter.inc()
                        self._cond.wait(timeout=0.1)
                    if self._stop:
                        return
                    self._q.append(rec)
                    self._depth_gauge.set(float(len(self._q)))
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            self._error = e
        finally:
            with self._cond:
                self._q.append(_END)
                self._cond.notify_all()

    def get(self, timeout: Optional[float] = None):
        """Next record, or ``None`` when the stream ended.  Re-raises a
        producer-side error on the consumer thread (a broken source
        must fail the step, not silently end the stream)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._q:
                # the consumer outran the producer: the depth gauge
                # falls now, not at the producer's next put
                self._depth_gauge.set(0.0)
                remain = None if deadline is None \
                    else deadline - time.monotonic()
                if remain is not None and remain <= 0:
                    raise TimeoutError(
                        f"stream buffer empty for {timeout:g}s (source "
                        "stalled?)")
                self._cond.wait(timeout=0.1 if remain is None
                                else min(0.1, remain))
            rec = self._q.popleft()
            if rec is _END:
                self._q.append(_END)  # idempotent end for late callers
                # the sentinel is not a record: a drained stream's
                # queue signal is zero, not the last put's depth
                self._depth_gauge.set(0.0)
                if self._error is not None:
                    raise RuntimeError(
                        "stream source failed") from self._error
                return None
            # stamp on takes as well as puts, so the signal tracks the
            # consumer side of the queue too (the end sentinel is not a
            # record — don't let it hold the gauge at 1)
            depth = len(self._q)
            if depth and self._q[-1] is _END:
                depth -= 1
            self._depth_gauge.set(float(depth))
            self._cond.notify_all()
            return rec

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._depth_gauge.set(0.0)


class StreamDataSet(DataSet):
    """``DataSet`` over an unbounded (or bounded) :class:`StreamSource`.

    Yields fixed-shape ``(features, labels)`` batches of exactly
    ``batch_size`` consecutive records; a ragged tail below a full
    batch stays *unconsumed* at the trained frontier (never dropped,
    never half-trained; a later epoch with more arrivals picks it up).
    ``epoch_records`` bounds one ``data()`` iterator so epoch-keyed
    triggers stay meaningful on continuous ingest; 0/None = the
    iterator runs until the source ends (use ``Trigger.max_iteration``).

    The exactly-once contract (module docstring): the driver loop calls
    :meth:`note_batch_trained` once per dispatched batch, checkpoints
    ride :meth:`stream_checkpoint_state`, resumes call
    :meth:`stream_restore`.  One active iterator at a time (the
    optimizer's driver loop guarantees this); a fresh ``data()`` call
    always restarts from the trained frontier, so prefetched-but-
    untrained records from an abandoned iterator are re-read."""

    per_process = False  # yields GLOBAL batches; the optimizer shards
    streaming = True

    def __init__(self, source: StreamSource, batch_size: int = 32,
                 epoch_records: Optional[int] = None,
                 buffer_records: Optional[int] = None,
                 start_offset: int = 0, poll_timeout_s: float = 60.0,
                 audit_log: bool = False):
        from bigdl_tpu_torch.config import TrainConfig

        cfg = TrainConfig.from_env()
        self.source = source
        self.batch_size = int(batch_size)
        if epoch_records is None:
            epoch_records = cfg.stream_epoch_records or None
        if epoch_records is not None:
            epoch_records = int(epoch_records)
            if epoch_records % self.batch_size:
                raise ValueError(
                    f"epoch_records {epoch_records} not divisible by "
                    f"batch_size {self.batch_size}")
        self.epoch_records = epoch_records
        self.buffer_records = int(buffer_records or cfg.stream_buffer)
        self.poll_timeout_s = float(poll_timeout_s)
        self._lock = threading.Lock()
        self._offset = int(start_offset)      # yielded frontier
        self._trained = {"offset": int(start_offset), "watermark": None,
                         "records": 0}
        self._pending: collections.deque = collections.deque()
        # optional in-memory audit trail of trained (start, end) ranges
        # — what the exactly-once smoke asserts over
        self.audit_log: Optional[list] = [] if audit_log else None
        reg = obs.get_registry()
        self._offset_gauge = reg.gauge(
            names.STREAM_OFFSET,
            "Trained stream frontier (records incorporated into the "
            "current trajectory)")
        self._watermark_gauge = reg.gauge(
            names.STREAM_WATERMARK,
            "Event-time watermark of the trained stream frontier")
        self._lag_gauge = reg.gauge(
            names.STREAM_LAG_RECORDS,
            "Ingest frontier minus trained frontier (consumer lag)")
        self._records_counter = reg.counter(
            names.STREAM_RECORDS_TOTAL,
            "Stream records consumed into training batches")

    # ------------------------------------------------------------ state
    def size(self) -> int:
        avail = self.source.available()
        return self.epoch_records or avail or self.batch_size

    def seek(self, offset: int, watermark: Optional[float] = None):
        """Reposition the stream: the next yielded record is
        ``offset``.  Drops every pending (yielded-untrained) batch —
        they will be re-read."""
        with self._lock:
            self._offset = int(offset)
            self._pending.clear()
            self._trained = {"offset": int(offset), "watermark": watermark,
                             "records": self._trained["records"]}
            self._offset_gauge.set(float(offset))
            if watermark is not None:
                self._watermark_gauge.set(float(watermark))

    def stream_checkpoint_state(self) -> dict:
        """What rides the checkpoint ``extra`` (optimizer
        ``_checkpoint_extra``): the trained offset + watermark.  The
        offset is the exactly-once commit point — everything below it
        is in the weights, everything at/above it will be re-read."""
        with self._lock:
            return dict(self._trained)

    def stream_restore(self, state: Optional[dict]):
        """Resume from a checkpoint's ``stream`` state
        (``elastic.restore_stream`` calls this; a checkpoint without
        one restarts at 0, loudly, because that replays the whole
        retained stream)."""
        state = state or {}
        if "offset" not in state:
            log.warning("stream_restore: checkpoint carries no stream "
                        "state — restarting the stream at offset 0")
        self.seek(int(state.get("offset", 0)), state.get("watermark"))
        obs.get_tracer().event(
            "elastic.stream_restore", offset=self._trained["offset"],
            watermark=self._trained["watermark"])

    def note_batch_trained(self) -> Optional[dict]:
        """Advance the trained frontier by one dispatched batch (the
        driver loop calls this right after it hands a batch to the
        train step).  All dispatched steps resolve before any
        checkpoint (the driver flushes its pipeline first), so the
        frontier is always checkpoint-consistent."""
        with self._lock:
            if not self._pending:
                log.warning("note_batch_trained with no pending batch "
                            "(iterator restarted underneath the loop?)")
                return None
            meta = self._pending.popleft()
            self._trained["offset"] = meta["end"]
            self._trained["watermark"] = meta["watermark"]
            self._trained["records"] += meta["end"] - meta["start"]
            self._offset_gauge.set(float(meta["end"]))
            self._watermark_gauge.set(float(meta["watermark"]))
            avail = self.source.available()
            if avail is not None:
                self._lag_gauge.set(float(max(0, avail - meta["end"])))
            if self.audit_log is not None:
                self.audit_log.append((meta["start"], meta["end"]))
            return meta

    # ------------------------------------------------------------- data
    def data(self, train: bool = True):
        del train  # a stream has no shuffle and no eval-tail variant
        with self._lock:
            # always restart from the TRAINED frontier: anything a
            # previous iterator yielded but the loop never trained is
            # re-read, not skipped
            self._pending.clear()
            self._offset = self._trained["offset"]
            start = self._offset
        buf = BoundedBuffer(self.source, self.buffer_records).start(start)
        feats, lbls = [], []
        batch_start = start
        watermark = None
        yielded = 0
        try:
            while self.epoch_records is None \
                    or yielded < self.epoch_records:
                rec = buf.get(timeout=self.poll_timeout_s)
                if rec is None:
                    break  # bounded source ended; ragged tail pends
                feats.append(rec.features)
                lbls.append(rec.label)
                watermark = rec.event_time if watermark is None \
                    else max(watermark, rec.event_time)
                if len(feats) < self.batch_size:
                    continue
                meta = {"start": batch_start, "end": rec.offset + 1,
                        "watermark": watermark}
                with self._lock:
                    self._pending.append(meta)
                    self._offset = rec.offset + 1
                self._records_counter.inc(self.batch_size)
                yield np.stack(feats), np.asarray(lbls)
                yielded += self.batch_size
                feats, lbls = [], []
                batch_start = rec.offset + 1
                watermark = None
        finally:
            buf.stop()


__all__ = ["StreamRecord", "StreamSource", "SyntheticStream",
           "BoundedBuffer", "StreamDataSet"]
