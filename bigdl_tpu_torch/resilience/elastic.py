"""Elastic resume of the port: the stream's half.

Counterpart of ``restore_stream`` in ``bigdl_tpu/resilience/elastic.py``
(:508-524).  The rest of that module (preemption, heartbeats, a resume
at another world size through ``ensure_shard_layout``) is not ported
yet (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations


def restore_stream(optimizer, extra) -> bool:
    """Apply a checkpoint's ``stream`` state to a streaming dataset
    (``dataset/stream.py``): seek the source back to the trained
    offset, so the resume re-reads exactly the records the restored
    weights do not hold.  A stream seeks by offset instead of replaying
    an epoch's batch order, so the epoch fast-forward is cleared.
    Returns True when the optimizer's dataset is a stream.
    ``DistriOptimizer``'s retry calls this after
    ``load_latest_checkpoint``."""
    restore = getattr(getattr(optimizer, "dataset", None),
                      "stream_restore", None)
    if restore is None:
        return False
    restore((extra or {}).get("stream"))
    optimizer._pending_fast_forward = 0
    return True


__all__ = ["restore_stream"]
