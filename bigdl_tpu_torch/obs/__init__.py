"""Telemetry of the port (counterpart of ``bigdl_tpu.obs``).

* :mod:`~bigdl_tpu_torch.obs.metrics`: the labelled Counter / Gauge /
  Histogram registry, with exemplars, the Prometheus text export and
  the strict-declaration check;
* :mod:`~bigdl_tpu_torch.obs.names`: every ``bigdl_*`` family the port
  mints, declared once;
* :mod:`~bigdl_tpu_torch.obs.trace`: the span tracer
  (``BIGDL_TORCH_TRACE_DIR`` turns it on);
* :mod:`~bigdl_tpu_torch.obs.reqtrace`: request tracing with tail
  sampling (``BIGDL_TORCH_REQTRACE_SAMPLE``);
* :mod:`~bigdl_tpu_torch.obs.server`: the live ``/metrics``,
  ``/healthz`` and ``/trace`` endpoint (``BIGDL_TORCH_OBS_PORT``);
* :mod:`~bigdl_tpu_torch.obs.collectives`: the trainer's wire bytes,
  from shapes;
* :mod:`~bigdl_tpu_torch.obs.health`: per-layer numerics
  (``BIGDL_TORCH_HEALTH_EVERY``);
* :mod:`~bigdl_tpu_torch.obs.runtime`: the step-time reservoirs and the
  memory, behind :func:`get_runtime` and :func:`publish_runtime`.

Everything is off by default.  The tracer and the request collector are
rebuilt when their knobs change (JAX ``obs/__init__.py:96-115``); a
call whose knobs read as the last one's returns the cached object after
one environment lookup a knob, with no lock, since the engine asks at
every decode step.
"""

from __future__ import annotations

import atexit
import os
import threading

from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs.metrics import DEFAULT_BUCKETS, MetricsRegistry
from bigdl_tpu_torch.obs.runtime import (Reservoir, RuntimeStats,
                                         all_device_memory_stats,
                                         device_memory_stats,
                                         host_rss_bytes)
from bigdl_tpu_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

_lock = threading.Lock()
_tracer = NULL_TRACER
_tracer_dir = None
# (raw BIGDL_TORCH_TRACE_DIR, tracer): one tuple rebind, so the lock-free
# read in get_tracer sees a matched pair
_UNSET = object()
_tracer_state = (_UNSET, NULL_TRACER)
_registry = MetricsRegistry()
_runtime = None
_atexit_registered = False


def _obs_config():
    from bigdl_tpu_torch.config import ObsConfig

    return ObsConfig.from_env()


def active() -> bool:
    """Is any observability output on (a trace directory or the obs
    server's port)?"""
    return _obs_config().active


def get_tracer():
    """The process tracer: a recording :class:`Tracer` bound to
    ``BIGDL_TORCH_TRACE_DIR``, or the shared :data:`NULL_TRACER` when it
    is unset; rebuilt when the directory changes."""
    global _tracer, _tracer_dir, _tracer_state, _atexit_registered
    raw = os.environ.get("BIGDL_TORCH_TRACE_DIR")
    seen, tracer = _tracer_state
    if raw == seen:
        return tracer
    cfg = _obs_config()
    d = cfg.trace_dir
    with _lock:
        if d != _tracer_dir:
            if _tracer is not NULL_TRACER:
                _tracer.close()
            _tracer_dir = d
            _tracer = (Tracer(d, ring_size=cfg.flight_spans)
                       if d else NULL_TRACER)
            if d and not _atexit_registered:
                atexit.register(_atexit_close)
                _atexit_registered = True
        _tracer_state = (raw, _tracer)
        return _tracer


def _atexit_close():
    try:
        _tracer.close()
    except Exception:  # noqa: BLE001 — interpreter teardown
        pass


def get_registry() -> MetricsRegistry:
    """The process-wide metrics registry."""
    return _registry


def get_runtime() -> RuntimeStats:
    """The process's runtime profile (JAX :147), its reservoirs sized
    by ``BIGDL_TORCH_OBS_RESERVOIR`` at first use."""
    global _runtime
    with _lock:
        if _runtime is None:
            _runtime = RuntimeStats(_obs_config().reservoir_size)
        return _runtime


def publish_runtime(registry: MetricsRegistry = None,
                    runtime: RuntimeStats = None) -> dict:
    """The runtime snapshot into registry gauges (step-time
    percentiles, host RSS, device memory; JAX :164); returns it."""
    registry = registry if registry is not None else _registry
    runtime = runtime if runtime is not None else get_runtime()
    snap = runtime.snapshot()
    st = snap["step_time_s"]
    g = registry.gauge(
        names.STEP_TIME_SECONDS,
        "Observed train-step completion time (dispatch -> resolved loss)",
        labels=("quantile",))
    for q in ("p50", "p95", "p99"):
        if st[q] is not None:
            g.labels(quantile=q).set(st[q])
    rss = snap.get("host_rss_bytes")
    if rss:
        registry.gauge(names.HOST_RSS_BYTES,
                       "Trainer-process resident set size").set(rss)
    dm = snap.get("device_memory")
    if dm:
        dg = registry.gauge(names.DEVICE_MEMORY_BYTES,
                            "Device 0 memory stats", labels=("stat",))
        for k, v in dm.items():
            dg.labels(stat=k).set(v)
    dma = snap.get("device_memory_all")
    if dma:
        hg = registry.gauge(names.HBM_PEAK_BYTES,
                            "Peak HBM bytes in use, per local device",
                            labels=("device",))
        for i, stats in dma.items():
            hg.labels(device=i).set(stats["peak_bytes_in_use"])
    return snap


def reset():
    """Close the tracer, start a new registry and runtime profile, stop
    the obs server, drop the request collector and the step stamp; the
    next accessor rebuilds each from the environment (the tests' hook,
    JAX ``obs.reset``)."""
    global _tracer, _tracer_dir, _tracer_state, _registry, _runtime
    with _lock:
        if _tracer is not NULL_TRACER:
            try:
                _tracer.close()
            except Exception:  # noqa: BLE001 — half-removed test dirs
                pass
        _tracer = NULL_TRACER
        _tracer_dir = None
        _tracer_state = (_UNSET, NULL_TRACER)
        _registry = MetricsRegistry()
        _runtime = None
    from bigdl_tpu_torch.obs import reqtrace, server

    server.stop_server()
    server.clear_step()
    reqtrace.reset_collector()


__all__ = ["DEFAULT_BUCKETS", "MetricsRegistry", "NullTracer", "Tracer",
           "NULL_TRACER", "RuntimeStats", "active", "get_tracer",
           "get_registry", "get_runtime", "publish_runtime", "reset",
           "Reservoir", "host_rss_bytes", "device_memory_stats",
           "all_device_memory_stats"]
