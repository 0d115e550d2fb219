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
  memory, behind :func:`get_runtime` and :func:`publish_runtime`;
* :mod:`~bigdl_tpu_torch.obs.goodput`: the wall-clock goodput ledger
  (productive steps against the badput causes), per-attempt JSONL
  shards and the window bottleneck classifier, behind
  :func:`get_ledger`;
* :mod:`~bigdl_tpu_torch.obs.alerts`: the rule pack evaluated on the
  goodput window tick; :mod:`~bigdl_tpu_torch.obs.bundle`: the debug
  bundles; :mod:`~bigdl_tpu_torch.obs.prof`: the sampling profiler
  (``BIGDL_TORCH_PROF_HZ``);
* :mod:`~bigdl_tpu_torch.obs.aggregate` (the shard merge, the fleet
  scrape), :mod:`~bigdl_tpu_torch.obs.rollup`,
  :mod:`~bigdl_tpu_torch.obs.retain`, :mod:`~bigdl_tpu_torch.obs.report`
  and :mod:`~bigdl_tpu_torch.obs.regress`: the offline and fleet
  readers, each with a ``python -m`` entry point.

:func:`flush` writes the run's shards (the metrics snapshot, the kept
request traces, the folded profile, the Chrome trace, the goodput
ledger) under ``BIGDL_TORCH_METRICS_DIR`` (else the trace directory);
it runs at the end of ``optimize`` and at interpreter exit, so a
preempted or crashed attempt still leaves its shards.

Everything is off by default.  The tracer and the request collector are
rebuilt when their knobs change, a ``configure(obs=...)`` pin included
(JAX ``obs/__init__.py:96-115``); a call whose knobs read as the last
one's returns the cached object after one environment lookup a knob
(``config.obs_knob_key``), with no lock, since the engine asks at every
decode step.
"""

from __future__ import annotations

import atexit
import json
import os
import threading

from bigdl_tpu_torch.config import obs_knob_key
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
# (the trace directory's knob key, tracer): one tuple rebind, so the
# lock-free read in get_tracer sees a matched pair
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
    raw = obs_knob_key("BIGDL_TORCH_TRACE_DIR")
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


def _atexit_flush():
    """The last flush (JAX :129-146): a run that ends on an unhandled
    exception or a ``SystemExit`` (the preemption exit, a crashed
    attempt) still writes its metrics snapshot, trace and goodput shard.
    Registered at import, so it runs after the tracer's close hook
    (atexit is LIFO); a no-op with observability off."""
    try:
        if _obs_config().active:
            flush()
    except Exception:  # noqa: BLE001 — interpreter teardown
        pass


atexit.register(_atexit_flush)


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


def get_ledger():
    """The process goodput ledger (``obs/goodput.py``): recording when
    observability is on, the shared no-op otherwise."""
    from bigdl_tpu_torch.obs import goodput

    return goodput.get_ledger()


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


def flush(extra_registries=()) -> dict:
    """The end-of-run export (JAX :245): publish the runtime and the
    goodput ledger into the registry, write the Prometheus and JSONL
    metric snapshot, the kept request traces and the folded profile
    under ``metrics_dir`` (else ``trace_dir``), flush the Chrome trace
    and append the ledger's shard.  Returns the paths; a no-op with
    observability off."""
    cfg = _obs_config()
    if not cfg.active:
        return {}
    publish_runtime()
    ledger = get_ledger()
    ledger.publish(_registry)
    paths = {}
    out_dir = cfg.metrics_dir or cfg.trace_dir
    if out_dir:
        paths = _registry.write_snapshot(out_dir,
                                         extra_registries=extra_registries)
        from bigdl_tpu_torch.obs import prof, reqtrace
        from bigdl_tpu_torch.obs.trace import _host_id

        stem = f"h{_host_id()}.{os.getpid()}"
        kept = reqtrace.get_collector().completed()
        if kept:
            rt = os.path.join(out_dir, f"reqtraces.{stem}.json")
            tmp = rt + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(kept, fh, default=str)
            os.replace(tmp, rt)
            paths["reqtraces"] = rt
        pp = prof.write_profile(out_dir, f"prof.{stem}")
        if pp:
            paths["profile"] = pp
    tracer = get_tracer()
    tracer.flush()
    if tracer is not NULL_TRACER:
        paths["trace"] = tracer.trace_path
        paths["events"] = tracer.jsonl_path
    gp = ledger.flush()
    if gp:
        paths["goodput"] = gp
    return paths


def reset():
    """Close the tracer, start a new registry and runtime profile, stop
    the obs server, drop the request collector, the step stamp, the
    goodput ledger, the alert engine, the profiler and the bundles'
    dedupe state; the next accessor rebuilds each from the environment
    (the tests' hook, JAX ``obs.reset``)."""
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
    from bigdl_tpu_torch.obs import (alerts, bundle, goodput, prof,
                                     reqtrace, server)

    goodput.reset_ledger()
    server.stop_server()
    server.clear_step()
    alerts.reset_engine()
    reqtrace.reset_collector()
    prof.reset_profiler()
    bundle.reset()


__all__ = ["DEFAULT_BUCKETS", "MetricsRegistry", "NullTracer", "Tracer",
           "NULL_TRACER", "RuntimeStats", "active", "get_tracer",
           "get_registry", "get_runtime", "get_ledger", "publish_runtime",
           "flush", "reset",
           "Reservoir", "host_rss_bytes", "device_memory_stats",
           "all_device_memory_stats"]
