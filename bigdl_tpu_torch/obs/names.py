"""Every ``bigdl_*`` metric family the port mints, declared once.

Counterpart of ``bigdl_tpu/obs/names.py`` (``MetricSpec`` and ``_m``
:50-125, ``spec`` and ``is_declared`` :526-545): each family carries
its kind, label names, a label-cardinality ceiling, a one-line doc and
a fleet aggregation policy, with the JAX package's names and values
(the serving section :352-390, the router's :392-431, the rollout's
:433-470, the request tracer's :472-495, the optim phase timers :133, the
trainers' retry, background-writer and guard counters :145-160, the
checkpoint section :316-326, the stream's :328-349, the tuner's
:166-177, and the fleet families :194-315 and :496-524 of the goodput
ledger, the alerts, the supervisor and autoscaler, the fleet scrape,
the rollup, the retention store, the profiler and the debug bundles),
with :func:`fleet_policy` (:545), so that one
dashboard reads either package.  Mint sites use
these constants, never string literals.  Under
``BIGDL_TORCH_OBS_STRICT=1`` the registry rejects a ``bigdl_*`` family
that is not declared here, or whose kind or labels differ, and caps
each family at its ceiling (``obs/metrics.py``).  A few JAX families
the port never mints (jit compiles, HLO FLOPs, the JAX engine's serving
gauges) are declared too, so that the alert pack and the run report
read a JAX run's snapshots by the same constants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """Declared shape of one metric family."""

    name: str
    kind: str                    # "counter" | "gauge" | "histogram"
    labels: Tuple[str, ...]      # declared label names, order-free
    cardinality: int             # max label-value combinations
    doc: str                     # one-line purpose
    policy: str = "sum"          # fleet aggregation policy


#: name -> :class:`MetricSpec` of every declared family
REGISTRY: Dict[str, MetricSpec] = {}

_KINDS = ("counter", "gauge", "histogram")

#: legal fleet aggregation policies
POLICIES = ("sum", "max", "min", "last")


def _m(name: str, kind: str, labels: Tuple[str, ...] = (),
       cardinality: int = 1, doc: str = "",
       policy: Optional[str] = None) -> str:
    if kind not in _KINDS:
        raise ValueError(f"{name}: bad kind {kind!r}")
    if name in REGISTRY:
        raise ValueError(f"duplicate metric declaration {name!r}")
    if labels and cardinality <= 1:
        raise ValueError(f"{name}: labeled metric needs a ceiling > 1")
    if policy is None:
        if kind == "gauge":
            raise ValueError(f"{name}: gauge needs an explicit fleet "
                             f"aggregation policy (one of {POLICIES})")
        policy = "sum"
    if policy not in POLICIES:
        raise ValueError(f"{name}: bad policy {policy!r} "
                         f"(one of {POLICIES})")
    if kind in ("counter", "histogram") and policy != "sum":
        raise ValueError(f"{name}: {kind} families merge by 'sum' "
                         f"only, got policy {policy!r}")
    REGISTRY[name] = MetricSpec(name, kind, tuple(labels),
                                int(cardinality), doc, policy)
    return name


# --------------------------------------------------------------- optim
# the trainers' phase timers (optim/metrics.py), minted in each
# trainer's own registry
PHASE_SECONDS = _m(
    "bigdl_phase_seconds", "histogram", ("phase",), 24,
    "Driver phase timers (the reference's optim.Metrics)")

# --------------------------------------------------------------- training
# the trainers' retry, guard and background-writer accounting
RETRY_ATTEMPTS_TOTAL = _m(
    "bigdl_retry_attempts_total", "counter",
    ("classification", "error"), 64,
    "Classified-retry attempts, by failure class and error type")
CHECKPOINT_WRITE_FAILURES_TOTAL = _m(
    "bigdl_checkpoint_write_failures_total", "counter",
    doc="Checkpoint writes that raised (sync or background writer)")
NONFINITE_SKIPS_TOTAL = _m(
    "bigdl_nonfinite_skips_total", "counter",
    doc="Weight updates skipped by the non-finite step guard")

PREEMPTIONS_TOTAL = _m(
    "bigdl_preemptions_total", "counter",
    doc="SIGTERM/SIGINT preemptions handled by the elastic exit path")
SLOW_STEPS_TOTAL = _m(
    "bigdl_slow_steps_total", "counter",
    doc="Steps slower than median * BIGDL_SLOW_STEP_FACTOR")
OVERLAP_BUCKETS = _m(
    "bigdl_overlap_buckets", "gauge", policy="last",
    doc="Gradient-exchange buckets in the overlap plan")
OVERLAP_EXPOSED_COMM_FRACTION = _m(
    "bigdl_overlap_exposed_comm_fraction", "gauge", policy="max",
    doc="Exposed (non-overlapped) comm seconds / step seconds")
OVERLAP_EXPOSED_COMM_SECONDS = _m(
    "bigdl_overlap_exposed_comm_seconds", "gauge", policy="max",
    doc="Exposed comm seconds per step after overlap")

# --------------------------------------------------------------- runtime
# obs/runtime.py's profile, published by obs.publish_runtime
STEP_TIME_SECONDS = _m(
    "bigdl_step_time_seconds", "gauge", ("quantile",), 4,
    "Observed train-step completion time percentiles", policy="max")
HOST_RSS_BYTES = _m(
    "bigdl_host_rss_bytes", "gauge", policy="max",
    doc="Trainer-process resident set size")
DEVICE_MEMORY_BYTES = _m(
    "bigdl_device_memory_bytes", "gauge", ("stat",), 16,
    "Device 0 memory stats, per allocator stat", policy="max")
HBM_PEAK_BYTES = _m(
    "bigdl_hbm_peak_bytes", "gauge", ("device",), 64,
    "Peak HBM bytes in use, per local device", policy="max")

# --------------------------------------------------------------- wire
COLLECTIVE_BYTES_TOTAL = _m(
    "bigdl_collective_bytes_total", "counter", ("op", "dtype"), 64,
    "Wire bytes programmed into collectives, from static shapes")
COLLECTIVE_BYTES_PER_STEP = _m(
    "bigdl_collective_bytes_per_step", "gauge", ("op", "dtype"), 64,
    "Static per-train-step wire bytes of the collective footprint",
    policy="last")
COLLECTIVE_WIRE_SAVINGS_RATIO = _m(
    "bigdl_collective_wire_savings_ratio", "gauge", ("path",), 8,
    "Uncompressed exchange bytes over what the wire actually ships",
    policy="min")

# --------------------------------------------------------------- kernels
# the kernel auto-tuner (ops/autotune.py)
TUNER_CACHE_HITS_TOTAL = _m(
    "bigdl_tuner_cache_hits_total", "counter",
    doc="Tuner decisions served from the cache")
TUNER_CACHE_MISSES_TOTAL = _m(
    "bigdl_tuner_cache_misses_total", "counter",
    doc="Tuner cache misses (fresh searches)")
TUNER_MEASUREMENTS_TOTAL = _m(
    "bigdl_tuner_measurements_total", "counter",
    doc="Wall-clock candidate probes run by the auto-tuner")
TUNER_DECISIONS_TOTAL = _m(
    "bigdl_tuner_decisions_total", "counter", ("site", "impl"), 64,
    "Auto-tuner dispatch decisions, by call site and chosen impl")

# --------------------------------------------------------------- health
GRAD_NORM = _m(
    "bigdl_grad_norm", "gauge", ("layer",), 4096,
    "Per-layer gradient norm (BIGDL_HEALTH_EVERY)", policy="max")
PARAM_NORM = _m(
    "bigdl_param_norm", "gauge", ("layer",), 4096,
    "Per-layer parameter norm", policy="max")
UPDATE_RATIO = _m(
    "bigdl_update_ratio", "gauge", ("layer",), 4096,
    "Per-layer update-to-param norm ratio", policy="max")
GLOBAL_GRAD_NORM = _m(
    "bigdl_global_grad_norm", "histogram",
    doc="Global gradient norm distribution")
NONFINITE_LAYERS_TOTAL = _m(
    "bigdl_nonfinite_layers_total", "counter", ("layer",), 4096,
    "Layers whose grads went NaN/inf, by layer")
NUMERICS_ANOMALIES_TOTAL = _m(
    "bigdl_numerics_anomalies_total", "counter", ("kind",), 8,
    "Loss / grad-norm spikes vs the rolling median")

# --------------------------------------------------------------- resilience
HEARTBEAT_AGE_SECONDS = _m(
    "bigdl_heartbeat_age_seconds", "gauge", ("host",), 1024,
    "Seconds since each peer's last heartbeat touch", policy="max")
PEER_LOST_TOTAL = _m(
    "bigdl_peer_lost_total", "counter",
    doc="PeerLostError raised for silent heartbeat peers")
RESUMES_TOTAL = _m(
    "bigdl_resumes_total", "counter", ("resize",), 32,
    "Checkpoint resumes, by world-size transition (e.g. 2to1)")

# --------------------------------------------------------------- checkpoint
CHECKPOINT_SNAPSHOT_SECONDS = _m(
    "bigdl_checkpoint_snapshot_seconds", "gauge", policy="max",
    doc="Blocking device-to-host snapshot span of the last checkpoint")
CHECKPOINT_WRITE_SECONDS = _m(
    "bigdl_checkpoint_write_seconds", "gauge", policy="max",
    doc="Serialize+fsync span of the last checkpoint write")
CHECKPOINT_WRITES_TOTAL = _m(
    "bigdl_checkpoint_writes_total", "counter",
    doc="Completed checkpoint writes")
CHECKPOINT_VERIFY_FAILURES_TOTAL = _m(
    "bigdl_checkpoint_verify_failures_total", "counter",
    doc="Checkpoint read-back verifications that failed")

# --------------------------------------------------------------- streaming
# the buffered records of a fleet add up
STREAM_BUFFER_DEPTH = _m(  # graftlint: disable=RD007
    "bigdl_stream_buffer_depth", "gauge", policy="sum",
    doc="Records buffered between the stream producer and the trainer")
STREAM_BACKPRESSURE_WAITS_TOTAL = _m(
    "bigdl_stream_backpressure_waits_total", "counter",
    doc="Producer blocks on a full stream buffer")
STREAM_OFFSET = _m(
    "bigdl_stream_offset", "gauge", policy="min",
    doc="Last source offset handed to the trainer")
STREAM_WATERMARK = _m(
    "bigdl_stream_watermark", "gauge", policy="max",
    doc="Highest source offset the producer has ingested")
STREAM_LAG_RECORDS = _m(
    "bigdl_stream_lag_records", "gauge", policy="max",
    doc="Producer watermark minus trainer offset")
STREAM_RECORDS_TOTAL = _m(
    "bigdl_stream_records_total", "counter",
    doc="Records handed to the trainer, exactly-once audited")

# --------------------------------------------------------------- serving
SERVE_REQUESTS_TOTAL = _m(
    "bigdl_serve_requests_total", "counter", ("engine", "status"), 16,
    "Completed serve requests, by engine and outcome")
REQUEST_LATENCY_SECONDS = _m(
    "bigdl_request_latency_seconds", "histogram", ("engine", "kind"), 16,
    "Request latency by engine and kind (ttft/per_token/e2e)")
SERVE_TOKENS_TOTAL = _m(
    "bigdl_serve_tokens_total", "counter",
    doc="Tokens decoded by the LM engine")
SERVE_BATCH_OCCUPANCY = _m(
    "bigdl_serve_batch_occupancy", "gauge", policy="max",
    doc="Fraction of decode slots / micro-batch rows in use")
# fleet queue pressure is additive across replicas
SERVE_QUEUE_DEPTH = _m(  # graftlint: disable=RD007
    "bigdl_serve_queue_depth", "gauge", policy="sum",
    doc="Requests waiting in the bounded admission queue")
SERVE_PREEMPTIONS_TOTAL = _m(
    "bigdl_serve_preemptions_total", "counter",
    doc="In-flight sequences evicted to free KV pages")
SERVE_REJECTS_TOTAL = _m(
    "bigdl_serve_rejects_total", "counter",
    doc="Admissions rejected 503 + Retry-After (queue full past the "
        "admission timeout, or the engine is draining)")

# --------------------------------------------------------------- router
ROUTER_REQUESTS_TOTAL = _m(
    "bigdl_router_requests_total", "counter", ("outcome",), 8,
    "Routed requests by final outcome (ok / shed / failed)")
ROUTER_RETRIES_TOTAL = _m(
    "bigdl_router_retries_total", "counter",
    doc="Re-placements after a transient replica failure (each one "
        "spent a retry-budget token)")
ROUTER_SHED_TOTAL = _m(
    "bigdl_router_shed_total", "counter",
    doc="Requests shed 503 + Retry-After on an exhausted retry budget "
        "or no eligible replica")
ROUTER_HANDOFFS_TOTAL = _m(
    "bigdl_router_handoffs_total", "counter",
    doc="Checkpointed decodes replayed exactly-once off a draining "
        "replica")
ROUTER_DRAINS_TOTAL = _m(
    "bigdl_router_drains_total", "counter",
    doc="Replica drain cycles the router completed")
ROUTER_AFFINITY_HITS_TOTAL = _m(
    "bigdl_router_affinity_hits_total", "counter",
    doc="Placements that landed on the session's bound replica (the "
        "multi-turn KV prefix stayed resident)")
# replica counts sum across routers in a multi-router fleet
ROUTER_REPLICAS = _m(  # graftlint: disable=RD007
    "bigdl_router_replicas", "gauge", ("state",), 4,
    "Replicas by router-observed state (up / draining / down)",
    policy="sum")
ROUTER_RETRY_BUDGET_TOKENS = _m(
    "bigdl_router_retry_budget_tokens", "gauge", policy="min",
    doc="Tokens left in the router's shared retry-budget bucket")
ROUTER_STALE_EXCLUDED_TOTAL = _m(
    "bigdl_router_stale_excluded_total", "counter",
    doc="Placement snapshots that marked a replica ineligible because "
        "its host clock skew (staleness_s signal) exceeded the "
        "staleness threshold")

# --------------------------------------------------------------- rollout
SERVE_WEIGHT_SWAPS_TOTAL = _m(
    "bigdl_serve_weight_swaps_total", "counter", ("version",), 64,
    "Live weight hot-swaps the engine completed, by promoted version "
    "(slots, page tables and in-flight decodes survive)")
ROLLOUT_REJECTED_TOTAL = _m(
    "bigdl_rollout_rejected_total", "counter", ("reason",), 8,
    "Published checkpoints the rollout watcher refused before touching "
    "serving state (manifest verify failed: torn / corrupt / checksum "
    "mismatch / missing pair), counted and never loaded")
ROLLOUT_CANARY_DIVERGENCE = _m(
    "bigdl_rollout_canary_divergence", "gauge", policy="max",
    doc="Worst token-level divergence of the canary version's pinned-"
        "prompt replay vs the incumbent (fraction of mismatched "
        "tokens; the auto-rollback signal next to SLO burn)")
ROLLOUT_CANARY_STATE = _m(
    "bigdl_rollout_canary_state", "gauge", policy="max",
    doc="CanaryController phase (0 = idle, 1 = canarying, 2 = rolling "
        "back)")
ROLLOUT_ROLLBACKS_TOTAL = _m(
    "bigdl_rollout_rollbacks_total", "counter", ("reason",), 8,
    "Canary auto-rollback episodes, by the signal that fired "
    "(slo_burn / divergence)")
ROLLOUT_VERSION_MISMATCH_TOTAL = _m(
    "bigdl_rollout_version_mismatch_total", "counter",
    doc="Drain-handoff replays refused because the absorbing replica "
        "serves a different weight version than the checkpoint pinned")

# --------------------------------------------------------------- reqtrace
REQTRACE_SAMPLED_TOTAL = _m(
    "bigdl_reqtrace_sampled_total", "counter", ("reason",), 8,
    "Request traces kept by the tail sampler, by keep reason "
    "(error/retry/preempt/slo/handoff/forced always keep; 'sampled' "
    "is the probabilistic tail)")
REQTRACE_DROPPED_TOTAL = _m(
    "bigdl_reqtrace_dropped_total", "counter",
    doc="Completed request traces dropped by the tail sampler")
REQTRACE_RING_EVICTED_TOTAL = _m(
    "bigdl_reqtrace_ring_evicted_total", "counter",
    doc="Kept request traces evicted from the bounded completed-trace "
        "ring")
REQTRACE_ACTIVE_TRACES = _m(
    "bigdl_reqtrace_active_traces", "gauge", policy="max",
    doc="Request traces currently open (begun, not yet through the "
        "tail sampler)")


# --------------------------------------------------------------- goodput
# (JAX :194-215) the ledger (obs/goodput.py) and the trace merge's
# straggler detector (obs/aggregate.py)
GOODPUT_RATIO = _m(
    "bigdl_goodput_ratio", "gauge", policy="min",
    doc="Productive step seconds over total accounted wall seconds")
GOODPUT_WINDOW_RATIO = _m(
    "bigdl_goodput_window_ratio", "gauge", policy="min",
    doc="Good share of the last classifier window's wall clock")
BADPUT_SECONDS_TOTAL = _m(
    "bigdl_badput_seconds_total", "counter", ("cause",), 16,
    "Non-productive wall seconds, by cause (goodput ledger)")
BOTTLENECK = _m(
    "bigdl_bottleneck", "gauge", ("class",), 8,
    "One-hot per-window bottleneck classification", policy="max")
REWORK_STEPS_TOTAL = _m(
    "bigdl_rework_steps_total", "counter",
    doc="Steps re-executed after a restart")
STRAGGLER_STEPS_TOTAL = _m(
    "bigdl_straggler_steps_total", "counter", ("host",), 1024,
    "Cross-host straggler detections, by slow host")

# --------------------------------------------------------------- alerts
# (JAX :234-246) obs/alerts.py
ALERTS_TOTAL = _m(
    "bigdl_alerts_total", "counter", ("rule", "severity"), 64,
    "Alert firing transitions, by rule and severity")
ALERTS_RESOLVED_TOTAL = _m(
    "bigdl_alerts_resolved_total", "counter", ("rule",), 64,
    "Alert resolved transitions, by rule")
ALERT_ACTIVE = _m(
    "bigdl_alert_active", "gauge", ("rule",), 64,
    "1 while the rule is firing, 0 otherwise", policy="max")
ALERT_SINK_FAILURES_TOTAL = _m(
    "bigdl_alert_sink_failures_total", "counter",
    doc="Alert sink deliveries that failed after retry")

# ---------------------------------------------------- supervisor, autoscale
# (JAX :258-264) resilience/supervisor.py and resilience/autoscale.py
SUPERVISOR_RESTARTS_TOTAL = _m(
    "bigdl_supervisor_restarts_total", "counter", ("kind",), 8,
    "Supervisor child restarts, by failure kind")
AUTOSCALE_DECISIONS_TOTAL = _m(
    "bigdl_autoscale_decisions_total", "counter",
    ("direction", "reason"), 32,
    "Autoscale policy decisions, by direction and firing rule")
ENGINE_INITS_TOTAL = _m(
    "bigdl_engine_inits_total", "counter",
    doc="Engine.init calls in this process")

# --------------------------------------------------------------- fleet
# (JAX :266-288) obs/aggregate.FleetAggregator
FLEET_SCRAPE_SECONDS = _m(
    "bigdl_fleet_scrape_seconds", "gauge", policy="max",
    doc="Wall seconds of the last full fleet peer-scrape cycle "
        "(bounded-pool concurrent scrape, FleetAggregator.scrape_peers)")
FLEET_SCRAPE_LATENCY_SECONDS = _m(
    "bigdl_fleet_scrape_latency_seconds", "gauge", ("host",), 1024,
    "Per-host wall seconds of the last scrape round trip "
    "(/healthz + /metrics, including the retry when one was spent)",
    policy="max")
FLEET_HOST_STALENESS_SECONDS = _m(
    "bigdl_fleet_host_staleness_seconds", "gauge", ("host",), 1024,
    "Per-host |scraper clock - host /healthz clock| skew; hosts past "
    "BIGDL_TORCH_STALE_AFTER_S are excluded from fleet merges",
    policy="max")
# additive level across the fleet tiers: an explicit sum gauge
FLEET_STALE_HOSTS = _m(  # graftlint: disable=RD007
    "bigdl_fleet_stale_hosts", "gauge", policy="sum",
    doc="Hosts excluded from the last fleet merge as stale "
        "(skewed clock or a failed scrape)")
FLEET_SCRAPE_ERRORS_TOTAL = _m(
    "bigdl_fleet_scrape_errors_total", "counter", ("reason",), 8,
    "Failed per-host scrapes by reason (timeout/refused/protocol), "
    "surfaced without failing the round")

# --------------------------------------------------------------- rollup
# (JAX :290-303) obs/rollup.py; tracked series sum across tiers
ROLLUP_SERIES_TRACKED = _m(  # graftlint: disable=RD007
    "bigdl_rollup_series_tracked", "gauge", policy="sum",
    doc="Distinct (family, label-set) series the rollup tier is "
        "currently carrying in its merged exposition")
ROLLUP_SERIES_DROPPED_TOTAL = _m(
    "bigdl_rollup_series_dropped_total", "counter", ("family",), 128,
    "Series folded into the 'other' bucket by the top-K cardinality "
    "bound, by family")
ROLLUP_MEMORY_BYTES = _m(
    "bigdl_rollup_memory_bytes", "gauge", policy="max",
    doc="Approximate bytes the rollup tier holds for its merged "
        "series state")

# --------------------------------------------------------------- retain
# (JAX :305-315) obs/retain.py
RETAIN_POINTS_TOTAL = _m(
    "bigdl_retain_points_total", "counter",
    doc="Samples ingested by the downsampling retention store")
RETAIN_EVICTIONS_TOTAL = _m(
    "bigdl_retain_evictions_total", "counter", ("ring",), 4,
    "Points evicted from a retention ring (raw/10s/1m) at capacity")
RETAIN_SERIES = _m(
    "bigdl_retain_series", "gauge", policy="max",
    doc="Distinct series the retention store currently tracks "
        "(bounded by BIGDL_TORCH_RETAIN_SERIES)")

# ---------------------------------------------- profiling / debug bundles
# (JAX :500-524) obs/prof.py and obs/bundle.py
PROF_SAMPLES_TOTAL = _m(
    "bigdl_prof_samples_total", "counter", policy="sum",
    doc="Stack samples the continuous profiler folded into the "
        "collapsed-stack table (BIGDL_TORCH_PROF_HZ)")
PROF_SKIPPED_TOTAL = _m(
    "bigdl_prof_skipped_total", "counter", policy="sum",
    doc="Profiler samples skipped because the self-overhead ratio "
        "exceeded BIGDL_TORCH_PROF_BUDGET (the hard overhead cap)")
PROF_OVERHEAD_RATIO = _m(
    "bigdl_prof_overhead_ratio", "gauge", policy="max",
    doc="Profiler self-overhead: cumulative sampling-work seconds / "
        "wall seconds since the profiler started")
PROF_STACKS = _m(
    "bigdl_prof_stacks", "gauge", policy="max",
    doc="Distinct collapsed stacks held in the profiler's bounded "
        "fold table (overflow folds into the 'other' stack)")
BUNDLE_WRITES_TOTAL = _m(
    "bigdl_bundle_writes_total", "counter", ("trigger",), 6,
    "Debug bundles written, by trigger (alert / supervisor / http / "
    "manual)", policy="sum")
BUNDLE_ERRORS_TOTAL = _m(
    "bigdl_bundle_errors_total", "counter", policy="sum",
    doc="Debug-bundle builds that failed (the trigger path never "
        "propagates: a bundle failure must not kill training)")
BUNDLE_LAST_WRITE_SECONDS = _m(
    "bigdl_bundle_last_write_seconds", "gauge", policy="max",
    doc="Wall-clock timestamp of the newest debug bundle this host "
        "wrote (0 until the first bundle)")

# ------------------------------------------- read from JAX shards only
# families the port never mints (no jit, no HLO cost analysis, no kernel
# fallback, serving gauges of the JAX engine) that the alert pack and
# the run report read when they look at a JAX run's snapshots
JIT_COMPILE_COUNT = _m(
    "bigdl_jit_compile_count", "gauge", policy="max",
    doc="Distinct jit compile events (the JAX package)")
JIT_COMPILE_SECONDS_TOTAL = _m(
    "bigdl_jit_compile_seconds_total", "gauge", policy="max",
    doc="Wall seconds blocked on jit trace+compile (the JAX package)")
STEP_FLOPS = _m(
    "bigdl_step_flops", "gauge", policy="last",
    doc="HLO cost-analysis FLOPs of one compiled train step (the JAX "
        "package)")
MFU = _m(
    "bigdl_mfu", "gauge", policy="min",
    doc="Model FLOPs utilization (the JAX package)")
KERNEL_FALLBACKS_TOTAL = _m(
    "bigdl_kernel_fallbacks_total", "counter", ("site",), 16,
    "Kernel dispatches that fell back to the reference path (the JAX "
    "package)")
# fleet decode throughput is additive across engines
SERVE_TOKENS_PER_SECOND = _m(  # graftlint: disable=RD007
    "bigdl_serve_tokens_per_second", "gauge", policy="sum",
    doc="Rolling decode throughput (the JAX engine)")
SERVE_KV_PAGES_IN_USE = _m(
    "bigdl_serve_kv_pages_in_use", "gauge", policy="max",
    doc="Pages allocated from the paged KV cache pool (the JAX engine)")
SERVE_ADMISSION_WAITS_TOTAL = _m(
    "bigdl_serve_admission_waits_total", "counter",
    doc="Client submits that blocked on a full request queue (the JAX "
        "engine)")
SERVE_LATENCY_SLO_RATIO = _m(
    "bigdl_serve_latency_slo_ratio", "gauge", policy="min",
    doc="Share of recent requests inside the e2e latency SLO (the JAX "
        "engine)")
SERVE_DECODE_ATTN_MS = _m(
    "bigdl_serve_decode_attn_ms", "gauge", policy="max",
    doc="Mean decode-attention kernel milliseconds per step (the JAX "
        "engine)")
SERVE_DECODE_HBM_BYTES_PER_TOKEN = _m(
    "bigdl_serve_decode_hbm_bytes_per_token", "gauge", policy="max",
    doc="Modeled HBM traffic per decoded token (the JAX engine)")

# ------------------------------------------------------------------ MoE
# the port's own: a SigmoidMoE's held experts (parallel/moe.py
# MoEStats), summed on the device while a profiler or the tracer records
MOE_HELD_ASSIGNMENTS_TOTAL = _m(
    "bigdl_moe_held_assignments_total", "counter", ("layer",), 256,
    "Routed assignments to the experts this rank holds, by MoE layer")
MOE_MAX_LOAD_RATIO = _m(
    "bigdl_moe_max_load_ratio", "gauge", ("layer",), 256,
    "The largest held expert's load over the held experts' mean, by MoE "
    "layer", policy="max")

#: families the port declares and the JAX package does not
PORT_ONLY = frozenset({MOE_HELD_ASSIGNMENTS_TOTAL, MOE_MAX_LOAD_RATIO})

#: legal gauge policies (JAX :73)
GAUGE_POLICIES = ("max", "min", "last")

#: ``bigdl_``-prefixed spellings that are not metric families (JAX :526)
KNOWN_STRINGS = frozenset({
    "bigdl_tpu_torch",        # tracer process name / root logger name
    "bigdl_torch_obs_span",   # the tracer's context variable
    "bigdl_flight_recorder",  # postmortem bundle kind
    "bigdl_tpu_net",          # caffe export net name
    # the C entry points of the kernels' libraries (ops/_cuda.py)
    "bigdl_flash_fwd", "bigdl_flash_bwd_dq", "bigdl_flash_bwd_dkv",
    "bigdl_paged_decode", "bigdl_conv_bn_1x1", "bigdl_conv_bn_kxk",
    "bigdl_fused_adam",
})


def spec(name: str) -> MetricSpec:
    """The declared spec of ``name`` (KeyError when undeclared)."""
    return REGISTRY[name]


def is_declared(name: str) -> bool:
    """Is ``name`` a declared family, or a histogram's ``_bucket`` /
    ``_sum`` / ``_count`` sample of one?"""
    if name in REGISTRY:
        return True
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            s = REGISTRY.get(name[: -len(suffix)])
            if s is not None and s.kind == "histogram":
                return True
    return False


def fleet_policy(name: str) -> Optional[str]:
    """The fleet aggregation policy of a sample name as it appears on
    the wire (JAX :545): a histogram's ``_bucket`` / ``_sum`` /
    ``_count`` samples merge by ``sum`` like their family; ``None`` for
    an undeclared name (the rollup passes those through with ``last``
    semantics)."""
    s = REGISTRY.get(name)
    if s is not None:
        return s.policy
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = REGISTRY.get(name[: -len(suffix)])
            if base is not None and base.kind == "histogram":
                return "sum"
    return None


# the families the engines, the classifier and ServingServer mint in the
# process registry (a test holds each to its JAX declaration); the
# router's, the rollout's and the request tracer's are in REGISTRY too
__all__ = ["SERVE_REQUESTS_TOTAL", "REQUEST_LATENCY_SECONDS",
           "SERVE_TOKENS_TOTAL", "SERVE_BATCH_OCCUPANCY", "SERVE_QUEUE_DEPTH",
           "SERVE_PREEMPTIONS_TOTAL", "SERVE_REJECTS_TOTAL",
           "SERVE_WEIGHT_SWAPS_TOTAL"]
