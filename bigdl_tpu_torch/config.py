"""Knobs of the PyTorch/CUDA port, read from ``BIGDL_TORCH_*``.

Counterpart of the ``ServeConfig`` section of ``bigdl_tpu/config.py``
(the serving defaults ``LMEngine``, ``ClassifierEngine`` and
``ServingServer`` read, with the router's 503 ``Retry-After``), of its
training knobs (``TrainConfig``: the non-finite guard, the retry
backoff, checkpoint retention and background writes, the gradient
wire and its buckets, the fault plan, the stream's buffer, preemption,
heartbeats and the hang timeout, read by the trainers), of the
observability switches the tracer, the request tracer, the metrics
registry, the obs server, the runtime profile, the health monitor and
the regression gate read (``ObsConfig``), of the router's and the
rollout's knobs (``RouterConfig``, ``RolloutConfig``) and of the kernel
auto-tuner's (``TunerConfig``), of the supervisor's autoscaling
loop (``AutoscaleConfig``), of the process-level switches JAX keeps at
the top of its config (``HostConfig``: the singleton check, the native
host library, the logger filter, the step profiler) and of the fleet
simulator (``FleetSimConfig``), each with the JAX package's defaults.
Constructor arguments win; these are the process-wide fallbacks a
deployment sets once.  Each is read from the environment
when it is used, so a knob exported after import counts, unless
``configure(section=...)`` pinned that section (``BigDLConfig``, the
global ``config``, ``refresh_from_env`` and ``reload_from_env``, with
JAX's semantics).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_str(name: str, default: Optional[str]) -> Optional[str]:
    v = os.environ.get(name)
    return default if v is None or v == "" else v


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None or v == "" else int(v)


def _env_opt_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return default if v is None or v == "" else int(v)


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v is None or v == "" else float(v)


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class ServeConfig:
    """Inference serving defaults (``bigdl_tpu_torch/serving``)."""

    # decode slots [BIGDL_TORCH_SERVE_MAX_BATCH]
    max_batch: int = 8
    # tokens per KV-cache page [BIGDL_TORCH_SERVE_PAGE]
    page_size: int = 16
    # KV page pool size; 0 = full residency (every slot can hold a
    # max_len sequence) [BIGDL_TORCH_SERVE_PAGES]
    num_pages: int = 0
    # bounded request-queue capacity; submits past it block the client
    # [BIGDL_TORCH_SERVE_QUEUE]
    queue_capacity: int = 64
    # e2e latency SLO in seconds, counted in stats() when > 0
    # [BIGDL_TORCH_SERVE_SLO_MS, milliseconds]
    slo_s: float = 0.0
    # "continuous" admits at step boundaries; "static" drains the whole
    # batch first [BIGDL_TORCH_SERVE_ADMISSION]
    admission: str = "continuous"
    # paged decode attention: "auto" (= dense), "dense", or "kernel"
    # (the paged flash-decode kernel) [BIGDL_TORCH_SERVE_DECODE_ATTN]
    decode_attn: str = "auto"
    # slice each step's page tables to the pow2 used-page prefix
    # [BIGDL_TORCH_SERVE_DECODE_BUCKET]
    decode_bucket: bool = True
    # int8 weights for the decode matmuls (LMEngine) and the
    # quantize() module swap (ClassifierEngine) [BIGDL_TORCH_SERVE_INT8]
    int8: bool = False
    # ServingServer's HTTP port (0 = ephemeral); unset = the
    # constructor's [BIGDL_TORCH_SERVE_PORT]
    port: Optional[int] = None
    # Retry-After seconds on a 503 (queue full, or the engine draining)
    # [BIGDL_TORCH_SERVE_RETRY_AFTER]
    retry_after_s: float = 1.0

    @classmethod
    def from_env(cls) -> "ServeConfig":
        return cls(
            max_batch=_env_int("BIGDL_TORCH_SERVE_MAX_BATCH", 8),
            page_size=_env_int("BIGDL_TORCH_SERVE_PAGE", 16),
            num_pages=_env_int("BIGDL_TORCH_SERVE_PAGES", 0),
            queue_capacity=_env_int("BIGDL_TORCH_SERVE_QUEUE", 64),
            slo_s=_env_float("BIGDL_TORCH_SERVE_SLO_MS", 0.0) / 1000.0,
            admission=_env_str("BIGDL_TORCH_SERVE_ADMISSION", "continuous"),
            decode_attn=_env_str("BIGDL_TORCH_SERVE_DECODE_ATTN", "auto"),
            decode_bucket=_env_bool("BIGDL_TORCH_SERVE_DECODE_BUCKET", True),
            int8=_env_bool("BIGDL_TORCH_SERVE_INT8", False),
            port=_env_opt_int("BIGDL_TORCH_SERVE_PORT", None),
            retry_after_s=_env_float("BIGDL_TORCH_SERVE_RETRY_AFTER", 1.0),
        )


@dataclasses.dataclass
class TrainConfig:
    """Training-loop defaults (``bigdl_tpu_torch/optim``), the JAX
    package's ``nonfinite_guard``/``max_nonfinite_skips``, retry,
    retention, ``checkpoint_async``, wire, ``fault_plan`` and stream
    knobs."""

    # skip (keep params, optimizer and BN state) a step whose loss or a
    # gradient is NaN or inf [BIGDL_TORCH_NONFINITE_GUARD]
    nonfinite_guard: bool = True
    # consecutive skipped steps before NonFiniteStepError
    # [BIGDL_TORCH_MAX_NONFINITE_SKIPS]
    max_nonfinite_skips: int = 10
    # DistriOptimizer's retry backoff: base * 2^(attempt-1), capped
    # [BIGDL_TORCH_RETRY_BACKOFF_BASE / BIGDL_TORCH_RETRY_BACKOFF_MAX]
    retry_backoff_base: float = 0.5
    retry_backoff_max: float = 30.0
    # more than `budget` transient failures inside `window` seconds
    # stops retrying [BIGDL_TORCH_RETRY_WINDOW_SECONDS /
    # BIGDL_TORCH_RETRY_WINDOW_BUDGET]
    retry_window_seconds: float = 600.0
    retry_window_budget: int = 16
    # keep the newest K checkpoint pairs, 0 = all
    # [BIGDL_TORCH_CHECKPOINT_KEEP_LAST]
    checkpoint_keep_last: int = 0
    # DistriOptimizer's gradient wire: "bfloat16" (cast before the
    # reduce-scatter), "int8" / "fp8_e4m3" / "fp8_e5m2" (the blockwise-
    # scaled staged ring, parallel/wire.py), "float32" or "none"
    # [BIGDL_TORCH_WIRE_DTYPE]
    wire_dtype: str = "bfloat16"
    # elements per quantization scale of the scaled wires
    # [BIGDL_TORCH_WIRE_BLOCK]
    wire_block: int = 512
    # error feedback: each rank's quantization residual carried across
    # steps [BIGDL_TORCH_WIRE_EF]
    wire_ef: bool = False
    # the bucketed gradient exchange: about this many MiB of gradient a
    # bucket, exchanged last bucket first; <= 0 = one monolithic
    # exchange [BIGDL_TORCH_OVERLAP_BUCKET_MB]
    overlap_bucket_mb: float = 0.0
    # Engine.init installs the SIGTERM/SIGINT handler: finish the step,
    # write an emergency checkpoint, exit 170
    # [BIGDL_TORCH_PREEMPTION_HANDLER]
    preemption_handler: bool = True
    # heartbeat peer liveness at world > 1: a shared directory each rank
    # touches a file in; unset = off [BIGDL_TORCH_HEARTBEAT_DIR]
    heartbeat_dir: Optional[str] = None
    # touch the heartbeat file every K steps [BIGDL_TORCH_HEARTBEAT_EVERY]
    heartbeat_every: int = 1
    # a peer silent this many seconds raises PeerLostError
    # [BIGDL_TORCH_HEARTBEAT_TIMEOUT]
    heartbeat_timeout: float = 60.0
    # /healthz reads "stalled" when the last step stamp is older than
    # this many seconds; <= 0 disables [BIGDL_TORCH_HANG_TIMEOUT]
    hang_timeout: float = 0.0
    # set_checkpoint's default for background=: snapshot to host on the
    # loop, serialize + fsync + manifest on one writer thread
    # [BIGDL_TORCH_CHECKPOINT_ASYNC]
    checkpoint_async: bool = False
    # deterministic fault injection (resilience/faults.py), e.g.
    # "step:3:raise,step:7:nan_grad,ckpt:1:truncate"
    # [BIGDL_TORCH_FAULT_PLAN]
    fault_plan: Optional[str] = None
    # records the stream's bounded buffer holds before its producer
    # waits (dataset/stream.py) [BIGDL_TORCH_STREAM_BUFFER]
    stream_buffer: int = 1024
    # records in one epoch of a stream; 0 = one epoch until the source
    # ends [BIGDL_TORCH_STREAM_EPOCH_RECORDS]
    stream_epoch_records: int = 0
    # which launch of a supervised run this process is (0 = the first);
    # the restart supervisor exports it to every child, and the goodput
    # ledger and /healthz key on it [BIGDL_TORCH_ELASTIC_ATTEMPT]
    elastic_attempt: int = 0
    # preemption restarts before this launch, exported beside the
    # attempt [BIGDL_TORCH_ELASTIC_PREEMPTIONS]
    elastic_preemptions: int = 0

    @classmethod
    def from_env(cls) -> "TrainConfig":
        return cls(
            nonfinite_guard=_env_bool("BIGDL_TORCH_NONFINITE_GUARD", True),
            max_nonfinite_skips=_env_int("BIGDL_TORCH_MAX_NONFINITE_SKIPS",
                                         10),
            retry_backoff_base=_env_float("BIGDL_TORCH_RETRY_BACKOFF_BASE",
                                          0.5),
            retry_backoff_max=_env_float("BIGDL_TORCH_RETRY_BACKOFF_MAX",
                                         30.0),
            retry_window_seconds=_env_float(
                "BIGDL_TORCH_RETRY_WINDOW_SECONDS", 600.0),
            retry_window_budget=_env_int("BIGDL_TORCH_RETRY_WINDOW_BUDGET",
                                         16),
            checkpoint_keep_last=_env_int("BIGDL_TORCH_CHECKPOINT_KEEP_LAST",
                                          0),
            wire_dtype=_env_str("BIGDL_TORCH_WIRE_DTYPE", "bfloat16"),
            wire_block=_env_int("BIGDL_TORCH_WIRE_BLOCK", 512),
            wire_ef=_env_bool("BIGDL_TORCH_WIRE_EF", False),
            overlap_bucket_mb=_env_float("BIGDL_TORCH_OVERLAP_BUCKET_MB",
                                         0.0),
            preemption_handler=_env_bool("BIGDL_TORCH_PREEMPTION_HANDLER",
                                         True),
            heartbeat_dir=_env_str("BIGDL_TORCH_HEARTBEAT_DIR", None),
            heartbeat_every=_env_int("BIGDL_TORCH_HEARTBEAT_EVERY", 1),
            heartbeat_timeout=_env_float("BIGDL_TORCH_HEARTBEAT_TIMEOUT",
                                         60.0),
            hang_timeout=_env_float("BIGDL_TORCH_HANG_TIMEOUT", 0.0),
            checkpoint_async=_env_bool("BIGDL_TORCH_CHECKPOINT_ASYNC", False),
            fault_plan=_env_str("BIGDL_TORCH_FAULT_PLAN", None),
            stream_buffer=_env_int("BIGDL_TORCH_STREAM_BUFFER", 1024),
            stream_epoch_records=_env_int(
                "BIGDL_TORCH_STREAM_EPOCH_RECORDS", 0),
            elastic_attempt=_env_int("BIGDL_TORCH_ELASTIC_ATTEMPT", 0),
            elastic_preemptions=_env_int("BIGDL_TORCH_ELASTIC_PREEMPTIONS",
                                         0),
        )


@dataclasses.dataclass
class ObsConfig:
    """Observability switches (``bigdl_tpu_torch/obs``), off by default
    (JAX ``ObsConfig``, the subset the port reads)."""

    # Chrome trace JSON + JSONL events of the tracer are written here;
    # unset = the null tracer [BIGDL_TORCH_TRACE_DIR]
    trace_dir: Optional[str] = None
    # flight recorder: span/event records the tracer keeps in memory
    # for /trace?last=K [BIGDL_TORCH_FLIGHT_SPANS]
    flight_spans: int = 512
    # live telemetry endpoint (obs/server.py): 0 = ephemeral port,
    # unset = no thread and no socket [BIGDL_TORCH_OBS_PORT]
    obs_port: Optional[int] = None
    # the server writes its bound port here [BIGDL_TORCH_OBS_PORT_FILE]
    obs_port_file: Optional[str] = None
    # reject an undeclared bigdl_* family, or one whose kind or labels
    # differ from obs/names.py, and cap label cardinality
    # [BIGDL_TORCH_OBS_STRICT]
    strict: bool = False
    # request tracing (obs/reqtrace.py): keep probability of a clean
    # request's trace; 0 turns the subsystem off
    # [BIGDL_TORCH_REQTRACE_SAMPLE]
    reqtrace_sample: float = 0.0
    # kept request traces held for /trace?request=ID
    # [BIGDL_TORCH_REQTRACE_RING]
    reqtrace_ring: int = 256
    # a replica whose exported host-clock skew exceeds this is left out
    # of placement; <= 0 disables [BIGDL_TORCH_STALE_AFTER_S]
    stale_after_s: float = 30.0
    # step-time reservoir size (obs/runtime.py) [BIGDL_TORCH_OBS_RESERVOIR]
    reservoir_size: int = 4096
    # a step slower than median * this emits a slow_step event with its
    # child spans; <= 0 disables [BIGDL_TORCH_SLOW_STEP_FACTOR]
    slow_step_factor: float = 3.0
    # per-layer health stats (obs/health.py) every N steps; 0 = off, and
    # the step then computes none [BIGDL_TORCH_HEALTH_EVERY]
    health_every: int = 0
    # the anomaly detector's rolling window [BIGDL_TORCH_HEALTH_WINDOW]
    health_window: int = 64
    # a loss or gradient norm above median * this is an anomaly; <= 0
    # disables [BIGDL_TORCH_HEALTH_SPIKE_FACTOR]
    health_spike_factor: float = 10.0
    # assumed interconnect GB/s for the exposed-comm seconds gauge; 0 =
    # unknown [BIGDL_TORCH_WIRE_GBPS]
    wire_gbps: float = 0.0
    # obs/regress.check: a step time over the baseline's times this
    # (or a throughput under it by this factor) is a violation
    # [BIGDL_TORCH_REGRESS_TOLERANCE]
    regress_tolerance: float = 1.5
    # the Prometheus text and the JSONL metric snapshots, the goodput
    # ledger's shards and the folded profile are written here (falls
    # back to trace_dir) [BIGDL_TORCH_METRICS_DIR]
    metrics_dir: Optional[str] = None
    # the goodput ledger's bottleneck classifier (and the alert engine
    # riding it) runs once every N productive steps; <= 0 disables
    # [BIGDL_TORCH_GOODPUT_WINDOW]
    goodput_window: int = 32
    # a host whose step-time p50 exceeds the cross-host median by this
    # factor is a straggler (obs/aggregate.py); <= 1 disables
    # [BIGDL_TORCH_STRAGGLER_FACTOR]
    straggler_factor: float = 1.5
    # comma-separated host:port endpoints the fleet aggregator scrapes
    # [BIGDL_TORCH_OBS_PEERS]
    obs_peers: Optional[str] = None
    # alert rule pack (obs/alerts.py): inline JSON list or a JSON file;
    # unset = the default pack [BIGDL_TORCH_ALERT_RULES]
    alert_rules: Optional[str] = None
    # firing/resolved transitions append to this JSONL file, or POST to
    # it when it is an http(s):// webhook [BIGDL_TORCH_ALERT_SINK]
    alert_sink: Optional[str] = None
    # connect/read timeout of one webhook POST (one retry)
    # [BIGDL_TORCH_ALERT_SINK_TIMEOUT]
    alert_sink_timeout: float = 1.0
    # hosts report --watch lists, worst first [BIGDL_TORCH_WATCH_HOSTS]
    watch_hosts: int = 16
    # hosts a leaf rollup scrapes [BIGDL_TORCH_ROLLUP_SHARD]
    rollup_shard: int = 32
    # label sets kept a family by a rollup before the rest fold into
    # "other" [BIGDL_TORCH_ROLLUP_TOP_K]
    rollup_top_k: int = 64
    # points a retention ring holds [BIGDL_TORCH_RETAIN_POINTS]
    retain_points: int = 240
    # series the retention store tracks [BIGDL_TORCH_RETAIN_SERIES]
    retain_series: int = 512
    # the sampling profiler (obs/prof.py): samples a second; <= 0 = off,
    # no thread [BIGDL_TORCH_PROF_HZ]
    prof_hz: float = 0.0
    # the profiler's work share of wall time past which it skips
    # samples [BIGDL_TORCH_PROF_BUDGET]
    prof_budget: float = 0.01
    # debug bundles (obs/bundle.py) on alert firings, supervisor
    # restarts and GET /debugz go here; unset disables the automatic
    # triggers [BIGDL_TORCH_BUNDLE_DIR]
    bundle_dir: Optional[str] = None
    # least seconds between two alert bundles of one rule; 0 = no limit
    # [BIGDL_TORCH_BUNDLE_RATE_LIMIT]
    bundle_rate_limit: float = 300.0
    # the BENCH_r*.json directory a bench run's regression gate reads
    # [BIGDL_TORCH_REGRESS_TRAJECTORY]
    regress_trajectory: Optional[str] = None

    @property
    def active(self) -> bool:
        return bool(self.trace_dir or self.metrics_dir
                    or self.obs_port is not None)

    @classmethod
    def from_env(cls) -> "ObsConfig":
        return cls(
            trace_dir=_env_str("BIGDL_TORCH_TRACE_DIR", None),
            flight_spans=_env_int("BIGDL_TORCH_FLIGHT_SPANS", 512),
            obs_port=_env_opt_int("BIGDL_TORCH_OBS_PORT", None),
            obs_port_file=_env_str("BIGDL_TORCH_OBS_PORT_FILE", None),
            strict=_env_bool("BIGDL_TORCH_OBS_STRICT", False),
            reqtrace_sample=_env_float("BIGDL_TORCH_REQTRACE_SAMPLE", 0.0),
            reqtrace_ring=_env_int("BIGDL_TORCH_REQTRACE_RING", 256),
            stale_after_s=_env_float("BIGDL_TORCH_STALE_AFTER_S", 30.0),
            reservoir_size=_env_int("BIGDL_TORCH_OBS_RESERVOIR", 4096),
            slow_step_factor=_env_float("BIGDL_TORCH_SLOW_STEP_FACTOR", 3.0),
            health_every=_env_int("BIGDL_TORCH_HEALTH_EVERY", 0),
            health_window=_env_int("BIGDL_TORCH_HEALTH_WINDOW", 64),
            health_spike_factor=_env_float("BIGDL_TORCH_HEALTH_SPIKE_FACTOR",
                                           10.0),
            wire_gbps=_env_float("BIGDL_TORCH_WIRE_GBPS", 0.0),
            regress_tolerance=_env_float("BIGDL_TORCH_REGRESS_TOLERANCE",
                                         1.5),
            metrics_dir=_env_str("BIGDL_TORCH_METRICS_DIR", None),
            goodput_window=_env_int("BIGDL_TORCH_GOODPUT_WINDOW", 32),
            straggler_factor=_env_float("BIGDL_TORCH_STRAGGLER_FACTOR", 1.5),
            obs_peers=_env_str("BIGDL_TORCH_OBS_PEERS", None),
            alert_rules=_env_str("BIGDL_TORCH_ALERT_RULES", None),
            alert_sink=_env_str("BIGDL_TORCH_ALERT_SINK", None),
            alert_sink_timeout=_env_float("BIGDL_TORCH_ALERT_SINK_TIMEOUT",
                                          1.0),
            watch_hosts=_env_int("BIGDL_TORCH_WATCH_HOSTS", 16),
            rollup_shard=_env_int("BIGDL_TORCH_ROLLUP_SHARD", 32),
            rollup_top_k=_env_int("BIGDL_TORCH_ROLLUP_TOP_K", 64),
            retain_points=_env_int("BIGDL_TORCH_RETAIN_POINTS", 240),
            retain_series=_env_int("BIGDL_TORCH_RETAIN_SERIES", 512),
            prof_hz=_env_float("BIGDL_TORCH_PROF_HZ", 0.0),
            prof_budget=_env_float("BIGDL_TORCH_PROF_BUDGET", 0.01),
            bundle_dir=_env_str("BIGDL_TORCH_BUNDLE_DIR", None),
            bundle_rate_limit=_env_float("BIGDL_TORCH_BUNDLE_RATE_LIMIT",
                                         300.0),
            regress_trajectory=_env_str("BIGDL_TORCH_REGRESS_TRAJECTORY",
                                        None),
        )


@dataclasses.dataclass
class RouterConfig:
    """The multi-replica router (``serving/router.py``), JAX
    ``RouterConfig``."""

    # router HTTP port (0 = ephemeral); unset = the constructor's
    # [BIGDL_TORCH_ROUTER_PORT]
    port: Optional[int] = None
    # session-affinity binding TTL in seconds; <= 0 disables affinity
    # [BIGDL_TORCH_ROUTER_AFFINITY_TTL]
    affinity_ttl_s: float = 300.0
    # retry budget: tokens each routed request deposits, one spent per
    # retry [BIGDL_TORCH_ROUTER_RETRY_BUDGET]
    retry_budget_ratio: float = 0.2
    # the bucket's cap and cold-start allowance
    # [BIGDL_TORCH_ROUTER_RETRY_BURST]
    retry_budget_burst: float = 8.0
    # placement attempts past the first [BIGDL_TORCH_ROUTER_MAX_RETRIES]
    max_retries: int = 2
    # per-attempt replica timeout in seconds [BIGDL_TORCH_ROUTER_TIMEOUT]
    request_timeout_s: float = 30.0
    # a draining replica's deadline before the rest is handed off
    # [BIGDL_TORCH_ROUTER_DRAIN_DEADLINE]
    drain_deadline_s: float = 10.0
    # weight of KV-page pressure in the placement score
    # [BIGDL_TORCH_ROUTER_KV_WEIGHT]
    kv_weight: float = 4.0
    # jittered-backoff base between retries in seconds
    # [BIGDL_TORCH_ROUTER_BACKOFF_BASE]
    backoff_base_s: float = 0.05
    # Retry-After seconds on a shed 503 [BIGDL_TORCH_ROUTER_RETRY_AFTER]
    retry_after_s: float = 1.0
    # leave replicas whose clock skew exceeds BIGDL_TORCH_STALE_AFTER_S
    # out of placement [BIGDL_TORCH_ROUTER_STALE_EXCLUDE]
    stale_exclude: bool = True

    @classmethod
    def from_env(cls) -> "RouterConfig":
        return cls(
            port=_env_opt_int("BIGDL_TORCH_ROUTER_PORT", None),
            affinity_ttl_s=_env_float("BIGDL_TORCH_ROUTER_AFFINITY_TTL",
                                      300.0),
            retry_budget_ratio=_env_float("BIGDL_TORCH_ROUTER_RETRY_BUDGET",
                                          0.2),
            retry_budget_burst=_env_float("BIGDL_TORCH_ROUTER_RETRY_BURST",
                                          8.0),
            max_retries=_env_int("BIGDL_TORCH_ROUTER_MAX_RETRIES", 2),
            request_timeout_s=_env_float("BIGDL_TORCH_ROUTER_TIMEOUT", 30.0),
            drain_deadline_s=_env_float("BIGDL_TORCH_ROUTER_DRAIN_DEADLINE",
                                        10.0),
            kv_weight=_env_float("BIGDL_TORCH_ROUTER_KV_WEIGHT", 4.0),
            backoff_base_s=_env_float("BIGDL_TORCH_ROUTER_BACKOFF_BASE",
                                      0.05),
            retry_after_s=_env_float("BIGDL_TORCH_ROUTER_RETRY_AFTER", 1.0),
            stale_exclude=_env_bool("BIGDL_TORCH_ROUTER_STALE_EXCLUDE",
                                    True),
        )


@dataclasses.dataclass
class RolloutConfig:
    """Live weight rollout (``serving/rollout.py``), JAX
    ``RolloutConfig``."""

    # the directory a CheckpointWatcher polls; unset = watch_dir= only
    # [BIGDL_TORCH_ROLLOUT_WATCH]
    watch_dir: Optional[str] = None
    # watcher poll period in seconds [BIGDL_TORCH_ROLLOUT_POLL]
    poll_s: float = 1.0
    # fraction of replicas a new version canaries on (at least one)
    # [BIGDL_TORCH_ROLLOUT_CANARY_FRACTION]
    canary_fraction: float = 0.25
    # token divergence past which an evaluation counts as a breach
    # [BIGDL_TORCH_ROLLOUT_DIVERGENCE]
    divergence_threshold: float = 0.05
    # consecutive breaches before a rollback [BIGDL_TORCH_ROLLOUT_FOR]
    for_count: int = 2
    # consecutive clean evaluations before a promote
    # [BIGDL_TORCH_ROLLOUT_HOLD]
    hold_evals: int = 3
    # seconds after a rollback during which offers are refused
    # [BIGDL_TORCH_ROLLOUT_COOLDOWN]
    cooldown_s: float = 30.0

    @classmethod
    def from_env(cls) -> "RolloutConfig":
        return cls(
            watch_dir=_env_str("BIGDL_TORCH_ROLLOUT_WATCH", None),
            poll_s=_env_float("BIGDL_TORCH_ROLLOUT_POLL", 1.0),
            canary_fraction=_env_float("BIGDL_TORCH_ROLLOUT_CANARY_FRACTION",
                                       0.25),
            divergence_threshold=_env_float(
                "BIGDL_TORCH_ROLLOUT_DIVERGENCE", 0.05),
            for_count=_env_int("BIGDL_TORCH_ROLLOUT_FOR", 2),
            hold_evals=_env_int("BIGDL_TORCH_ROLLOUT_HOLD", 3),
            cooldown_s=_env_float("BIGDL_TORCH_ROLLOUT_COOLDOWN", 30.0),
        )


@dataclasses.dataclass
class TunerConfig:
    """The kernel auto-tuner (``ops/autotune.py``), JAX ``TunerConfig``.

    Off by default: every ``impl="auto"`` site then dispatches by its
    static policy and the tuner module is never consulted.  On, the
    attention, conv+BN, paged-decode and int8-matmul sites resolve their
    impl from the cached search."""

    # master switch [BIGDL_TORCH_TUNER]
    enabled: bool = False
    # JSON decision store, keyed on (site, shape, dtype, platform);
    # unset = in memory only [BIGDL_TORCH_TUNER_CACHE]
    cache_path: Optional[str] = None
    # time the candidates on the caller's inputs (forward + backward
    # where the site is differentiable), never while a CUDA graph is
    # being captured; measured times override the cost model
    # [BIGDL_TORCH_TUNER_MEASURE]
    measure: bool = False
    # timed runs per measured candidate, after one warm-up
    # [BIGDL_TORCH_TUNER_MEASURE_ITERS]
    measure_iters: int = 3

    @classmethod
    def from_env(cls) -> "TunerConfig":
        return cls(
            enabled=_env_bool("BIGDL_TORCH_TUNER", False),
            cache_path=_env_str("BIGDL_TORCH_TUNER_CACHE", None),
            measure=_env_bool("BIGDL_TORCH_TUNER_MEASURE", False),
            measure_iters=_env_int("BIGDL_TORCH_TUNER_MEASURE_ITERS", 3),
        )


@dataclasses.dataclass
class AutoscaleConfig:
    """The autoscaling policy loop inside the restart supervisor
    (``resilience/autoscale.py``), JAX ``AutoscaleConfig``.

    Off by default: the supervisor then only restarts.  On, the loop
    scrapes the children's ``/healthz`` and ``/metrics``, evaluates the
    scale rules and executes a decision as a checkpoint, stop and
    relaunch at the new world size (``dry_run`` logs and executes
    none).  A world of N is N processes, one GPU each."""

    # master switch [BIGDL_TORCH_AUTOSCALE]
    enabled: bool = False
    # the world sizes a decision may not leave
    # [BIGDL_TORCH_AUTOSCALE_MIN_WORLD / BIGDL_TORCH_AUTOSCALE_MAX_WORLD]
    min_world: int = 1
    max_world: int = 8
    # up multiplies the world by this, down divides
    # [BIGDL_TORCH_AUTOSCALE_FACTOR]
    factor: int = 2
    # seconds between evaluations [BIGDL_TORCH_AUTOSCALE_INTERVAL]
    interval_s: float = 10.0
    # no signal is trusted this long after a launch
    # [BIGDL_TORCH_AUTOSCALE_WARMUP]
    warmup_s: float = 30.0
    # no decision this long after one [BIGDL_TORCH_AUTOSCALE_COOLDOWN]
    cooldown_s: float = 120.0
    # consecutive breached evaluations before a rule decides
    # [BIGDL_TORCH_AUTOSCALE_HYSTERESIS]
    hysteresis: int = 2
    # the step-time band; 0 disables an edge
    # [BIGDL_TORCH_AUTOSCALE_STEP_TIME_HIGH / _LOW]
    step_time_high: float = 0.0
    step_time_low: float = 0.0
    # the queue-depth band [BIGDL_TORCH_AUTOSCALE_QUEUE_HIGH / _LOW]
    queue_high: float = 0.0
    queue_low: float = 0.0
    # a live goodput ratio under this scales down; 0 disables
    # [BIGDL_TORCH_AUTOSCALE_GOODPUT_FLOOR]
    goodput_floor: float = 0.0
    # a stalled host scales down [BIGDL_TORCH_AUTOSCALE_EVICT_STRAGGLERS]
    evict_stragglers: bool = False
    # the serving p99 band, seconds [BIGDL_TORCH_AUTOSCALE_P99_HIGH / _LOW]
    p99_high: float = 0.0
    p99_low: float = 0.0
    # the world the supervisor exports to its children; 0 = min_world
    # [BIGDL_TORCH_AUTOSCALE_WORLD]
    world: int = 0
    # evaluate, count and trace every decision, execute none
    # [BIGDL_TORCH_AUTOSCALE_DRY_RUN]
    dry_run: bool = False
    # rule pack: inline JSON list or a JSON file; unset = the rules of
    # the band knobs [BIGDL_TORCH_AUTOSCALE_RULES]
    rules: Optional[str] = None

    @classmethod
    def from_env(cls) -> "AutoscaleConfig":
        return cls(
            enabled=_env_bool("BIGDL_TORCH_AUTOSCALE", False),
            min_world=_env_int("BIGDL_TORCH_AUTOSCALE_MIN_WORLD", 1),
            max_world=_env_int("BIGDL_TORCH_AUTOSCALE_MAX_WORLD", 8),
            factor=_env_int("BIGDL_TORCH_AUTOSCALE_FACTOR", 2),
            interval_s=_env_float("BIGDL_TORCH_AUTOSCALE_INTERVAL", 10.0),
            warmup_s=_env_float("BIGDL_TORCH_AUTOSCALE_WARMUP", 30.0),
            cooldown_s=_env_float("BIGDL_TORCH_AUTOSCALE_COOLDOWN", 120.0),
            hysteresis=_env_int("BIGDL_TORCH_AUTOSCALE_HYSTERESIS", 2),
            step_time_high=_env_float(
                "BIGDL_TORCH_AUTOSCALE_STEP_TIME_HIGH", 0.0),
            step_time_low=_env_float("BIGDL_TORCH_AUTOSCALE_STEP_TIME_LOW",
                                     0.0),
            queue_high=_env_float("BIGDL_TORCH_AUTOSCALE_QUEUE_HIGH", 0.0),
            queue_low=_env_float("BIGDL_TORCH_AUTOSCALE_QUEUE_LOW", 0.0),
            goodput_floor=_env_float("BIGDL_TORCH_AUTOSCALE_GOODPUT_FLOOR",
                                     0.0),
            evict_stragglers=_env_bool(
                "BIGDL_TORCH_AUTOSCALE_EVICT_STRAGGLERS", False),
            p99_high=_env_float("BIGDL_TORCH_AUTOSCALE_P99_HIGH", 0.0),
            p99_low=_env_float("BIGDL_TORCH_AUTOSCALE_P99_LOW", 0.0),
            world=_env_int("BIGDL_TORCH_AUTOSCALE_WORLD", 0),
            dry_run=_env_bool("BIGDL_TORCH_AUTOSCALE_DRY_RUN", False),
            rules=_env_str("BIGDL_TORCH_AUTOSCALE_RULES", None),
        )


@dataclasses.dataclass
class HostConfig:
    """The process-level knobs JAX's ``BigDLConfig`` keeps at its top
    level (config.py:664-688): ``Engine.init``'s singleton check, the
    native host library, the logger filter and the step profiler."""

    # refuse a second Engine.init in one process
    # [BIGDL_TORCH_CHECK_SINGLETON]
    check_singleton: bool = False
    # skip the C++ host library (bigdl_tpu_torch/native): every function
    # takes its numpy fallback [BIGDL_TORCH_NO_NATIVE]
    no_native: bool = False
    # utils/logger_filter: skip the redirect entirely, and the file the
    # chatty loggers write to (default: a per-user file in the temp dir)
    # [BIGDL_TORCH_DISABLE_LOGGER / BIGDL_TORCH_LOG_PATH]
    disable_logger: bool = False
    log_path: Optional[str] = None
    # a directory: the trainers trace their first steps there with
    # torch.profiler (utils/profiler.StepProfiler) [BIGDL_TORCH_PROFILE]
    profile_dir: Optional[str] = None

    @classmethod
    def from_env(cls) -> "HostConfig":
        return cls(
            check_singleton=_env_bool("BIGDL_TORCH_CHECK_SINGLETON", False),
            no_native=_env_bool("BIGDL_TORCH_NO_NATIVE", False),
            disable_logger=_env_bool("BIGDL_TORCH_DISABLE_LOGGER", False),
            log_path=_env_str("BIGDL_TORCH_LOG_PATH", None),
            profile_dir=_env_str("BIGDL_TORCH_PROFILE", None),
        )


@dataclasses.dataclass
class FleetSimConfig:
    """The fleet simulator (``bigdl_tpu_torch/sim``), JAX
    ``FleetSimConfig``: synthetic hosts in one process driving the real
    autoscaler, alert engines and fleet aggregator through chaos
    scenarios on a virtual clock.  Changes nothing in a training or
    serving process."""

    # synthetic hosts a scenario runs at [BIGDL_TORCH_FLEET_HOSTS]
    hosts: int = 200
    # a builtin name, a comma-separated list of names, inline JSON or a
    # JSON file; unset = the whole builtin matrix
    # [BIGDL_TORCH_FLEET_SCENARIO]
    scenario: Optional[str] = None
    # divide every virtual duration (not the tick) by this
    # [BIGDL_TORCH_FLEET_TIME_COMPRESSION]
    time_compression: float = 1.0
    # host selection and per-host jitter [BIGDL_TORCH_FLEET_SEED]
    seed: int = 0

    @classmethod
    def from_env(cls) -> "FleetSimConfig":
        return cls(
            hosts=_env_int("BIGDL_TORCH_FLEET_HOSTS", 200),
            scenario=_env_str("BIGDL_TORCH_FLEET_SCENARIO", None),
            time_compression=_env_float(
                "BIGDL_TORCH_FLEET_TIME_COMPRESSION", 1.0),
            seed=_env_int("BIGDL_TORCH_FLEET_SEED", 0),
        )


@dataclasses.dataclass
class BigDLConfig:
    """The process-global configuration (JAX ``BigDLConfig``,
    config.py:655): one field a section of the port's ``BIGDL_TORCH_*``
    knobs.  ``configure(section=...)`` pins a section; from then on its
    class's ``from_env()``, which every reader calls, returns a copy of
    the pinned one instead of reading the environment."""

    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    rollout: RolloutConfig = dataclasses.field(
        default_factory=RolloutConfig)
    tuner: TunerConfig = dataclasses.field(default_factory=TunerConfig)
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig)
    host: HostConfig = dataclasses.field(default_factory=HostConfig)
    fleet: FleetSimConfig = dataclasses.field(default_factory=FleetSimConfig)

    @classmethod
    def from_env(cls) -> "BigDLConfig":
        """Every section read from the environment, pins ignored."""
        return cls(**{f.name: _SECTIONS[f.name].read_env()
                      for f in dataclasses.fields(cls)})

    def describe(self) -> str:
        lines = [f"{f.name} = {getattr(self, f.name)!r}"
                 for f in dataclasses.fields(self)]
        return "BigDLConfig:\n  " + "\n  ".join(lines)


_SECTIONS = {"serve": ServeConfig, "train": TrainConfig, "obs": ObsConfig,
             "router": RouterConfig, "rollout": RolloutConfig,
             "tuner": TunerConfig, "autoscale": AutoscaleConfig,
             "host": HostConfig, "fleet": FleetSimConfig}

# sections pinned by configure(): env refreshes and from_env skip them
_explicit: set = set()


def _consult_pins(name: str, cls) -> None:
    """Route ``cls.from_env()`` through the pins: the one place a
    ``configure(...)`` reaches every reader.  The environment reader
    stays as ``cls.read_env()``."""
    read_env = cls.from_env.__func__

    def from_env(klass):
        if name in _explicit:
            return dataclasses.replace(getattr(config, name))
        return read_env(klass)

    from_env.__doc__ = read_env.__doc__
    cls.read_env = classmethod(read_env)
    cls.from_env = classmethod(from_env)


for _name, _cls in _SECTIONS.items():
    _consult_pins(_name, _cls)

# the process-global instance (resolved from the environment at import)
config = BigDLConfig.from_env()


def configure(**kwargs) -> BigDLConfig:
    """Set sections programmatically (the highest-priority tier, JAX
    :862): each value is that section's config object, pinned until
    :func:`reload_from_env`.  Returns the global config."""
    fields = [f.name for f in dataclasses.fields(config)]
    for k, v in kwargs.items():
        if k not in fields:
            raise AttributeError(f"unknown config field {k!r}; fields: "
                                 + ", ".join(fields))
        if not isinstance(v, _SECTIONS[k]):
            raise TypeError(f"config field {k!r} takes a "
                            f"{_SECTIONS[k].__name__}, not "
                            f"{type(v).__name__}")
        setattr(config, k, v)
        _explicit.add(k)
    return config


def refresh_from_env() -> BigDLConfig:
    """Re-read every section not pinned by :func:`configure` from the
    environment into the global config (JAX :876)."""
    fresh = BigDLConfig.from_env()
    for f in dataclasses.fields(fresh):
        if f.name not in _explicit:
            setattr(config, f.name, getattr(fresh, f.name))
    return config


def reload_from_env() -> BigDLConfig:
    """Drop the pins and re-read everything from the environment (JAX
    :889)."""
    _explicit.clear()
    return refresh_from_env()


def tuner_enabled() -> bool:
    """``TunerConfig.from_env().enabled`` without reading the tuner's
    other knobs: the switch every ``impl="auto"`` call consults."""
    if "tuner" in _explicit:
        return config.tuner.enabled
    return _env_bool("BIGDL_TORCH_TUNER", False)


def obs_knob_key(*names: str) -> tuple:
    """A cheap change key of the obs knobs ``names``: their raw values
    in the environment, or, while :func:`configure` pins the obs
    section, the pinned section itself.  The tracer and the request
    collector, which the engine asks for at every decode step, rebuild
    from ``ObsConfig.from_env()`` only when the key moves."""
    if "obs" in _explicit:
        return ("pinned", config.obs)
    return tuple(os.environ.get(n) for n in names)


def build_dir() -> str:
    """Where the CUDA kernels are compiled to: ``build/bigdl_tpu_torch``
    beside the package's checkout, or ``BIGDL_TORCH_BUILD_DIR``."""
    default = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "bigdl_tpu_torch")
    return _env_str("BIGDL_TORCH_BUILD_DIR", default)


def nvcc_path() -> str:
    """The CUDA compiler: ``BIGDL_TORCH_NVCC``, else ``nvcc`` under
    ``CUDA_HOME`` (default ``/usr/local/cuda``), else ``nvcc`` on PATH."""
    explicit = _env_str("BIGDL_TORCH_NVCC", None)
    if explicit:
        return explicit
    home = _env_str("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


__all__ = ["ServeConfig", "TrainConfig", "ObsConfig", "RouterConfig",
           "RolloutConfig", "TunerConfig", "AutoscaleConfig", "HostConfig",
           "FleetSimConfig", "BigDLConfig", "config",
           "configure", "refresh_from_env", "reload_from_env",
           "tuner_enabled", "obs_knob_key", "build_dir", "nvcc_path"]
