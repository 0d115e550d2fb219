"""Elastic training: preemption, peer liveness, world-resize resume.

Counterpart of ``bigdl_tpu/resilience/elastic.py`` (:1-600):

* **Preemption.**  ``Engine.init`` installs a SIGTERM/SIGINT handler
  (``BIGDL_TORCH_PREEMPTION_HANDLER``) that only sets a flag; both
  trainers poll it at iteration boundaries, so the step in flight
  finishes, then they write an emergency checkpoint and raise
  :class:`Preempted`, a ``SystemExit`` with :data:`EXIT_PREEMPTED` (170).
* **Peer liveness.**  At world > 1 with ``BIGDL_TORCH_HEARTBEAT_DIR``
  set, each rank touches a file there every ``BIGDL_TORCH_HEARTBEAT_
  EVERY`` steps; a peer silent past ``BIGDL_TORCH_HEARTBEAT_TIMEOUT``
  seconds raises the fatal :class:`PeerLostError` before the collective
  that would hang on it.
* **World resize.**  :func:`ensure_shard_layout` re-lays the flat
  ZeRO-1 state vectors of a checkpoint written at N ranks (and any
  bucket plan) for M ranks and this run's plan, and resets the
  ``wire_ef`` residual to zeros on a resize or a plan change.
* :func:`restore_latest`, :func:`record_resume`, :func:`restore_stream`
  and :func:`run_main` (the exit-code contract).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.resilience.retry import PeerLostError

log = logging.getLogger("bigdl_tpu_torch.resilience")

# -------------------------------------------------------------- exit codes
# The supervisor contract.  Distinct from shell/signal conventions
# (126/127/128+n) and from sysexits so nothing else can alias them:
# preempted = evicted mid-run with an emergency checkpoint on disk —
# restart costs no retry budget; transient = EX_TEMPFAIL, restart under
# the RetryPolicy budget; fatal = EX_CONFIG, restarting cannot help.
EXIT_PREEMPTED = 170
EXIT_TRANSIENT = 75
EXIT_FATAL = 78


class Preempted(SystemExit):
    """Graceful preemption shutdown.  A ``SystemExit`` subclass so an
    unhandled one exits the interpreter with :data:`EXIT_PREEMPTED`
    (the supervisor's "resume me" signal) and so the classified retry
    loop — which only catches ``Exception`` — never swallows it."""

    def __init__(self, message: str = "preempted", step: Optional[int] = None,
                 checkpoint: Optional[str] = None):
        super().__init__(EXIT_PREEMPTED)
        self.message = message
        self.step = step
        self.checkpoint = checkpoint

    def __str__(self):
        return self.message


# ------------------------------------------------------- preemption flag
# One process-wide flag: the signal handler SETS it (async-signal-thin:
# flag + bookkeeping only), training loops POLL it at iteration
# boundaries so the in-flight step always completes.
_flag = threading.Event()
_signum: Optional[int] = None
_listeners = 0
_listener_lock = threading.Lock()
_installed: dict = {}  # signum -> previous handler


def preemption_requested() -> bool:
    return _flag.is_set()


def preemption_signal() -> Optional[int]:
    """The signal number that requested preemption (None if requested
    programmatically or not at all)."""
    return _signum


def request_preemption(signum: Optional[int] = None):
    """Programmatic preemption (tests / cooperative shutdown): the next
    iteration boundary runs the same graceful path a SIGTERM would."""
    global _signum
    _signum = signum
    _flag.set()


def clear_preemption():
    """Drop the flag (test hook / after a handled preemption)."""
    global _signum
    _signum = None
    _flag.clear()


def _add_listener():
    global _listeners
    with _listener_lock:
        _listeners += 1


def _remove_listener():
    global _listeners
    with _listener_lock:
        _listeners = max(0, _listeners - 1)


def _handler(signum, frame):
    request_preemption(signum)
    log.warning("elastic: received signal %d — finishing the in-flight "
                "step, then emergency checkpoint + exit %d",
                signum, EXIT_PREEMPTED)
    try:
        from bigdl_tpu_torch import obs

        obs.get_tracer().event("elastic.preempt_signal", signum=signum,
                               listeners=_listeners)
    except Exception:  # noqa: BLE001 — telemetry must not break shutdown
        pass
    if _listeners == 0:
        # no training loop is polling: nothing will ever act on the
        # flag, so exit from here (atexit still flushes obs shards).
        # SIGINT outside training keeps its interactive meaning.
        prev = _installed.get(signum)
        if signum == getattr(signal, "SIGINT", None):
            if callable(prev):
                return prev(signum, frame)
            raise KeyboardInterrupt
        raise Preempted(f"signal {signum} with no active training loop")


def install_preemption_handler(signals=None) -> bool:
    """Install the SIGTERM/SIGINT preemption handler (idempotent;
    ``Engine.init`` calls it unless ``BIGDL_TORCH_PREEMPTION_HANDLER=0``).  Returns False when handlers cannot be
    installed (non-main thread) — training then simply lacks graceful
    preemption, it does not fail."""
    if signals is None:
        signals = (signal.SIGTERM, signal.SIGINT)
    ok = True
    for s in signals:
        if s in _installed:
            continue
        try:
            _installed[s] = signal.signal(s, _handler)
        except (ValueError, OSError):  # not the main thread / exotic env
            log.debug("elastic: cannot install handler for signal %s "
                      "(not the main thread?)", s)
            ok = False
    return ok


def uninstall_preemption_handler():
    """Restore the pre-install handlers (test hook)."""
    for s, prev in list(_installed.items()):
        try:
            signal.signal(s, prev)
        except (ValueError, OSError):
            pass
        _installed.pop(s, None)


# ---------------------------------------------------------- peer liveness
class HeartbeatMonitor:
    """Heartbeat-file peer liveness for multi-host runs.

    Each host writes ``heartbeat.h<host>`` in a shared directory every
    ``every_steps`` training steps (:meth:`beat`); :meth:`check` — run
    at every iteration boundary, plus a daemon thread for telemetry
    while the main thread is blocked on device work — compares every
    peer file's mtime against ``timeout_s`` and raises
    :class:`PeerLostError` (classified fatal) instead of letting the
    next collective hang forever on a dead peer.  A peer that never wrote a
    file at all counts from this monitor's start time, so a host that
    dies during bring-up is caught too."""

    def __init__(self, directory: str, host: int, n_hosts: int,
                 timeout_s: float = 60.0, every_steps: int = 1,
                 interval_s: Optional[float] = None, clock=time.time):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.host = int(host)
        self.n_hosts = int(n_hosts)
        self.timeout_s = float(timeout_s)
        self.every_steps = max(1, int(every_steps))
        self.interval_s = (interval_s if interval_s is not None
                           else max(0.05, min(1.0, self.timeout_s / 4.0)))
        self._clock = clock
        self._started = clock()
        self._last_beat_step: Optional[int] = None
        self._lost: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def path(self, host: int) -> str:
        return os.path.join(self.directory, f"heartbeat.h{host}")

    def beat(self, step: Optional[int] = None, force: bool = False):
        """Touch this host's heartbeat file (every ``every_steps``
        steps; ``force`` beats unconditionally, e.g. at session start)."""
        if not force and step is not None and \
                self._last_beat_step is not None and \
                0 <= step - self._last_beat_step < self.every_steps:
            # (a step that moved BACKWARDS — retry rewound neval —
            # always beats rather than starving until it catches up)
            return
        self._last_beat_step = step
        p = self.path(self.host)
        tmp = p + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"host": self.host, "step": step,
                           "ts": self._clock()}, fh)
            os.replace(tmp, p)
        except OSError as e:  # a full/blipping shared FS must not kill
            log.warning("heartbeat write failed: %s", e)  # the trainer

    def peer_ages(self, now: Optional[float] = None) -> dict:
        """Seconds since each peer's last beat (monitor start stands in
        for a peer that never beat)."""
        now = self._clock() if now is None else now
        ages = {}
        for h in range(self.n_hosts):
            if h == self.host:
                continue
            try:
                last = os.path.getmtime(self.path(h))
            except OSError:
                last = self._started
            ages[h] = now - last
        return ages

    def scan(self, now: Optional[float] = None) -> dict:
        """Flag peers silent past the timeout; returns {host: age}.
        Each newly lost peer emits one ``elastic.peer_lost`` trace
        event and one ``bigdl_peer_lost_total`` increment.  Every scan
        also mirrors the per-peer ages into
        ``bigdl_heartbeat_age_seconds{host}`` gauges — staleness as
        *data* the alert engine and ``/healthz`` can watch degrade,
        not only the terminal :class:`PeerLostError`."""
        ages = self.peer_ages(now)
        if ages:
            from bigdl_tpu_torch import obs

            gauge = obs.get_registry().gauge(
                names.HEARTBEAT_AGE_SECONDS,
                "Seconds since each peer host's last heartbeat file "
                "write", labels=("host",))
            for h, age in ages.items():
                gauge.labels(host=h).set(round(max(0.0, age), 3))
        for h, age in ages.items():
            if age > self.timeout_s and h not in self._lost:
                self._lost[h] = age
                log.error("elastic: peer host %d silent for %.1fs "
                          "(timeout %.1fs)", h, age, self.timeout_s)
                from bigdl_tpu_torch import obs

                obs.get_tracer().event(
                    "elastic.peer_lost", peer=h, age_s=round(age, 3),
                    timeout_s=self.timeout_s, host=self.host)
                obs.get_registry().counter(
                    names.PEER_LOST_TOTAL,
                    "Peers flagged dead by the heartbeat monitor").inc()
        return dict(self._lost)

    def check(self):
        """Raise :class:`PeerLostError` when any peer is lost — called
        at iteration boundaries, BEFORE the step that would hang."""
        lost = self.scan()
        if lost:
            detail = ", ".join(f"host {h} silent {age:.1f}s"
                               for h, age in sorted(lost.items()))
            raise PeerLostError(
                f"peer(s) lost past BIGDL_TORCH_HEARTBEAT_TIMEOUT="
                f"{self.timeout_s:g}s: {detail}; refusing to enter the "
                "next collective (it would hang forever)")

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="bigdl-torch-heartbeat", daemon=True)
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.scan()
            except Exception:  # noqa: BLE001 — monitor must never die
                log.exception("heartbeat scan failed")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ---------------------------------------------------------------- session
class ElasticSession:
    """Per-``optimize()`` elastic state: registers this loop as a
    preemption listener and owns the optional heartbeat monitor."""

    def __init__(self, monitor: Optional[HeartbeatMonitor] = None):
        self.monitor = monitor
        _add_listener()
        if monitor is not None:
            monitor.beat(force=True)
            monitor.start()

    @classmethod
    def from_config(cls) -> "ElasticSession":
        """A session with a heartbeat monitor when
        ``BIGDL_TORCH_HEARTBEAT_DIR`` is set and the world has more
        than one rank (each rank is a host here)."""
        import torch.distributed as dist

        from bigdl_tpu_torch.config import TrainConfig

        cfg = TrainConfig.from_env()
        monitor = None
        if cfg.heartbeat_dir and dist.is_initialized() \
                and dist.get_world_size() > 1:
            monitor = HeartbeatMonitor(
                cfg.heartbeat_dir, dist.get_rank(), dist.get_world_size(),
                timeout_s=cfg.heartbeat_timeout,
                every_steps=cfg.heartbeat_every)
        return cls(monitor)

    def on_iteration(self, step: int) -> bool:
        """Iteration-boundary poll: beat + peer check (may raise
        :class:`PeerLostError`); returns True when a preemption is
        pending and the caller must run its graceful shutdown."""
        if self.monitor is not None:
            self.monitor.beat(step)
            self.monitor.check()
        return _flag.is_set()

    def close(self):
        _remove_listener()
        if self.monitor is not None:
            self.monitor.stop()


# -------------------------------------------------- topology-aware resume
def _as_tensor(v, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v, copy=True))
    return t if device is None else t.to(device)


def ensure_shard_layout(state: dict, flat_elems: int, pad: int,
                        n_shards: int, topology: Optional[dict] = None,
                        buckets=None, device=None) -> dict:
    """Re-lay loaded ZeRO-1 optimizer state for this world (JAX
    :360-483).

    A state vector is the padded flat vector of its writer:
    ``flat_elems`` true entries, the writer's alignment padding, and,
    for a run with buckets (``topology["buckets"]``), the shard-major
    order of the bucketed exchange (each rank owns a chunk of every
    bucket).  A vector that does not match this run's layout is taken
    back to flat coordinates (``param_major[old_coords] = v``, through
    :func:`parallel.wire.bucket_param_coords`), stripped of the old
    padding, padded with ``pad`` zeros and put into this run's shard-
    major order (``v[new_coords]``).  Matching vectors and scalars pass
    through as they are.

    ``wire_ef`` (one ``(world, padded)`` row a rank) has no meaning
    under another world or plan, so a resize or a plan change resets it
    to zeros; a same-world, same-plan resume keeps it bit for bit.
    Returns a new dict of tensors (on ``device`` when given)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.parallel import wire as _W

    padded = flat_elems + pad
    old_topo = topology or {}
    old_buckets = old_topo.get("buckets")
    old_world = old_topo.get("world_size")
    plan_changed = not _W.buckets_equal(old_buckets, buckets)
    # multi-bucket plans at different worlds permute differently even
    # when the plan itself matches (chunk = size // world)
    if not plan_changed and buckets is not None and len(buckets) > 1 \
            and old_world is not None and int(old_world) != int(n_shards):
        plan_changed = True
    ef = state.get("wire_ef")
    ef_stale = ef is not None and (
        tuple(ef.shape) != (n_shards, padded) or plan_changed)
    stale = [k for k, v in state.items()
             if k != "wire_ef" and getattr(v, "ndim", None) == 1
             and v.shape[0] >= flat_elems
             and (v.shape[0] != padded or plan_changed)]
    state = dict(state)
    if ef_stale:
        state["wire_ef"] = torch.zeros((n_shards, padded),
                                       dtype=torch.float32, device=device)
        log.info("elastic: reset the wire_ef error-feedback residual "
                 "%s -> %s on world resize / bucket-plan change",
                 tuple(ef.shape), (n_shards, padded))
        obs.get_tracer().event(
            "elastic.ef_reset", old_shape=list(ef.shape),
            new_shape=[n_shards, padded],
            old_world=old_world, new_world=n_shards,
            plan_changed=bool(plan_changed))
    if not stale:
        return state
    old_len = state[stale[0]].shape[0]
    for k in stale:
        if state[k].shape[0] != old_len:
            raise ValueError(
                "inconsistent optimizer-state vector lengths "
                f"{ {k: int(state[k].shape[0]) for k in stale} }; the "
                "checkpoint does not look like one flat ZeRO layout")
    old_coords = None
    if old_buckets is not None and len(old_buckets) > 1:
        if not old_world:
            raise ValueError(
                "checkpoint topology carries a bucket plan but no "
                "world_size — cannot un-permute the shard-major state")
        old_coords = _W.bucket_param_coords(old_buckets, int(old_world))
        if old_coords.shape[0] != old_len:
            raise ValueError(
                f"topology bucket plan covers {old_coords.shape[0]} "
                f"elems but the state vectors hold {old_len}")
    new_coords = None
    if buckets is not None and len(buckets) > 1:
        new_coords = _W.bucket_param_coords(buckets, int(n_shards))
    for k in stale:
        v = _as_tensor(state[k], device)
        if old_coords is not None:
            flat = torch.zeros_like(v)
            flat[torch.from_numpy(old_coords).to(v.device)] = v
            v = flat
        v = v[:flat_elems]
        if pad:
            v = torch.cat([v, v.new_zeros(pad)])
        if new_coords is not None:
            v = v[torch.from_numpy(new_coords).to(v.device)]
        state[k] = v.contiguous()
    log.info("elastic: re-partitioned optimizer state %s from a "
             "%s-shard layout (%d elems) to %d shards (%d elems)%s",
             sorted(stale), old_world or "?", old_len, n_shards, padded,
             " across bucket plans" if plan_changed and (
                 old_coords is not None or new_coords is not None)
             else "")
    obs.get_tracer().event(
        "elastic.resize", old_world=old_world, new_world=n_shards,
        old_elems=int(old_len), new_elems=int(padded),
        keys=sorted(stale), plan_changed=bool(plan_changed))
    return state


def record_resume(old_world: Optional[int], new_world: int,
                  step: Optional[int] = None):
    """Account one resume-from-checkpoint: ``bigdl_resumes_total``
    labeled with the resize (``"2to1"``, ``"none"`` for same-world,
    ``"unknown"`` for pre-topology checkpoints) + a trace event."""
    if old_world is None:
        resize = "unknown"
    elif int(old_world) == int(new_world):
        resize = "none"
    else:
        resize = f"{int(old_world)}to{int(new_world)}"
    from bigdl_tpu_torch import obs

    obs.get_registry().counter(
        names.RESUMES_TOTAL,
        "Resumes from checkpoint, labeled by world resize",
        labels=("resize",)).labels(resize=resize).inc()
    obs.get_tracer().event("elastic.resume", resize=resize,
                           old_world=old_world, new_world=new_world,
                           step=step)
    return resize


def restore_stream(optimizer, extra) -> bool:
    """Apply a checkpoint's ``stream`` state to a streaming dataset
    (dataset/stream.py): seek the source back to the trained offset so
    the resume re-reads exactly the records the rolled-back weights
    never kept — the exactly-once half of a crash/resize resume.  A
    streaming resume replaces the epoch fast-forward (the stream seeks
    by offset, not by replaying an epoch's batch order).  Returns True
    when the optimizer's dataset is streaming.  Both resume paths call
    this: ``restore_latest`` and the DistriOptimizer in-process
    retry."""
    restore = getattr(getattr(optimizer, "dataset", None),
                      "stream_restore", None)
    if restore is None:
        return False
    restore((extra or {}).get("stream"))
    optimizer._pending_fast_forward = 0
    return True


def restore_latest(optimizer, directory: Optional[str] = None):
    """Resume an optimizer from the newest intact checkpoint in
    ``directory`` (default: its own checkpoint path): load weights +
    optimizer state (re-partitioned lazily by the step build when the
    world changed), rewind the epoch/neval/epoch-start counters so
    triggers, LR schedule, RNG folding, and the mid-epoch fast-forward
    all resume exactly, and account the resume.  Returns the
    checkpoint's extra dict, or None when the directory holds no
    checkpoint yet (a first boot is not an error).  Stamps the goodput
    ledger's rework mark (JAX :571): the earlier attempts' highest step,
    from their ledger shards, so the steps replayed up to it count as
    ``rework``."""
    from bigdl_tpu_torch.utils.serializer import load_latest_checkpoint

    d = directory or optimizer.checkpoint_path
    if not d or not os.path.isdir(d):
        return None
    try:
        extra = load_latest_checkpoint(d, optimizer.model,
                                       optimizer.optim_method)
    except FileNotFoundError:
        return None
    if "epoch" in extra:
        optimizer.state["epoch"] = extra["epoch"]
    if "neval" in extra:
        optimizer.state["neval"] = extra["neval"]
    optimizer.state["epoch_neval0"] = extra.get(
        "epoch_neval0", optimizer.state["neval"])
    # a mid-epoch checkpoint resumes N batches into its epoch: the
    # training loop skips that many so the replayed data order matches
    optimizer._pending_fast_forward = max(
        0, optimizer.state["neval"] - optimizer.state["epoch_neval0"])
    # streaming datasets seek by offset instead (clears the
    # fast-forward: a stream has no epoch order to replay)
    restore_stream(optimizer, extra)
    topo = extra.get("topology") or {}
    record_resume(topo.get("world_size"),
                  getattr(optimizer, "n_shards", 1),
                  step=optimizer.state.get("neval"))
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import server as _obs_server

    obs.get_ledger().stamp_resume(optimizer.state.get("neval"))
    # re-stamp /healthz with the restored step: a resume that rewinds
    # neval must restart the hang watchdog's stall clock, not inherit
    # the dead attempt's stamp age
    if _obs_server.get_server() is not None:
        _obs_server.note_step(optimizer.state.get("neval") or 0)
    return extra


# ------------------------------------------------------------- entrypoint
def run_main(fn) -> int:
    """Entry-point wrapper mapping training outcomes onto the elastic
    exit-code contract: 0 on success, :data:`EXIT_PREEMPTED` via the
    :class:`Preempted` SystemExit, classified-fatal errors →
    :data:`EXIT_FATAL`, everything transient → :data:`EXIT_TRANSIENT`.
    Use as ``sys.exit(elastic.run_main(main))``."""
    from bigdl_tpu_torch.resilience.retry import classify

    try:
        fn()
        return 0
    except SystemExit:
        raise  # incl. Preempted: the code is already the contract
    except KeyboardInterrupt:
        raise
    except BaseException as e:  # noqa: BLE001 — the mapping IS the point
        code = EXIT_FATAL if classify(e) == "fatal" else EXIT_TRANSIENT
        log.exception("elastic.run_main: %s -> exit %d",
                      type(e).__name__, code)
        raise SystemExit(code)


__all__ = ["EXIT_PREEMPTED", "EXIT_TRANSIENT", "EXIT_FATAL", "Preempted",
           "preemption_requested", "preemption_signal",
           "request_preemption", "clear_preemption",
           "install_preemption_handler", "uninstall_preemption_handler",
           "HeartbeatMonitor", "ElasticSession", "ensure_shard_layout",
           "record_resume", "restore_stream", "restore_latest", "run_main"]
