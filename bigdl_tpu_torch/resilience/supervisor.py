"""Restart supervisor — the process-level half of elastic training.

Counterpart of ``bigdl_tpu/resilience/supervisor.py``, with its exit
classification, counters, events and goodput record.  A scheduler kills
whole trainer processes (preemption) and nobody restarts them; this
module is that restarter::

    python -m bigdl_tpu_torch.resilience.supervisor [options] -- \
        python train.py ...

It loops the command, classifying each exit against the elastic
exit-code contract (resilience/elastic.py):

* ``0`` — done, exit 0.
* :data:`~bigdl_tpu_torch.resilience.elastic.EXIT_PREEMPTED` — the child shut
  down gracefully with an emergency checkpoint on disk.  Restart
  immediately; preemptions consume no retry budget (an eviction is not
  a failure), bounded only by ``--max-preemptions``.
* :data:`~bigdl_tpu_torch.resilience.elastic.EXIT_FATAL` (and shell usage
  errors) — restarting cannot help; exit with the child's code.
* anything else — transient.  Back off and restart under the
  :class:`~bigdl_tpu_torch.resilience.retry.RetryPolicy` budget (attempt
  cap + sliding window), then give up with the child's code.

Each launch exports ``BIGDL_TORCH_ELASTIC_ATTEMPT`` (0-based launch
counter) and ``BIGDL_TORCH_ELASTIC_PREEMPTIONS`` so the child can adapt
and resume via ``elastic.restore_latest`` (checkpoints are
topology-tagged, so a world-2 snapshot restores at world 1); with the
autoscaler, ``BIGDL_TORCH_AUTOSCALE_WORLD`` too.  A world of N is N
processes, one GPU each, so the supervised command for N > 1 is a
launcher of N ranks (``torchrun``).  The supervisor itself never
touches CUDA: no ``Engine.init``, no ``torch.cuda`` call, and its
telemetry flush reads no device memory in a process that has not
initialized CUDA, so the card stays its children's.  SIGTERM/SIGINT to
the supervisor forwards to the child, waits for its graceful exit, and stops the loop
(a preempted supervisor must not immediately respawn what the scheduler
is evicting).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

from bigdl_tpu_torch.resilience.elastic import (
    EXIT_FATAL,
    EXIT_PREEMPTED,
)
from bigdl_tpu_torch.resilience.retry import RetryPolicy
from bigdl_tpu_torch.obs import names

log = logging.getLogger("bigdl_tpu_torch.resilience")


class HangWatchdog:
    """Classify a silent child as *hung* via its live ``/healthz``.

    Heartbeats catch a dead *host* and exit codes catch a dead
    *process*, but a child stuck inside a collective (or a wedged data
    loader) is alive by both measures while making zero progress.  The
    live telemetry plane closes that gap: both optimizers stamp every
    resolved step (``obs/server.note_step``), ``/healthz`` serves the
    stamp's age, and this watchdog polls it — a child whose
    ``step_age_s`` exceeds ``BIGDL_TORCH_HANG_TIMEOUT`` is killed and
    restarted as a transient failure under the retry budget.

    The child's endpoint is found via ``BIGDL_TORCH_OBS_PORT`` (>0), or —
    for ephemeral port 0 — via the ``BIGDL_TORCH_OBS_PORT_FILE`` the child
    writes its bound port into (the supervisor injects a temp path
    when the launcher didn't).  Conservative by construction: any
    fetch failure, a missing port, or a child that has not resolved
    its *first* step yet (startup/compile can legitimately take longer
    than the hang budget) reads as "cannot tell", never as "hung".
    ``fetch`` is injectable so every branch unit-tests without HTTP."""

    def __init__(self, timeout_s: float, port: Optional[int] = None,
                 port_file: Optional[str] = None,
                 fetch: Optional[Callable[[str], Optional[dict]]] = None):
        self.timeout_s = float(timeout_s)
        self.port = int(port) if port else None
        self.port_file = port_file
        self._fetch = fetch or self._http_fetch
        self.last_payload: Optional[dict] = None

    @staticmethod
    def _http_fetch(url: str) -> Optional[dict]:
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=1.0) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 — unreachable != hung
            return None

    def _resolve_port(self) -> Optional[int]:
        if self.port:
            return self.port
        if self.port_file and os.path.isfile(self.port_file):
            try:
                with open(self.port_file, encoding="utf-8") as fh:
                    self.port = int(fh.read().strip() or 0) or None
            except (OSError, ValueError):
                self.port = None
        return self.port

    def health(self) -> Optional[dict]:
        """One ``/healthz`` poll (None when unreachable/unknown)."""
        port = self._resolve_port()
        if not port:
            return None
        payload = self._fetch(f"http://127.0.0.1:{port}/healthz")
        if payload is not None:
            self.last_payload = payload
        return payload

    def stalled(self) -> bool:
        """True only on positive evidence: the child answered and its
        newest step stamp is older than the hang budget."""
        payload = self.health()
        if not payload:
            return False
        age = payload.get("step_age_s")
        return age is not None and float(age) > self.timeout_s

    def collect_bundle(self) -> Optional[dict]:
        """Ask the child to write its own debug bundle via ``GET
        /debugz`` — a child wedged in a collective still answers: the
        obs server's request threads are daemons independent of the
        stuck main thread.  None when unreachable (a dead child's
        postmortem is its atexit flush + the supervisor-side bundle)."""
        port = self._resolve_port()
        if not port:
            return None
        return self._fetch(f"http://127.0.0.1:{port}/debugz")


class Supervisor:
    """Run ``cmd`` in a classify-and-restart loop.

    ``runner(cmd, env) -> returncode`` is injectable so every branch of
    the loop is a unit test with no subprocesses; the default runner
    spawns the real child and forwards SIGTERM/SIGINT to it."""

    def __init__(self, cmd: Sequence[str], max_retries: int = 5,
                 max_preemptions: int = 1000,
                 policy: Optional[RetryPolicy] = None,
                 runner: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 fatal_codes: Sequence[int] = (EXIT_FATAL, 2, 126, 127),
                 hang_timeout: Optional[float] = None,
                 autoscaler=None, stop_grace_s: float = 30.0):
        if not cmd:
            raise ValueError("supervisor needs a command to run")
        self.cmd = list(cmd)
        self.max_preemptions = int(max_preemptions)
        self.policy = policy or RetryPolicy.from_config(
            max_retries=max_retries)
        self._runner = runner or self._spawn
        self._sleep = sleep
        self.fatal_codes = set(int(c) for c in fatal_codes)
        if hang_timeout is None:
            from bigdl_tpu_torch.config import refresh_from_env

            hang_timeout = refresh_from_env().train.hang_timeout
        self.hang_timeout = float(hang_timeout or 0.0)
        # autoscaling policy loop (resilience/autoscale.py): polled
        # from the child-wait loop; a decision gracefully stops the
        # child (emergency checkpoint) and relaunches at the new world
        self.autoscaler = autoscaler
        self.stop_grace_s = float(stop_grace_s)
        self.resizes = 0
        self._resize_decision = None
        # resize restarts get the SAME deterministic-jitter exponential
        # backoff shape as transient retries, but from their own policy
        # so legitimate resizes never eat the failure budget — repeated
        # rapid resizes back off harder (thrash damping on top of the
        # controller's cooldown)
        self._resize_policy = RetryPolicy.from_config(
            max_retries=1_000_000)
        self._resize_policy.window_budget = 1_000_000
        self.attempt = 0          # 0-based launch counter (all launches)
        self.preemptions = 0
        self.hangs = 0
        self._child: Optional[subprocess.Popen] = None
        self._terminated = False  # the supervisor itself was signalled
        self._hang_detected = False

    # ------------------------------------------------------------- child
    def _make_watchdog(self, env: dict) -> Optional[HangWatchdog]:
        """A watchdog for this launch, or None when disabled.  Needs
        BIGDL_TORCH_HANG_TIMEOUT > 0 and a child live endpoint to poll
        (BIGDL_TORCH_OBS_PORT; port 0 resolves through the port file the
        launch env carries — injected by :meth:`run` when absent)."""
        if self.hang_timeout <= 0:
            return None
        port_spec = env.get("BIGDL_TORCH_OBS_PORT")
        if port_spec in (None, ""):
            log.warning("supervisor: BIGDL_TORCH_HANG_TIMEOUT=%g set but "
                        "BIGDL_TORCH_OBS_PORT is not — the hang watchdog "
                        "needs the child's /healthz; disabled",
                        self.hang_timeout)
            return None
        try:
            port = int(port_spec)
        except ValueError:
            return None
        return HangWatchdog(self.hang_timeout,
                            port=port if port > 0 else None,
                            port_file=env.get("BIGDL_TORCH_OBS_PORT_FILE"))

    def _bind_autoscaler(self, env: dict):
        """Point the policy loop's scraper at this launch's live
        endpoint(s): explicit peers when the env names them, else the
        child's own /healthz via the same port / port-file resolution
        the hang watchdog uses."""
        if self.autoscaler is None:
            return
        peers = env.get("BIGDL_TORCH_OBS_PEERS") or None
        port = None
        if not peers:
            try:
                port = int(env.get("BIGDL_TORCH_OBS_PORT") or 0) or None
            except ValueError:
                port = None
        self.autoscaler.bind_endpoint(
            port=port, port_file=env.get("BIGDL_TORCH_OBS_PORT_FILE"),
            peers=peers)
        self.autoscaler.on_launch()

    def _graceful_stop(self, why: str) -> int:
        """SIGTERM the child (graceful preemption: it finishes the
        in-flight step and writes an emergency checkpoint), escalate to
        SIGKILL only past ``stop_grace_s``."""
        log.warning("supervisor: stopping the child (%s) — SIGTERM, "
                    "grace %.1fs", why, self.stop_grace_s)
        self._child.terminate()
        try:
            return self._child.wait(timeout=self.stop_grace_s)
        except subprocess.TimeoutExpired:
            log.error("supervisor: child ignored SIGTERM for %.1fs — "
                      "killing it", self.stop_grace_s)
            self._child.kill()
        return self._child.wait()

    def _spawn(self, cmd: List[str], env: dict) -> int:
        self._child = subprocess.Popen(cmd, env=env)
        watchdog = self._make_watchdog(env)
        self._bind_autoscaler(env)
        try:
            if watchdog is None and self.autoscaler is None:
                return self._child.wait()
            # poll a few times per hang budget / policy interval:
            # fine-grained enough to catch a stall or act on a decision
            # promptly, coarse enough that the scrape cost is noise
            polls = [2.0]
            if watchdog is not None:
                polls.append(self.hang_timeout / 4.0)
            if self.autoscaler is not None:
                polls.append(self.autoscaler.cfg.interval_s / 2.0)
            poll = max(0.1, min(polls))
            while True:
                try:
                    return self._child.wait(timeout=poll)
                except subprocess.TimeoutExpired:
                    pass
                if self._terminated:
                    continue
                if watchdog is not None and watchdog.stalled():
                    payload = watchdog.last_payload or {}
                    log.error(
                        "supervisor: child step stamp stale for %.1fs "
                        "(step %s, budget %.1fs) — killing the hung "
                        "child", payload.get("step_age_s", -1.0),
                        payload.get("step"), self.hang_timeout)
                    self._hang_detected = True
                    # black-box capture BEFORE the kill: the child's
                    # own /debugz bundles what it was doing (its HTTP
                    # daemon threads answer even with the main thread
                    # wedged); gated on BIGDL_TORCH_BUNDLE_DIR, best effort
                    try:
                        from bigdl_tpu_torch.config import refresh_from_env

                        if refresh_from_env().obs.bundle_dir:
                            got = watchdog.collect_bundle()
                            if got and got.get("bundle"):
                                log.warning(
                                    "supervisor: hung child wrote "
                                    "debug bundle %s", got["bundle"])
                    except Exception:  # noqa: BLE001 — never delay the kill
                        pass
                    self._child.terminate()
                    try:
                        self._child.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        self._child.kill()
                    return self._child.wait()
                if self.autoscaler is not None \
                        and self._resize_decision is None:
                    decision = self.autoscaler.tick()
                    if decision is not None and not decision.dry_run:
                        self._resize_decision = decision
                        return self._graceful_stop(
                            f"autoscale {decision.direction} "
                            f"{decision.old_world}->"
                            f"{decision.new_world} [{decision.reason}]")
        finally:
            self._child = None

    def _forward_signal(self, signum, frame):
        del frame
        self._terminated = True
        log.warning("supervisor: signal %d — forwarding to child and "
                    "stopping the restart loop", signum)
        child = self._child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signum)
            except OSError:
                pass

    def install_signal_forwarding(self):
        """SIGTERM/SIGINT → forward to the child, then exit with its
        code instead of restarting (main() installs this; tests with a
        fake runner don't need it)."""
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(s, self._forward_signal)
            except (ValueError, OSError):
                pass

    # -------------------------------------------------------------- loop
    def _event(self, name: str, **attrs):
        from bigdl_tpu_torch import obs

        obs.get_tracer().event(name, **attrs)

    def _count_restart(self, kind: str):
        from bigdl_tpu_torch import obs

        obs.get_registry().counter(
            names.SUPERVISOR_RESTARTS_TOTAL,
            "Child restarts, by exit classification",
            labels=("kind",)).labels(kind=kind).inc()

    def _maybe_bundle(self, kind: str, rc: int):
        """Supervisor-side debug bundle around a crash/hang restart:
        the supervisor's own flight ring, registry (restart counters)
        and alert state, stamped with the exit classification — the
        half of the postmortem that survives the child.  Gated on
        BIGDL_TORCH_BUNDLE_DIR; best effort."""
        try:
            from bigdl_tpu_torch.config import refresh_from_env

            if not refresh_from_env().obs.bundle_dir:
                return
            from bigdl_tpu_torch.obs import bundle

            bundle.build_bundle(
                reason=f"child {kind} rc={rc}",
                trigger="supervisor",
                context={"kind": kind, "rc": rc,
                         "attempt": self.attempt,
                         "hangs": self.hangs,
                         "preemptions": self.preemptions})
        except Exception:  # noqa: BLE001 — bundling never blocks restarts
            log.exception("supervisor: debug bundle failed")

    def _backoff_sleep(self, kind: str, rc: int, delay: float):
        """Sleep a restart backoff, visibly: one ``supervisor.backoff``
        trace event (what the chosen sleep was and why) plus the
        goodput-ledger record the cross-attempt ratio attributes —
        backoff is badput the children never see."""
        from bigdl_tpu_torch import obs

        self._event("supervisor.backoff", kind=kind, rc=rc,
                    delay_s=round(delay, 3))
        if delay <= 0:
            return
        t0 = time.perf_counter()
        self._sleep(delay)
        obs.get_ledger().record("supervisor_backoff", t0,
                                time.perf_counter() - t0, rc=rc,
                                restart_kind=kind)

    def run(self) -> int:
        self._event("elastic.supervisor_start", cmd=self.cmd)
        while True:
            env = dict(os.environ)
            env["BIGDL_TORCH_ELASTIC_ATTEMPT"] = str(self.attempt)
            env["BIGDL_TORCH_ELASTIC_PREEMPTIONS"] = str(self.preemptions)
            if self.autoscaler is not None:
                # the world-size contract: the child sizes its mesh
                # from this (and the topology-tagged checkpoint makes
                # the resume re-partition to match)
                env["BIGDL_TORCH_AUTOSCALE_WORLD"] = str(self.autoscaler.world)
            # hang watchdog / policy loop on an ephemeral child port:
            # the child must tell the supervisor where it bound, so
            # inject a per-launch port file when the launcher didn't
            if (self.hang_timeout > 0 or self.autoscaler is not None) \
                    and env.get("BIGDL_TORCH_OBS_PORT") == "0" \
                    and not env.get("BIGDL_TORCH_OBS_PORT_FILE"):
                env["BIGDL_TORCH_OBS_PORT_FILE"] = os.path.join(
                    tempfile.gettempdir(),
                    f"bigdl-obs-port.{os.getpid()}.a{self.attempt}")
            pf = env.get("BIGDL_TORCH_OBS_PORT_FILE")
            if pf:
                try:  # a stale file from a dead launch must not
                    os.unlink(pf)  # point the watchdog at a ghost port
                except OSError:
                    pass
            log.info("supervisor: launch %d (preemptions so far: %d): %s",
                     self.attempt, self.preemptions, " ".join(self.cmd))
            self._hang_detected = False
            rc = self._runner(self.cmd, env)
            hung = self._hang_detected
            resize = self._resize_decision
            self._resize_decision = None
            self.attempt += 1
            if rc == 0:
                log.info("supervisor: command completed cleanly")
                self._event("elastic.supervisor_done", attempts=self.attempt)
                return 0
            if self._terminated:
                # the supervisor itself is being evicted: the child's
                # graceful exit code is the truth to report upward
                log.warning("supervisor: stopping after its own signal; "
                            "child exited %d", rc)
                return rc
            if resize is not None:
                # the supervisor stopped this child itself to execute a
                # resize — the exit code says nothing (usually
                # EXIT_PREEMPTED from the graceful path; a child that
                # was ALREADY preempting when the decision landed exits
                # the same way and is handled identically).  Restart at
                # the new world, free of the retry budget, paced by the
                # resize backoff policy.
                self.resizes += 1
                self.autoscaler.commit(resize)
                log.warning("supervisor: resize %s executed (%s) — "
                            "relaunching at world %d (child rc %d)",
                            resize.resize, resize.reason,
                            self.autoscaler.world, rc)
                self._event("elastic.restart", kind="resize", rc=rc,
                            attempt=self.attempt,
                            direction=resize.direction,
                            reason=resize.reason,
                            old_world=resize.old_world,
                            new_world=resize.new_world)
                self._count_restart("resize")
                delay = self._resize_policy.record_failure() or 0.0
                self._backoff_sleep("resize", rc, delay)
                continue
            if rc == EXIT_PREEMPTED and not hung:
                self.preemptions += 1
                self._event("elastic.restart", kind="preempted", rc=rc,
                            attempt=self.attempt,
                            preemptions=self.preemptions)
                self._count_restart("preempted")
                if self.preemptions > self.max_preemptions:
                    log.error("supervisor: %d preemptions exceeds "
                              "--max-preemptions=%d; giving up",
                              self.preemptions, self.max_preemptions)
                    return rc
                log.warning("supervisor: child preempted (rc %d) — "
                            "resuming from the latest checkpoint "
                            "(no retry budget consumed)", rc)
                continue
            if rc in self.fatal_codes and not hung:
                log.error("supervisor: child exited %d (fatal — "
                          "restarting cannot help)", rc)
                self._event("elastic.supervisor_fatal", rc=rc,
                            attempt=self.attempt)
                return rc
            # a hang-killed child is transient BY CLASSIFICATION — the
            # watchdog produced the exit code, so the code itself says
            # nothing; it restarts under the same retry budget
            kind = "hang" if hung else "transient"
            if hung:
                self.hangs += 1
            self._maybe_bundle(kind, rc)
            delay = self.policy.record_failure()
            self._event("elastic.restart", kind=kind, rc=rc,
                        attempt=self.attempt,
                        delay_s=None if delay is None else round(delay, 3))
            self._count_restart(kind)
            if delay is None:
                log.error("supervisor: retry budget exhausted after %d "
                          "%s failures; giving up with rc %d",
                          self.policy.attempts, kind, rc)
                return rc
            log.warning("supervisor: child exited %d (%s) — "
                        "restart %d/%d in %.2fs", rc, kind,
                        self.policy.attempts, self.policy.max_retries,
                        delay)
            self._backoff_sleep(kind, rc, delay)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.resilience.supervisor",
        description="Run a training command in a classify-and-restart "
                    "loop: preempted (rc %d) restarts free, transient "
                    "restarts under the retry budget, fatal (rc %d) "
                    "stops." % (EXIT_PREEMPTED, EXIT_FATAL))
    ap.add_argument("--max-retries", type=int, default=5,
                    help="transient-restart attempt cap (default 5)")
    ap.add_argument("--max-preemptions", type=int, default=1000,
                    help="preemption-restart cap (default 1000)")
    ap.add_argument("--hang-timeout", type=float, default=None,
                    help="kill+restart a child whose /healthz step "
                         "stamp stops advancing for this many seconds "
                         "(default BIGDL_TORCH_HANG_TIMEOUT; needs "
                         "BIGDL_TORCH_OBS_PORT on the child)")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable the autoscaling policy loop "
                         "(resilience/autoscale.py) even when "
                         "BIGDL_TORCH_AUTOSCALE is unset; rules/bands come "
                         "from the BIGDL_TORCH_AUTOSCALE_* knobs, the child "
                         "endpoint from BIGDL_TORCH_OBS_PORT(_FILE)/"
                         "BIGDL_TORCH_OBS_PEERS, and the chosen world is "
                         "exported as BIGDL_TORCH_AUTOSCALE_WORLD")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="training command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given; usage: ... -- python train.py")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from bigdl_tpu_torch.config import refresh_from_env

    autoscaler = None
    if args.autoscale or refresh_from_env().autoscale.enabled:
        from bigdl_tpu_torch.resilience.autoscale import AutoscaleController

        autoscaler = AutoscaleController.from_config()
    sup = Supervisor(cmd, max_retries=args.max_retries,
                     max_preemptions=args.max_preemptions,
                     hang_timeout=args.hang_timeout,
                     autoscaler=autoscaler)
    sup.install_signal_forwarding()
    try:
        return sup.run()
    finally:
        from bigdl_tpu_torch import obs

        if obs.active():
            obs.flush()


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["HangWatchdog", "Supervisor", "main"]
