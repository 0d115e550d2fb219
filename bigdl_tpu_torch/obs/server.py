"""Live telemetry endpoint: ``/metrics``, ``/healthz``, ``/trace``,
``/profilez`` and ``/debugz``.

Counterpart of ``bigdl_tpu/obs/server.py`` (:62-386): one stdlib HTTP
server a process, on a daemon thread, serving

* ``GET /metrics``: the Prometheus text of the process registry and of
  every registry registered with :func:`register_registry` (held by
  weak reference);
* ``GET /healthz``: JSON liveness: the server's port and uptime, the
  newest trained step (:func:`note_step`, stamped by both trainers
  each resolved step) and its age, ``status`` ``"idle"`` before the
  first step, ``"ok"`` after, ``"stalled"`` once the stamp is older
  than ``BIGDL_TORCH_HANG_TIMEOUT`` (JAX :157-200), the launch's
  ``attempt`` (``BIGDL_TORCH_ELASTIC_ATTEMPT``, exported by the restart
  supervisor), the goodput ledger's live ratio, the firing alerts, the
  heartbeat monitor's peer ages, the profiler's overhead ratio and the
  debug bundles written;
* ``GET /trace?last=K``: the newest K records of the tracer's flight
  recorder (``[]`` with tracing off); ``GET /trace?request=ID``: one
  kept request trace by trace id or request id, 404 when the tail
  sampler dropped it;
* ``GET /profilez``: the sampling profiler's snapshot
  (``?format=collapsed`` for the folded-stack text);
* ``GET /debugz``: write one debug bundle now (``BIGDL_TORCH_BUNDLE_DIR``)
  and answer it with the bundle inventory, 503 without a directory;
* ``GET /``: the endpoint list.

``BIGDL_TORCH_OBS_PORT`` turns it on through :func:`ensure_server`
(0 binds an ephemeral port, ``.port`` has the real one); unset, the
module holds no thread and no socket.
"""

from __future__ import annotations

import atexit
import http.server
import json
import logging
import os
import threading
import time
import urllib.parse
import weakref
from typing import List, Optional

log = logging.getLogger("bigdl_tpu_torch.obs")

_lock = threading.Lock()
_server: Optional["ObsServer"] = None
_server_key = None
_atexit_registered = False
# extra /metrics providers, by weak reference
_extras: List = []

# the step stamp: (step, wall time), one tuple rebind a resolved step
_step_stamp = (None, None)


def note_step(step: int):
    """Stamp one resolved training step (both trainers, and a resume
    re-stamps the restored step so a rewound counter is no stall)."""
    global _step_stamp
    _step_stamp = (int(step), time.time())


def last_step():
    """``(step, wall time)`` of the newest stamp, ``(None, None)``
    before the first."""
    return _step_stamp


def clear_step():
    """Drop the stamp (the tests' hook)."""
    global _step_stamp
    _step_stamp = (None, None)


def register_registry(registry):
    """Add a ``/metrics`` provider (anything with ``to_prometheus()``),
    held by weak reference."""
    with _lock:
        _extras[:] = [r for r in _extras if r() is not None]
        if not any(r() is registry for r in _extras):
            _extras.append(weakref.ref(registry))


def _extra_registries():
    with _lock:
        return [r() for r in _extras if r() is not None]


def metrics_text() -> str:
    """What ``/metrics`` serves: the process registry, then each extra
    provider; a failing provider costs its own section only."""
    from bigdl_tpu_torch import obs

    parts = [obs.get_registry().to_prometheus()]
    for r in _extra_registries():
        try:
            parts.append(r.to_prometheus())
        except Exception:  # noqa: BLE001 — isolate provider failures
            log.exception("obs.server: /metrics provider %r failed", r)
    return "".join(parts)


def trace_tail(last: int = 64) -> list:
    """The newest ``last`` flight-recorder records (``[]`` with tracing
    off)."""
    from bigdl_tpu_torch import obs

    recent = obs.get_tracer().recent()
    return recent[-max(1, int(last)):] if recent else []


def _rank() -> int:
    try:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_initialized() else 0
    except Exception:  # noqa: BLE001
        return 0


def _heartbeat_census() -> Optional[dict]:
    """Each peer's heartbeat age from the ``bigdl_heartbeat_age_seconds``
    gauges (None when no heartbeat monitor ran)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import names

    for fam in obs.get_registry().families():
        if fam.name == names.HEARTBEAT_AGE_SECONDS:
            census = {}
            for key, child in fam.child_items():
                labels = dict(zip(fam.labelnames, key))
                census[labels.get("host", "?")] = round(child.value, 3)
            return census or None
    return None


def _bundle_writes() -> int:
    """Debug bundles this process has written (JAX :144), summed over
    triggers; 0 before the first."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import names

    total = 0.0
    for fam in obs.get_registry().families():
        if fam.name == names.BUNDLE_WRITES_TOTAL:
            for _key, child in fam.child_items():
                total += child.value
    return int(total)


def health_payload() -> dict:
    """The ``/healthz`` body (callable directly)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.config import TrainConfig
    from bigdl_tpu_torch.obs import alerts, prof

    now = time.time()
    srv = _server
    step, stamped = _step_stamp
    ledger = obs.get_ledger()
    ratio = ledger.live_ratio() if ledger.enabled else None
    active_alerts = alerts.get_engine().active()
    prof_obj = prof.current()
    step_age = None if stamped is None else round(now - stamped, 3)
    status = "idle" if step is None else "ok"
    train = TrainConfig.from_env()
    if step_age is not None and train.hang_timeout > 0 \
            and step_age > train.hang_timeout:
        status = "stalled"
    return {
        "status": status,
        "host": _rank(),
        "pid": os.getpid(),
        "attempt": int(train.elastic_attempt),
        "time": now,
        "port": srv.port if srv is not None else None,
        "uptime_s": (round(now - srv.started, 3)
                     if srv is not None else None),
        "step": step,
        "step_age_s": step_age,
        "goodput_ratio": (None if ratio is None
                          else round(min(1.0, ratio), 6)),
        "alerts": active_alerts,
        "heartbeat": _heartbeat_census(),
        # None with the profiler off
        "prof_overhead": (round(prof_obj.overhead_ratio(), 6)
                          if prof_obj.enabled else None),
        "bundles": _bundle_writes(),
    }


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "bigdl-torch-obs/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        log.debug("obs.server: " + fmt, *args)

    def _send(self, code: int, body: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj, default=str).encode("utf-8"),
                   "application/json")

    def do_GET(self):  # noqa: N802 — stdlib spelling
        try:
            url = urllib.parse.urlsplit(self.path)
            q = urllib.parse.parse_qs(url.query)
            if url.path == "/metrics":
                self._send(200, metrics_text().encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/healthz":
                self._send_json(health_payload())
            elif url.path == "/trace":
                key = q.get("request", [None])[0]
                if key is None:
                    self._send_json(trace_tail(int(q.get("last",
                                                         ["64"])[0])))
                    return
                from bigdl_tpu_torch.obs import reqtrace

                entry = reqtrace.get_collector().find(key)
                if entry is None:
                    self._send_json(
                        {"error": f"no kept trace for {key!r} (dropped "
                                  "by the tail sampler, evicted from the "
                                  "ring, or never seen)"}, 404)
                else:
                    self._send_json(entry)
            elif url.path == "/profilez":
                from bigdl_tpu_torch.obs import prof

                if q.get("format", [None])[0] == "collapsed":
                    self._send(200, prof.current().render_collapsed()
                               .encode("utf-8"),
                               "text/plain; charset=utf-8")
                else:
                    self._send_json(prof.current().snapshot())
            elif url.path == "/debugz":
                # one bundle now, and the inventory; without a bundle
                # directory the build fails and the (empty) inventory
                # still answers
                from bigdl_tpu_torch.obs import bundle

                body = {"bundle": None, "error": None}
                try:
                    body["bundle"] = bundle.build_bundle(
                        reason="GET /debugz", trigger="http")
                except Exception as e:  # noqa: BLE001 — report, don't 500
                    body["error"] = f"{type(e).__name__}: {e}"
                body["inventory"] = bundle.inventory()
                self._send_json(body,
                                200 if body["error"] is None else 503)
            elif url.path == "/":
                self._send_json({"endpoints": ["/metrics", "/healthz",
                                               "/trace?last=K",
                                               "/trace?request=ID",
                                               "/profilez", "/debugz"]})
            else:
                self._send_json({"error": f"no route {url.path}"}, 404)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the scraper went away mid-answer
        except Exception as e:  # noqa: BLE001 — a scrape must not die ugly
            log.exception("obs.server: %s failed", self.path)
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"},
                                500)
            except OSError:
                pass


class ObsServer:
    """One endpoint: a ``ThreadingHTTPServer`` with daemon request
    threads, served from a daemon thread."""

    def __init__(self, port: int, host: str = "0.0.0.0",
                 port_file: Optional[str] = None):
        self.httpd = http.server.ThreadingHTTPServer((host, int(port)),
                                                     _Handler)
        self.httpd.daemon_threads = True
        self.port = int(self.httpd.server_address[1])
        self.port_file = port_file
        self.started = time.time()
        if port_file:
            tmp = port_file + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(str(self.port))
            os.replace(tmp, port_file)
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="bigdl-torch-obs-server", daemon=True)
        self._thread.start()
        log.info("obs.server: live telemetry on port %d", self.port)

    def url(self, path: str = "/healthz") -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def close(self):
        """Stop serving and free the socket (idempotent)."""
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)


def ensure_server() -> Optional[ObsServer]:
    """The process endpoint, built when ``BIGDL_TORCH_OBS_PORT`` is set,
    else None; rebuilt when the port knobs change.  A failed bind logs
    and leaves the endpoint off."""
    global _server, _server_key, _atexit_registered
    from bigdl_tpu_torch.config import ObsConfig

    cfg = ObsConfig.from_env()
    key = (cfg.obs_port, cfg.obs_port_file)
    with _lock:
        if key == _server_key:
            return _server
        if _server is not None:
            _server.close()
            _server = None
        _server_key = key
        if cfg.obs_port is not None:
            try:
                _server = ObsServer(cfg.obs_port,
                                    port_file=cfg.obs_port_file)
            except OSError as e:
                log.warning("obs.server: cannot bind port %s (%s)",
                            cfg.obs_port, e)
                _server = None
            if _server is not None and not _atexit_registered:
                atexit.register(stop_server)
                _atexit_registered = True
        return _server


def get_server() -> Optional[ObsServer]:
    """The running endpoint, if any (never builds one)."""
    return _server


def stop_server():
    """Tear the endpoint down; the next :func:`ensure_server` rebuilds
    it from the environment."""
    global _server, _server_key
    with _lock:
        if _server is not None:
            _server.close()
            _server = None
        _server_key = None


__all__ = ["ObsServer", "ensure_server", "get_server", "stop_server",
           "register_registry", "metrics_text", "trace_tail",
           "health_payload", "note_step", "last_step", "clear_step"]
