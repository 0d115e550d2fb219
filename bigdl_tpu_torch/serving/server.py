"""HTTP front end of the serving tier, stdlib only.

Counterpart of ``bigdl_tpu/serving/server.py`` (:45-243).  One
``ThreadingHTTPServer`` in front of an :class:`LMEngine` and/or a
:class:`ClassifierEngine`:

* ``POST /v1/generate`` ``{"prompt": [ids], "max_new_tokens": N,
  "temperature": t, "request_id": id}`` -> ``{"id", "tokens",
  "prompt_len", "ttft_s", "e2e_s"}``, blocking until the request is
  done (each client connection holds one handler thread).  A request a
  drain checkpointed answers 503 + ``Retry-After`` with its handoff
  record under ``"handoff"``;
* ``POST /v1/classify`` ``{"inputs": [[...], ...]}`` ->
  ``{"outputs": [[...]], "classes": [...]}`` (0-based argmax);
* ``POST /admin/drain`` ``{"deadline_s": s}`` -> ``{"handoffs": [...],
  "draining": true}``;
* ``GET /stats`` -> both engines' ``stats()``;
* ``GET /healthz`` -> ``{"status": "ok"}`` with the LM engine's
  ``weight_version`` and ``manifest_sha``.

Backpressure is explicit: a queue still full after the request timeout,
or a draining engine, answers 503 + ``Retry-After``
(``BIGDL_TORCH_SERVE_RETRY_AFTER`` seconds) and counts
``bigdl_serve_rejects_total``; a malformed payload gets 400 and a fault
of the server 500.  Port 0 binds an ephemeral port (``.port`` has the
real one).  A ``/v1/generate`` call's ``X-Bigdl-Trace`` header rides
the request into a drain's handoff record.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.config import ServeConfig
from bigdl_tpu_torch.obs import names, reqtrace
from bigdl_tpu_torch.serving.drain import HANDOFF_ERROR

log = logging.getLogger("bigdl_tpu_torch.serving")


class ServingServer:
    """The HTTP front end; serves from construction until ``close()``."""

    def __init__(self, lm=None, classifier=None, *,
                 port: Optional[int] = None, host: str = "127.0.0.1",
                 request_timeout_s: float = 60.0):
        cfg = ServeConfig.from_env()
        if port is None:
            port = cfg.port if cfg.port is not None else 0
        self.lm = lm
        self.classifier = classifier
        self.request_timeout_s = float(request_timeout_s)
        self.retry_after_s = float(cfg.retry_after_s)
        self._rejects = obs.get_registry().counter(
            names.SERVE_REJECTS_TOTAL,
            "Admissions rejected 503 + Retry-After (queue full past "
            "the admission timeout, or the engine is draining)")
        outer = self
        retry_after = {"Retry-After": f"{max(1, round(self.retry_after_s))}"}

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003
                log.debug("serving: " + fmt, *args)

            def _send(self, obj, code=200, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reject(self, reason):
                outer._rejects.inc()
                body = {"error": reason,
                        "retry_after_s": outer.retry_after_s}
                if outer.lm is not None:
                    body["engine"] = {
                        "queue_depth": outer.lm.queue.depth(),
                        "draining": bool(outer.lm.draining)}
                return self._send(body, 503, headers=retry_after)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    body = {"status": "ok"}
                    if outer.lm is not None:
                        body["weight_version"] = outer.lm.weight_version
                        body["manifest_sha"] = outer.lm.manifest_sha
                    return self._send(body)
                if self.path == "/stats":
                    return self._send({
                        "lm": outer.lm.stats() if outer.lm else None,
                        "classifier": (outer.classifier.stats()
                                       if outer.classifier else None)})
                return self._send({"error": "not found"}, 404)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def do_POST(self):  # noqa: N802
                try:
                    payload = self._body()
                    if self.path == "/v1/generate":
                        return self._generate(payload)
                    if self.path == "/v1/classify":
                        return self._classify(payload)
                    if self.path == "/admin/drain":
                        return self._drain(payload)
                    return self._send({"error": "not found"}, 404)
                except TimeoutError as e:
                    # queue full past the timeout: overload, not a
                    # client error; the client backs off
                    return self._reject(f"overloaded: {e}")
                except RuntimeError as e:
                    # draining, or a closed queue: admissions refused
                    return self._reject(str(e))
                except (KeyError, TypeError, ValueError) as e:
                    return self._send(
                        {"error": f"{type(e).__name__}: {e}"}, 400)
                except Exception as e:  # noqa: BLE001 — a server fault
                    log.exception("serving: %s failed", self.path)
                    return self._send(
                        {"error": f"{type(e).__name__}: {e}"}, 500)

            def _generate(self, payload):
                if outer.lm is None:
                    return self._reject("no LM engine")
                ctx = reqtrace.RequestTraceContext.from_header(
                    self.headers.get(reqtrace.TRACE_HEADER))
                req = outer.lm.submit(
                    payload["prompt"],
                    int(payload.get("max_new_tokens", 16)),
                    temperature=float(payload.get("temperature", 0.0)),
                    timeout=outer.request_timeout_s, trace=ctx)
                req.router_id = payload.get("request_id")
                req.wait(outer.request_timeout_s)
                if req.error == HANDOFF_ERROR:
                    # checkpointed by a drain: hand the resume point
                    # back so that it is replayed elsewhere exactly once
                    outer._rejects.inc()
                    return self._send(
                        {"error": "draining", "handoff": {
                            "prompt": [int(t) for t in req.payload],
                            "max_new_tokens": int(req.max_new_tokens),
                            "temperature": float(req.temperature),
                            "tokens_done": [int(t) for t in req.tokens],
                            "request_id": req.router_id,
                            "trace": (req.trace.to_header()
                                      if req.trace is not None else None),
                            "weight_version": outer.lm.weight_version}},
                        503, headers=retry_after)
                if req.error:
                    return self._send({"error": req.error}, 500)
                return self._send({
                    "id": req.id, "tokens": [int(t) for t in req.tokens],
                    "prompt_len": len(payload["prompt"]),
                    "ttft_s": req.ttft_s, "e2e_s": req.e2e_s})

            def _drain(self, payload):
                if outer.lm is None:
                    return self._send({"error": "no LM engine"}, 503)
                records = outer.lm.drain(
                    float(payload.get("deadline_s", 10.0)))
                return self._send(
                    {"handoffs": [hd.to_dict() for hd in records],
                     "draining": True})

            def _classify(self, payload):
                if outer.classifier is None:
                    return self._send(
                        {"error": "no classifier engine"}, 503)
                x = np.asarray(payload["inputs"], np.float32)
                reqs = [outer.classifier.submit(
                    row, timeout=outer.request_timeout_s) for row in x]
                outs = []
                for r in reqs:
                    r.wait(outer.request_timeout_s)
                    if r.error:
                        return self._send({"error": r.error}, 500)
                    outs.append(np.asarray(r.result))
                out = np.stack(outs)
                return self._send({
                    "outputs": out.tolist(),
                    "classes": np.argmax(
                        out.reshape(out.shape[0], -1), axis=-1).tolist()})

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="bigdl-torch-serving-http", daemon=True)
        self._thread.start()
        log.info("serving front end on %s:%d", host, self.port)

    def url(self, path: str = "/stats") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self):
        """Stop serving and free the port (the engines stay open)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


__all__ = ["ServingServer"]
