"""Micro-batching classifier serving: the stateless half of the tier.

Counterpart of ``bigdl_tpu/serving/classifier.py`` (:29-155).  A
classifier (ResNet, an MLP, any module) has no KV state, so serving it
is dynamic batching: requests queue through the same
:class:`~bigdl_tpu_torch.serving.batcher.RequestQueue`, ``pump`` takes
up to ``max_batch`` of them (waiting at most ``batch_window_s`` for
stragglers), pads the batch to ``max_batch`` rows with copies of row 0
(the JAX package's static batch), runs one eval forward under
``torch.no_grad()`` on ``device`` and fans the rows back out.  A batch
whose forward raises fails its requests with the error and the loop
goes on, as in JAX.

``int8=True`` serves the module's ``nn.quantized.quantize()`` twin:
per-channel int8 Linear and conv layers, eval-mode BN folded into the
fused convs.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.config import ServeConfig
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.serving.batcher import RequestQueue, ServeRequest
from bigdl_tpu_torch.serving.engine import LAT_META


class ClassifierEngine:
    """Dynamic-batching inference over one module.  ``device`` defaults
    to the card (raises without CUDA unless ``device="cpu"``); the
    module is moved there."""

    def __init__(self, module, *, max_batch: Optional[int] = None,
                 int8: Optional[bool] = None,
                 batch_window_s: float = 0.002,
                 queue_capacity: Optional[int] = None, device="cuda"):
        cfg = ServeConfig.from_env()
        self.device = resolve_device(device)
        self.int8 = cfg.int8 if int8 is None else bool(int8)
        module = module.to(self.device)
        if self.int8:
            from bigdl_tpu_torch.nn.quantized import quantize

            module = quantize(module)
        self.module = module.evaluate()
        self.max_batch = int(max_batch or cfg.max_batch)
        self.batch_window_s = float(batch_window_s)
        self.queue = RequestQueue(queue_capacity or cfg.queue_capacity)
        self._steps = 0
        self._occ_sum = 0.0
        self.completed = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        reg = obs.get_registry()
        self._lat = reg.histogram(*LAT_META, labels=("engine", "kind"))
        self._req_counter = reg.counter(
            names.SERVE_REQUESTS_TOTAL,
            "Requests completed, by engine and status",
            labels=("engine", "status"))
        self._occ_gauge = reg.gauge(
            names.SERVE_BATCH_OCCUPANCY,
            "Mean fraction of decode slots occupied per step")

    def submit(self, features,
               timeout: Optional[float] = None) -> ServeRequest:
        req = ServeRequest(payload=np.asarray(features, np.float32))
        return self.queue.submit(req, timeout=timeout)

    @torch.no_grad()
    def _forward(self, batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(batch).to(self.device)
        return self.module(x).float().cpu().numpy()

    def pump(self, wait_s: float = 0.01) -> bool:
        """Serve one micro-batch; True when anything was served."""
        reqs = self.queue.take(self.max_batch, timeout=wait_s)
        if not reqs:
            return False
        if len(reqs) < self.max_batch and self.batch_window_s > 0:
            deadline = time.monotonic() + self.batch_window_s
            while len(reqs) < self.max_batch \
                    and time.monotonic() < deadline:
                more = self.queue.take(self.max_batch - len(reqs),
                                       timeout=0.001)
                if not more:
                    break
                reqs.extend(more)
        n = len(reqs)
        batch = np.stack([r.payload for r in reqs])
        if n < self.max_batch:
            # pad to the static batch with copies of row 0
            pad = np.broadcast_to(
                batch[:1], (self.max_batch - n,) + batch.shape[1:])
            batch = np.concatenate([batch, pad], axis=0)
        try:
            out = self._forward(batch)
            err = None
        except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
            out, err = None, f"{type(e).__name__}: {e}"
        self._steps += 1
        self._occ_sum += n / self.max_batch
        self._occ_gauge.set(self._occ_sum / self._steps)
        for i, req in enumerate(reqs):
            if err is None:
                req.result = out[i]
            req.finish(err)
            self._lat.labels(engine="classifier", kind="e2e").observe(
                req.e2e_s)
            self._req_counter.labels(
                engine="classifier",
                status="error" if err else "ok").inc()
            self.completed += 1
        return True

    def start(self):
        """Drive the engine on a background thread until close()."""
        if self._thread is not None:
            return self
        self._stop = False

        def loop():
            while not self._stop:
                if not self.pump(wait_s=0.02):
                    time.sleep(0.002)

        self._thread = threading.Thread(
            target=loop, name="bigdl-torch-serve-classifier", daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.queue.close()

    def stats(self) -> dict:
        return {
            "requests": self.completed,
            "batches": self._steps,
            "occupancy_mean": (self._occ_sum / self._steps
                               if self._steps else None),
            "queue_depth": self.queue.depth(),
            "int8": self.int8,
        }


__all__ = ["ClassifierEngine"]
