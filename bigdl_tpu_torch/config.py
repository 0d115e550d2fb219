"""Knobs of the PyTorch/CUDA port, read from ``BIGDL_TORCH_*``.

Counterpart of the ``ServeConfig`` section of ``bigdl_tpu/config.py``
(the serving defaults ``LMEngine``, ``ClassifierEngine`` and
``ServingServer`` read, with the router's 503 ``Retry-After``) and of
its training knobs (``TrainConfig``: the non-finite guard, the retry backoff, checkpoint
retention, the gradient wire and the input feed, read by the
trainers).  Constructor
arguments win; these are the process-wide fallbacks a deployment sets
once.
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
    retention and wire knobs."""

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
    # reduce-scatter), "float32" or "none" [BIGDL_TORCH_WIRE_DTYPE]
    wire_dtype: str = "bfloat16"

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
        )


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


__all__ = ["ServeConfig", "TrainConfig", "build_dir", "nvcc_path"]
