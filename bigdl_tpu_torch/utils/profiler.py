"""Device traces on ``torch.profiler``, and named regions inside them.

Counterpart of ``bigdl_tpu/utils/profiler.py``, which traces with
``jax.profiler``.  Here a trace captures the host's operators and, on
the card, the CUDA runtime calls and kernels (CUPTI), and is written by
``tensorboard_trace_handler`` as ``<host>_<pid>.<ts>.pt.trace.json``: a
Chrome trace that TensorBoard's profiler plugin and Perfetto read (JAX
writes XPlane protobufs).

    from bigdl_tpu_torch.utils.profiler import trace, annotate

    with trace("/tmp/tb"):               # host + device trace
        optimizer.optimize()

    with annotate("my-phase"):           # named region inside a trace
        ...

``BIGDL_TORCH_PROFILE=/dir`` makes the trainers trace iterations
``[1, 21)`` (:class:`StepProfiler`; the first, which builds the
kernels and picks cuDNN's plans, is left out).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

PROFILE_STEPS = 20


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _profile(log_dir: str):
    """A ``torch.profiler.profile`` that writes its trace into
    ``log_dir`` when it stops."""
    from torch.profiler import profile, tensorboard_trace_handler

    return profile(activities=_activities(),
                   on_trace_ready=tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block into ``log_dir`` (CPU, and CUDA where there is a
    card)."""
    prof = _profile(log_dir)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


class _AnnotatedRegion:
    """One region, two sinks under one name: a
    ``torch.profiler.record_function`` (the trace's timeline) while a
    profiler is recording, and an obs tracer span (the JSONL and Chrome
    export) while ``BIGDL_TORCH_TRACE_DIR`` is set.  Neither: nothing
    is opened."""

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._rf = None
        self._span = None

    def __enter__(self):
        import torch

        from bigdl_tpu_torch import obs

        tracer = obs.get_tracer()
        if tracer.enabled:
            self._span = tracer.span(self.name, **self.attrs)
            self._span.__enter__()
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._span is not None:
            self._span.__exit__(*exc)
            self._span = None
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _AnnotatedRegion(self.name, self.attrs):
                return fn(*args, **kwargs)

        return wrapped


def annotate(name: str, **attrs):
    """A named region, as a context manager or a decorator: on the
    ``torch.profiler`` timeline when a trace is recording, and an obs
    tracer span with ``attrs`` when the tracer is on."""
    return _AnnotatedRegion(name, attrs)


class StepProfiler:
    """The trainers' hook: traces iterations ``[skip, skip + steps)`` of
    a run into ``log_dir`` (default ``BIGDL_TORCH_PROFILE``; unset: off).
    :meth:`step` is called once an iteration, after the batch is on the
    device; :meth:`stop` ends a trace still recording (the trainers
    call it in a ``finally``, so a retry never finds one running)."""

    def __init__(self, log_dir: Optional[str] = None, skip: int = 1,
                 steps: int = PROFILE_STEPS):
        from bigdl_tpu_torch.config import HostConfig

        self.log_dir = log_dir or HostConfig.from_env().profile_dir
        self.skip = skip
        self.steps = steps
        self._n = 0
        self._prof = None

    @property
    def enabled(self) -> bool:
        return self.log_dir is not None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self):
        if not self.enabled:
            return
        if self._n == self.skip:
            self._prof = _profile(self.log_dir)
            self._prof.start()
        elif self._n == self.skip + self.steps:
            self.stop()
        self._n += 1

    def stop(self):
        if self._prof is not None:
            import torch

            prof, self._prof = self._prof, None
            if torch.cuda.is_available():
                # the traced steps' kernels finish inside the trace
                torch.cuda.synchronize()
            prof.stop()


__all__ = ["PROFILE_STEPS", "trace", "annotate", "StepProfiler"]
