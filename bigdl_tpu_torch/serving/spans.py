"""Span and event names of the serving data plane.

Counterpart of ``bigdl_tpu/serving/spans.py``, with the same strings,
so that one trace reader follows either package.  Every span or event
the serving tier emits through the tracer or the request-trace
collector is named here once; mint sites use these constants, never
string literals, so a typo is an AttributeError rather than a forked
timeline.

* ``SPAN_*``: the per-request hops of a request trace
  (``obs/reqtrace.py``); one kept trace is a set of these spans sharing
  a trace id;
* ``SPAN_STEP_DECODE``: a live tracer span around each batched decode
  step;
* ``EVENT_*``: point events the engine and the rollout stamp.
"""

from __future__ import annotations

# ---------------------------------------------------- request-trace hops
#: the whole routed request, router side (placement to final answer)
SPAN_ROUTE = "req.route"
#: one placement decision
SPAN_PLACEMENT = "req.placement"
#: one budget-gated retry: the backoff before re-placement
SPAN_RETRY = "req.retry"
#: a drain handoff being absorbed
SPAN_HANDOFF = "req.handoff"
#: submit to first slot admission
SPAN_QUEUE = "req.queue"
#: one prefill forward (per admission)
SPAN_PREFILL = "req.prefill"
#: a preemption: pages lost to the next admission
SPAN_PREEMPT = "req.preempt"
#: the engine's e2e less queue, prefill and preempt (the remainder, so
#: the four partition the engine's e2e exactly)
SPAN_DECODE = "req.decode"

#: the hop keys a report attributes, in render order
HOP_ORDER = ("queue", "placement", "retry", "prefill", "decode",
             "preempt", "handoff", "route")

# ----------------------------------------------------------- live phases
#: one batched decode step, dispatch to resolved next tokens
SPAN_STEP_DECODE = "serve.decode_step"

# ------------------------------------------------------------ point events
#: a request entered a decode slot
EVENT_ADMIT = "serve.admit"
#: a request was preempted off its slot
EVENT_PREEMPT = "serve.preempt"
#: one chaos-scenario verdict (the JAX package's simulator)
EVENT_SCENARIO = "serve.scenario"
#: a live weight hot swap completed
EVENT_WEIGHT_SWAP = "serve.weight_swap"
#: the rollout watcher refused a published checkpoint
EVENT_ROLLOUT_REJECT = "rollout.reject"
#: one canary decision (canary / promote / rollback)
EVENT_ROLLOUT_DECISION = "rollout.decision"


def hop_key(span_name: str) -> str:
    """The attribution key of a request-trace span name (``"req.prefill"``
    -> ``"prefill"``; other names pass through)."""
    return span_name[4:] if span_name.startswith("req.") else span_name


__all__ = ["SPAN_ROUTE", "SPAN_PLACEMENT", "SPAN_RETRY", "SPAN_HANDOFF",
           "SPAN_QUEUE", "SPAN_PREFILL", "SPAN_PREEMPT", "SPAN_DECODE",
           "SPAN_STEP_DECODE", "HOP_ORDER", "EVENT_ADMIT",
           "EVENT_PREEMPT", "EVENT_SCENARIO", "EVENT_WEIGHT_SWAP",
           "EVENT_ROLLOUT_REJECT", "EVENT_ROLLOUT_DECISION", "hop_key"]
