"""Share of the profiled stretch in which the device is idle while the
host is inside the MoE layer's regions (``parallel/moe.py``
``SigmoidMoE``: ``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.shared``, ``moe.combine``), in the stretch of ``device_idle``."""

from benchmark import step_spans

REGIONS = ("moe.route", "moe.dispatch", "moe.experts", "moe.shared",
           "moe.combine")


def read(run):
    s = step_spans.stretch(run)
    if s is None or not any(s.regions.get(n) for n in REGIONS):
        return None
    return s.idle_share(REGIONS)
