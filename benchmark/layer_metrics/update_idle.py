"""Share of the profiled stretch in which the device is idle while the
host is inside the trainer's update: its ``step.clip``, ``step.update``,
``step.guard`` and ``step.write`` regions (``optim/optim_method.py``,
the clipper, the non-finite guard and the write-back), in the stretch
of ``device_idle``."""

from benchmark import step_spans


def read(run):
    s = step_spans.stretch(run)
    return None if s is None else s.idle_share(step_spans.UPDATE)
