"""Share of the profiled stretch in which the device is idle while the
host is inside the trainer's ``step.backward`` regions (autograd over
``nn/`` and the ops' backward, the zero-fill, the frozen mask), in the
stretch of ``device_idle``."""

from benchmark import step_spans


def read(run):
    s = step_spans.stretch(run)
    return None if s is None else s.idle_share(step_spans.BACKWARD)
