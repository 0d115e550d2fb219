"""Share of the profiled stretch in which the device is idle while the
host is inside the trainer's ``step.forward`` regions (the BN state
read, the bf16 casts, the forward and the loss: ``nn/`` and
``optim/optimizer.py`` ``_output``), in the stretch of
``device_idle``."""

from benchmark import step_spans


def read(run):
    s = step_spans.stretch(run)
    return None if s is None else s.idle_share(step_spans.FORWARD)
