"""Share of the profiled stretch in which the device is idle while the
host is outside every ``step_dispatch`` (the trainer's loop: the batch
copy, the loss read, the triggers), in the stretch of ``device_idle``:
that metric less the idle time inside ``step_dispatch``.  With
``forward_idle``, ``backward_idle`` and ``update_idle`` it accounts for
``device_idle`` but for the idle time inside ``step_dispatch`` and
outside the step's regions."""

from benchmark import step_spans


def read(run):
    s = step_spans.stretch(run)
    return None if s is None else s.outside_dispatch_share()
