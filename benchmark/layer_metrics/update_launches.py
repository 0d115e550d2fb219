"""Host kernel-launch calls (``cudaLaunchKernel``, ``cuLaunchKernel``
and their ``Ex`` forms) that start inside the trainer's ``step.clip``,
``step.update``, ``step.guard`` and ``step.write`` regions, a profiled
step."""

from benchmark import step_spans


def read(run):
    s = step_spans.stretch(run)
    return None if s is None else s.launches(step_spans.UPDATE)
