"""Host time of the trainer's step call (autograd, the clip, the update
and the guard queued on the device) a step, mean over the window's
steps; timed by the benchmark around ``LocalOptimizer``'s step."""


def read(run):
    d = run.record.get("dispatch_s")
    return 1e3 * sum(d) / len(d) if d else None
