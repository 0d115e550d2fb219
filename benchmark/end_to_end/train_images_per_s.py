"""Images trained over the whole window: every step dispatched in it,
over the time from its synchronised start to its synchronised end."""


def read(run):
    return run.record["samples"] / run.record["window_s"]
