"""Set-up: process start to the first timed step (loading, warming up
and, in a checkout's first run, building the kernels)."""


def read(run):
    return run.record["setup_s"]
