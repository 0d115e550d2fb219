"""Time the trainer waited for its input feed (``dataset/prefetch.py``),
a step, over the window: the trainer's own ``data wait time`` phase
timer, differenced over the window."""


def read(run):
    r = run.record
    if "data_wait_s" not in r or not r.get("steps"):
        return None
    return 1e3 * r["data_wait_s"] / r["steps"]
