"""Share of the profiled stretch in which no operation ran on the device
(1 - the union of the device's intervals over the stretch)."""


def read(run):
    p = run.profile
    if p is None or not p.device_ops or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
