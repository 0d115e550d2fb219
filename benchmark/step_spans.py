"""The training step's named regions in a profiled stretch
(``harness.Profile``): the device's idle time while the host is inside
them, and the kernel launches the host makes inside them.

The trainer opens, inside each ``step_dispatch``, the regions
``step.forward``, ``step.backward``, ``step.clip``, ``step.update``,
``step.guard`` and ``step.write`` (``optim/optimizer.py``); they reach
the profile as host operations on the clock of the device's kernels.
A stretch is read only when it holds exactly ``profile_steps`` complete
``step_dispatch`` and ``step.update`` regions and some device operation:
a program without the regions, or a stretch cut mid-step, reads None.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

DISPATCH = "step_dispatch"
FORWARD = ("step.forward",)
BACKWARD = ("step.backward",)
UPDATE = ("step.clip", "step.update", "step.guard", "step.write")
# the launch calls of the CUDA runtime (cudaLaunchKernel) and of the
# lower-level API (cuLaunchKernel), with their Ex forms and
# per-thread-stream or versioned suffixes
LAUNCH = re.compile(r"^cu(da)?LaunchKernel(Ex(C)?)?(_\w+)?$")


def union(intervals) -> List[list]:
    """The union of (start, end) intervals, as sorted disjoint [s, e]."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a: List[list], b: List[list]) -> float:
    """The length of the intersection of two disjoint sorted unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Stretch:
    """One profiled stretch's regions (host intervals by name, in the
    profile's microseconds) and the device's busy union."""

    def __init__(self, profile, steps: int):
        self.profile = profile
        self.steps = steps
        self.window_us = profile.window_s * 1e6
        self.regions: Dict[str, list] = {}
        for name, s, e in profile.host_ops:
            self.regions.setdefault(name, []).append((s, e))
        self.busy = union((s, e) for _, s, e in profile.device_ops)

    def inside(self, names) -> List[list]:
        return union(iv for n in names for iv in self.regions.get(n, ()))

    def idle_us(self, names) -> float:
        """Device idle time while the host is inside any of ``names``."""
        host = self.inside(names)
        return sum(e - s for s, e in host) - overlap(host, self.busy)

    def idle_share(self, names) -> float:
        """That idle time over the stretch, in %."""
        return 100.0 * self.idle_us(names) / self.window_us

    def outside_dispatch_share(self) -> float:
        """Device idle time while the host is outside every
        ``step_dispatch``, over the stretch, in %: the stretch's idle
        time less that inside the regions."""
        busy = sum(e - s for s, e in self.busy)
        idle = self.window_us - busy - self.idle_us((DISPATCH,))
        return 100.0 * idle / self.window_us

    def launches(self, names) -> float:
        """Host kernel-launch calls that start inside any of ``names``,
        a step."""
        host = self.inside(names)
        starts = sorted(s for n, s, _ in self.profile.host_ops
                        if LAUNCH.match(n))
        count, j = 0, 0
        for s, e in host:
            while j < len(starts) and starts[j] < s:
                j += 1
            while j < len(starts) and starts[j] <= e:
                count += 1
                j += 1
        return count / self.steps


def stretch(run) -> Optional[Stretch]:
    """The run's profiled stretch, or None when it holds no device
    operation or not exactly ``profile_steps`` complete ``step_dispatch``
    and ``step.update`` regions."""
    p = run.profile
    if p is None or not p.device_ops or p.window_s <= 0:
        return None
    steps = int(run.record.get("profile_steps", 0))
    out = Stretch(p, steps)
    if steps <= 0 or any(len(out.regions.get(n, ())) != steps
                         for n in (DISPATCH, "step.update")):
        return None
    return out
