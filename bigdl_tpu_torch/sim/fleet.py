"""The synthetic fleet and its fetch router.

:class:`SimFleet` owns N :class:`~bigdl_tpu_torch.sim.host.SimHost`\\ s and
stands in for the HTTP transport between them and the real scrapers:
``fetch(url)`` is injected into the real
:class:`~bigdl_tpu_torch.obs.aggregate.FleetAggregator` /
:class:`~bigdl_tpu_torch.resilience.autoscale.EndpointScraper`, which then
exercise their genuine parse/degrade paths —

* a healthy host answers with its real ``/healthz`` JSON or
  ``/metrics`` Prometheus exposition;
* a **partitioned** host *times out*: the fetch blocks for
  ``partition_stall_s`` of real wall time before raising — the failure
  mode that makes a serial scrape of N peers cost N × timeout, which
  the bounded-pool concurrent scrape exists to fix (and the partition
  scenario measures);
* a **down** host (preempted / flap trough) refuses immediately.

``health_fetch`` is the dict-returning variant the supervisor's
:class:`~bigdl_tpu_torch.resilience.supervisor.HangWatchdog` injects.
"""

from __future__ import annotations

import json
import re
import time
from typing import List, Optional

from bigdl_tpu_torch.sim.host import SimHost

# the synthetic address space: "sim<host_id>:9000"
_URL_RE = re.compile(r"^https?://sim(\d+):\d+(/[a-z?=&0-9]*)$")


class SimFleet:
    """N synthetic hosts + the fetch router over them."""

    def __init__(self, n_hosts: int, clock, seed: int = 0,
                 alert_rules=None, alert_sink: Optional[str] = None,
                 partition_stall_s: float = 0.0, **host_kw):
        if n_hosts < 1:
            raise ValueError(f"need at least one host, got {n_hosts}")
        self.clock = clock
        self.partition_stall_s = float(partition_stall_s)
        self.hosts: List[SimHost] = [
            SimHost(i, clock, seed=seed, alert_rules=alert_rules,
                    alert_sink=alert_sink, **host_kw)
            for i in range(int(n_hosts))]

    # ------------------------------------------------------ addressing
    @property
    def addrs(self) -> List[str]:
        return [f"sim{h.host_id}:9000" for h in self.hosts]

    def _route(self, url: str):
        m = _URL_RE.match(url)
        if not m:
            raise ValueError(f"not a sim fleet url: {url!r}")
        host_id = int(m.group(1))
        if host_id >= len(self.hosts):
            raise ValueError(f"no sim host {host_id} (fleet of "
                             f"{len(self.hosts)})")
        return self.hosts[host_id], m.group(2)

    # --------------------------------------------------------- fetches
    def fetch(self, url: str) -> str:
        """The text-returning fetch the real scrapers inject.  Raises
        exactly the way a real transport fails: TimeoutError for a
        partitioned peer (after stalling ``partition_stall_s`` of real
        wall clock — the cost the concurrent scrape bounds),
        ConnectionRefusedError for a down one."""
        host, path = self._route(url)
        if host.partitioned:
            if self.partition_stall_s > 0:
                time.sleep(self.partition_stall_s)
            raise TimeoutError(
                f"simulated network partition: sim{host.host_id}")
        if not host.up:
            raise ConnectionRefusedError(
                f"simulated down host: sim{host.host_id}")
        if path == "/healthz":
            return json.dumps(host.health())
        if path == "/metrics":
            return host.metrics_text()
        raise ValueError(f"no sim route {path!r}")

    def health_fetch(self, url: str) -> Optional[dict]:
        """The dict-or-None fetch :class:`HangWatchdog` injects
        (unreachable reads as None — never as hung)."""
        try:
            return json.loads(self.fetch(url))
        except Exception:  # noqa: BLE001 — unreachable != hung
            return None

    def watchdog_fetch(self, host_id: int):
        """A watchdog fetch pinned to one host (the watchdog spells
        127.0.0.1 urls; this rewrites them onto the sim address
        space)."""
        def fetch(_url: str) -> Optional[dict]:
            return self.health_fetch(f"http://sim{int(host_id)}:9000"
                                     "/healthz")
        return fetch

    # --------------------------------------------------------- scenario
    def skew_clock(self, host_id: int, offset_s: float):
        """Skew one host's reported wall clock (multi-region NTP drift,
        a wedged timesync daemon): its ``/healthz`` ``time`` shifts by
        ``offset_s`` while the host otherwise behaves — exactly the
        insidious case the aggregator's staleness detection exists to
        exclude-and-account instead of folding into fleet percentiles."""
        self.hosts[int(host_id)].clock_skew_s = float(offset_s)

    def partition(self, host_id: int, on: bool = True):
        """Partition (or heal) one host — its fetches time out."""
        self.hosts[int(host_id)].partitioned = bool(on)

    # ------------------------------------------------------- lifecycle
    def tick(self, dt: float):
        for h in self.hosts:
            h.tick(dt)

    def evaluate_alerts(self) -> List[dict]:
        out = []
        for h in self.hosts:
            out.extend(h.evaluate_alerts())
        return out

    @property
    def up_count(self) -> int:
        return sum(1 for h in self.hosts if h.up)

    @property
    def transitions(self) -> List[dict]:
        out = []
        for h in self.hosts:
            out.extend(h.transitions)
        return out

    def __repr__(self) -> str:
        return (f"SimFleet({len(self.hosts)} hosts, {self.up_count} up, "
                f"t={self.clock.now():.1f})")
