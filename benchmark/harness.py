"""The harness: finds a cell's files by name, runs its driver once, reads
its metrics and decides ``correct``.

Everything that belongs to one configuration, traffic mix, driver or
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the sizes, the source, ``reduced`` and
  ``assumed``, the dtypes and the program's options; its ``family``
  names the plain reference ``reference/<family>.py`` and the adapter
  to the program ``models/<family>.py``;
* ``workloads/<cell>.json``: the configuration, the driver, the traffic
  mix's parameters and the limits of the outputs' check;
* ``drivers/<driver>.py``: one loop a kind, ``drive(run)``;
* ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one
  reader a metric, ``read(run)``, which returns a number or None when
  the run holds nothing to read.  A metric split by suffix
  (``mfu.images``) falls back to the reader of its base name
  (``mfu.py``).

A later cell, configuration or metric is added as files and entries;
no file here names one.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import re
import sys
from typing import Dict, List, Optional

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "bigdl_tpu", "bigdl")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, roots, ext: str) -> str:
    """The first ``<root>/<kind>/<name><ext>`` that exists."""
    for root in roots:
        path = os.path.join(root, kind, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {kind}/{name}{ext} under {list(roots)}")


def load_module(path: str):
    key = "benchmark_file_" + re.sub(r"\W", "_", os.path.relpath(path, ROOT))
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str, roots):
    """The reader module of metric ``name``: its own file, else that of
    its base name (the part before the first dot)."""
    try:
        return load_module(find(kind, name, roots, ".py"))
    except FileNotFoundError:
        return load_module(find(kind, name.split(".")[0], roots, ".py"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones; a metric without ``workloads``
    belongs to every cell (a per-layer one: every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is the JAX
    stack's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """One run of one cell: what the driver is given and what it leaves
    for the readers.  ``record`` holds the driver's raw observations,
    ``checks`` each compared number as (value, limit)."""

    def __init__(self, cell_name: str, cell: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device, t0: float, roots):
        self.name = cell_name
        self.cell = cell
        self.config = config
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t0 = t0
        self.roots = roots
        family = config["family"]
        self.reference = load_module(find("reference", family, roots, ".py"))
        self.family = load_module(find("models", family, roots, ".py"))
        self.record: Dict = {}
        self.checks: Dict[str, tuple] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.profile: Optional[Profile] = None

    def limit(self, name: str) -> float:
        return float(self.cell["limits"][name])

    def free_device(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def read_peak(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated())


class Profile:
    """A ``torch.profiler`` trace of a steady stretch, reduced to device
    intervals by name and host operations, with the stretch's length on
    the host clock (started and stopped at synchronised points)."""

    def __init__(self, prof, window_s: float):
        self.window_s = float(window_s)
        self.device_ops: List[tuple] = []       # (name, start_us, end_us)
        self.host_ops: List[tuple] = []
        events = list(prof.profiler.kineto_results.events())
        # a region annotated on the host is mirrored on the device's
        # timeline: it is no operation of the device
        regions = {ev.name() for ev in events if ev.is_user_annotation()}
        for ev in events:
            start = ev.start_ns() / 1e3
            end = start + ev.duration_ns() / 1e3
            kind = str(ev.device_type()).split(".")[-1]
            if kind == "CUDA":
                if not ev.is_user_annotation() and ev.name() not in regions:
                    self.device_ops.append((ev.name(), start, end))
            elif kind == "CPU" and end > start:
                self.host_ops.append((ev.name(), start, end))
        self.device_ops.sort(key=lambda e: e[1])
        self._busy = self._merge()

    def _merge(self) -> List[list]:
        out: List[list] = []
        for _, s, e in self.device_ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._busy) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device_ops if rx.search(n)) / 1e6

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.device_ops if rx.search(n))

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            by[n[:160]] = by.get(n[:160], 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The device's idle gaps, summed by what the host was doing at
        each gap's middle: the host operation that started last before
        it and still ran (on nested operations, the innermost)."""
        import bisect

        hosts = sorted(self.host_ops, key=lambda e: e[1])
        starts = [h[1] for h in hosts]
        by: Dict[str, float] = {}
        for (_, a), (b, _) in zip(self._busy, self._busy[1:]):
            mid = (a + b) / 2
            name = "(host between operations)"
            for j in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 400),
                           -1):
                if hosts[j][2] >= mid:
                    name = hosts[j][0][:160]
                    break
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:k]]


def profiled(device):
    """A started ``torch.profiler`` over the host and, on the card, the
    device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def device_info(run: Run) -> dict:
    if run.device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": int(run.cell.get("chips", 1)),
                "memory_peak_bytes": run.memory_peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": run.memory_peak}


def prepare(name: str, seed: int, seconds: float, trace: bool, device,
            t0: float, roots=(BENCH,), bench: Optional[dict] = None) -> Run:
    """The :class:`Run` of cell ``name``: its entry in ``BENCHMARK.json``
    (or ``bench``), its file and its configuration's."""
    bench = bench if bench is not None else load_json(
        os.path.join(ROOT, "BENCHMARK.json"))
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    cell = load_json(find("workloads", name, roots, ".json"))
    if cell["config"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json names {entry['config']}, "
                         f"the cell's file {cell['config']}")
    config = load_json(find("configs", entry["config"], roots, ".json"))
    if config["compute_dtype"] == "float32":
        # a configuration in float32 runs its products in float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = Run(name, cell, config, seed, seconds, trace, device, t0, roots)
    run.bench = bench
    return run


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, roots=(BENCH,), bench: Optional[dict] = None) -> dict:
    """One run of cell ``name`` (arguments as :func:`prepare`): the
    driver, then the readers; returns the result object (``checks``
    last)."""
    run = prepare(name, seed, seconds, trace, device, t0, roots, bench)
    bench = run.bench
    roots = run.roots
    load_module(find("drivers", run.cell["driver"], roots, ".py")).drive(run)
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        kind = "layer_metrics" if trace else "end_to_end"
        value = reader(kind, m["name"], roots).read(run)
        if value is None or not math.isfinite(value):
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = bool(run.checks) and all(
        math.isfinite(v) and v <= lim for v, lim in run.checks.values())
    out = {"correct": correct and run.failed == 0,
           "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device_info(run)}
    if trace and run.profile is not None:
        out["device"]["busy_s"] = run.profile.busy_s
        out["device"]["window_s"] = run.profile.window_s
        out["breakdown"] = {"device_ops": run.profile.top_ops(),
                            "idle_gaps": run.profile.idle_gaps()}
    worst = run.record.get("worst", {})
    out["checks"] = {k: dict(value=v, limit=lim, **(
        {"at": worst[k]} if k in worst else {}))
        for k, (v, lim) in run.checks.items()}
    return out


def checks_text(result: dict) -> str:
    """One line a number compared: its value, its limit and, where the
    driver says, the step or leaf where it is worst."""
    return "\n".join(
        f"check {k}: {c['value']:.6g} (limit {c['limit']:g})"
        + (f" at {c['at']}" if "at" in c else "")
        for k, c in result["checks"].items())
