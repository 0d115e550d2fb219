"""Labelled Counter / Gauge / Histogram registry.

Counterpart of ``bigdl_tpu/obs/metrics.py`` (:38-587):
monotonic :class:`Counter`, settable :class:`Gauge` and bucketed
:class:`Histogram` children, each family optionally labelled (children
made lazily per label combination), thread-safe (engine loops, HTTP
handler threads and clients stamp them at once).  Registration is
idempotent for the same kind and label names and raises for another.

* a histogram observation may carry an exemplar (``{"trace_id": ...}``),
  the newest per bucket, exported in OpenMetrics syntax so that a
  latency bucket links to a kept request trace;
* :meth:`MetricsRegistry.to_prometheus` is the text exposition format
  0.0.4 the obs server's ``/metrics`` serves, :func:`parse_prometheus`
  its reader and :func:`render_exposition` the writer of what that
  reader gives (the rollup tier's merged body);
* :meth:`MetricsRegistry.snapshot` / :meth:`write_snapshot` are the
  JSONL and ``.prom`` shards ``obs.flush`` writes under the metrics
  directory;
* under ``BIGDL_TORCH_OBS_STRICT=1`` a ``bigdl_*`` family must be
  declared in ``obs/names.py`` with the kind and labels it is minted
  with, and a family may not grow past its declared label cardinality.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

# bucket bounds from sub-millisecond host work up to multi-second
# requests
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _strict() -> bool:
    """Is the strict registry on (``BIGDL_TORCH_OBS_STRICT``)?  Read at
    call time, so a test can switch it without a new registry."""
    from bigdl_tpu_torch.config import ObsConfig

    return ObsConfig.from_env().strict


def _declared_spec(name: str):
    """The ``obs/names.py`` spec of a ``bigdl_*`` family (None for a
    foreign name: a private registry mints what it likes)."""
    if not name.startswith("bigdl_"):
        return None
    from bigdl_tpu_torch.obs import names as _names

    return _names.REGISTRY.get(name)


def _escape(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(v: str) -> str:
    """HELP-line escaping: backslash and newline only."""
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    """A sample value: integers without a trailing .0, non-finite values
    as ``NaN`` / ``+Inf`` / ``-Inf``."""
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f == int(f) else repr(f)


class Counter:
    """Monotonic counter child."""

    kind = "counter"

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        with self._lock:
            self.value += amount
        return self


class Gauge:
    """Settable gauge child."""

    kind = "gauge"

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float):
        with self._lock:
            self.value = float(value)
        return self

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount
        return self


class Histogram:
    """Bucketed histogram child: per-bucket counts (the last bucket is
    +Inf), the count, the sum and the newest exemplar of each bucket."""

    kind = "histogram"

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = lock
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        # bucket index -> (labels, value, unix time)
        self.exemplars: Dict[int, tuple] = {}

    def observe(self, value: float, exemplar: Optional[dict] = None):
        """Record ``value``; ``exemplar`` (a small ``{label: value}``
        dict) attaches to the bucket the value lands in, newest wins."""
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.bucket_counts[i] += 1
            self.count += 1
            self.sum += v
            if exemplar:
                self.exemplars[i] = (dict(exemplar), v, time.time())
        return self

    def exemplar_items(self) -> Dict[int, tuple]:
        with self._lock:
            return dict(self.exemplars)

    def snapshot_state(self):
        """``(bucket_counts, count, sum)`` under one lock, so a reader
        racing ``observe`` never sees a count that disagrees with the
        buckets."""
        with self._lock:
            return list(self.bucket_counts), self.count, self.sum

    def _cumulative_from(self, counts):
        out, acc = [], 0
        for b, c in zip(self.bounds + (float("inf"),), counts):
            acc += c
            out.append((b, acc))
        return out

    def cumulative(self):
        """[(upper bound, cumulative count), ...] ending with +Inf."""
        counts, _, _ = self.snapshot_state()
        return self._cumulative_from(counts)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named family: fixed label names, children made lazily per
    label-value combination.  A label-less family acts as its one
    child (``inc``/``set``/``observe``)."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Optional[Sequence[float]] = None,
                 max_children: Optional[int] = None):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        # the declared label-cardinality ceiling, enforced only in
        # strict mode
        self.max_children = max_children
        self._lock = threading.Lock()
        self._children: Dict[tuple, object] = {}

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labelvalues)} do not match "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.max_children is not None \
                        and len(self._children) >= self.max_children \
                        and _strict():
                    raise ValueError(
                        f"{self.name}: label cardinality ceiling "
                        f"{self.max_children} exceeded (new combination "
                        f"{key!r})")
                cls = _KINDS[self.kind]
                child = (cls(self._lock, self.buckets)
                         if self.kind == "histogram" else cls(self._lock))
                self._children[key] = child
            return child

    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()")
        return self.labels()

    def inc(self, amount: float = 1.0):
        return self._solo().inc(amount)

    def set(self, value: float):
        return self._solo().set(value)

    def observe(self, value: float, exemplar: Optional[dict] = None):
        return self._solo().observe(value, exemplar=exemplar)

    def child_items(self):
        with self._lock:
            return list(self._children.items())

    def clear(self):
        """Drop every child (JAX ``_Family.clear``)."""
        with self._lock:
            self._children.clear()


class MetricsRegistry:
    """Named families.  Registering a name again returns its family if
    the kind and label names agree, and raises if they do not."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name, help, kind, labels=(), buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not "
                        f"{kind}{tuple(labels)}")
                return fam
            spec = _declared_spec(name)
            if spec is None and name.startswith("bigdl_") and _strict():
                raise ValueError(
                    f"metric {name!r} is not declared in "
                    "bigdl_tpu_torch/obs/names.py and "
                    "BIGDL_TORCH_OBS_STRICT is on")
            if spec is not None and _strict() and (
                    spec.kind != kind or set(spec.labels) != set(labels)):
                raise ValueError(
                    f"metric {name!r} declared as {spec.kind}"
                    f"{spec.labels} in bigdl_tpu_torch/obs/names.py but "
                    f"registered as {kind}{tuple(labels)}")
            fam = _Family(name, help, kind, tuple(labels), buckets,
                          max_children=(spec.cardinality
                                        if spec is not None else None))
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels=()) -> _Family:
        return self._family(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "", labels=()) -> _Family:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._family(name, help, "histogram", labels, buckets)

    def families(self):
        with self._lock:
            return list(self._families.values())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4: a ``# HELP`` and a
        ``# TYPE`` line for every family (a help-less one falls back to
        its name), the families by name, the children by label values;
        a histogram's buckets, ``_sum`` and ``_count`` come from one
        locked read, its exemplars in OpenMetrics ``# {...} v ts``
        syntax."""
        lines = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            lines.append(
                f"# HELP {fam.name} {_escape_help(fam.help or fam.name)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.child_items()):
                pairs = [f'{n}="{_escape(v)}"'
                         for n, v in zip(fam.labelnames, key)]
                base = "{" + ",".join(pairs) + "}" if pairs else ""
                if fam.kind != "histogram":
                    lines.append(f"{fam.name}{base} {_fmt(child.value)}")
                    continue
                counts, count, total = child.snapshot_state()
                exs = child.exemplar_items()
                for i, (bound, acc) in enumerate(
                        child._cumulative_from(counts)):
                    le = "+Inf" if bound == float("inf") else _fmt(bound)
                    bpairs = pairs + [f'le="{le}"']
                    line = f"{fam.name}_bucket{{{','.join(bpairs)}}} {acc}"
                    ex = exs.get(i)
                    if ex is not None:
                        exl, exv, exts = ex
                        body = ",".join(f'{k}="{_escape(v)}"'
                                        for k, v in exl.items())
                        line += f" # {{{body}}} {_fmt(exv)} {exts:.3f}"
                    lines.append(line)
                lines.append(f"{fam.name}_sum{base} {_fmt(total)}")
                lines.append(f"{fam.name}_count{base} {count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """Every family as JSON-able samples (JAX :369): a histogram's
        count, sum and cumulative buckets from one locked read."""
        metrics = {}
        for fam in self.families():
            samples = []
            for key, child in sorted(fam.child_items()):
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    counts, count, total = child.snapshot_state()
                    samples.append(
                        {"labels": labels, "count": count, "sum": total,
                         "buckets": [
                             ["+Inf" if b == float("inf") else b, c]
                             for b, c in child._cumulative_from(counts)]})
                else:
                    samples.append({"labels": labels, "value": child.value})
            metrics[fam.name] = {"type": fam.kind, "help": fam.help,
                                 "samples": samples}
        return {"ts": time.time(), "metrics": metrics}

    def write_snapshot(self, directory: str, extra_registries=(),
                       host_id: int = None):
        """Write ``metrics.h<host>.<pid>.prom`` (atomic replace) and
        append one JSON line to ``metrics.h<host>.<pid>.jsonl`` (JAX
        :390): the shards the run report, the fleet aggregator's shard
        tailer and the regression gate read.  ``extra_registries`` join
        both (a trainer's phase-timer registry)."""
        if host_id is None:
            from bigdl_tpu_torch.obs.trace import _host_id

            host_id = _host_id()
        os.makedirs(directory, exist_ok=True)
        pid = os.getpid()
        stem = f"metrics.h{host_id}.{pid}"
        prom_path = os.path.join(directory, stem + ".prom")
        text = self.to_prometheus() + "".join(
            r.to_prometheus() for r in extra_registries)
        tmp = prom_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
        os.replace(tmp, prom_path)
        jsonl_path = os.path.join(directory, stem + ".jsonl")
        snap = self.snapshot()
        for r in extra_registries:
            snap["metrics"].update(r.snapshot()["metrics"])
        snap["host"] = host_id
        snap["pid"] = pid
        with open(jsonl_path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(snap, default=str) + "\n")
        return {"prom": prom_path, "jsonl": jsonl_path}

    def reset(self):
        """Drop every family (the tests' hook)."""
        with self._lock:
            self._families.clear()


# ------------------------------------------------------------------ reader
# one exposition sample line: name, optional {labels}, value
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_EXEMPLAR_RE = re.compile(r'^\{(.*)\}\s+(\S+)(?:\s+(\S+))?$')
_UNESCAPE = {r"\\": "\\", r"\"": '"', r"\n": "\n"}


def _unescape_label(v: str) -> str:
    return re.sub(r'\\(.)', lambda m: _UNESCAPE.get(m.group(0),
                                                    m.group(1)), v)


def _parse_value(v: str) -> float:
    low = v.lower()
    if low == "nan":
        return float("nan")
    if low in ("+inf", "inf"):
        return float("inf")
    if low == "-inf":
        return float("-inf")
    return float(v)


def _parse_exemplar(tail: str) -> dict:
    m = _EXEMPLAR_RE.match(tail.strip())
    if not m:
        raise ValueError(f"bad exemplar: {tail!r}")
    labelbody, value, ts = m.groups()
    out = {"labels": {k: _unescape_label(v)
                      for k, v in _LABEL_RE.findall(labelbody or "")},
           "value": _parse_value(value)}
    if ts:
        out["ts"] = float(ts)
    return out


def parse_prometheus(text: str) -> dict:
    """Text exposition back into ``{"families": {name: {"type",
    "help"}}, "samples": [{"name", "labels", "value"[, "exemplar"]}]}``
    (JAX :383-440).  A malformed line raises: a scrape that parses
    parses whole."""
    families: Dict[str, dict] = {}
    samples = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            key = "help" if line.startswith("# HELP ") else "type"
            rest = line[len("# HELP "):].split(" ", 1)
            families.setdefault(rest[0], {})[key] = \
                rest[1] if len(rest) > 1 else ""
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        exemplar = None
        if not m and " # " in line:
            body, _, tail = line.partition(" # ")
            m = _SAMPLE_RE.match(body.strip())
            if m:
                exemplar = _parse_exemplar(tail)
        if not m:
            raise ValueError(f"bad exposition line: {line!r}")
        name, labelbody, value = m.groups()
        entry = {"name": name,
                 "labels": {k: _unescape_label(v)
                            for k, v in _LABEL_RE.findall(labelbody or "")},
                 "value": _parse_value(value)}
        if exemplar is not None:
            entry["exemplar"] = exemplar
        samples.append(entry)
    return {"families": families, "samples": samples}


def _base_family(name: str, families: dict) -> str:
    """The family a sample line belongs to (JAX :520): a histogram's
    ``_bucket`` / ``_sum`` / ``_count`` samples group under the
    declared histogram, everything else under itself."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if families.get(base, {}).get("type") == "histogram":
                return base
    return name


def render_exposition(parsed: dict) -> str:
    """:func:`parse_prometheus` output (or anything of its shape) back
    to text exposition (JAX :532): the rollup tier re-exposes a merged
    fleet through it.  ``parse_prometheus(render_exposition(p))`` keeps
    every family's type and help, every sample and every exemplar."""
    families = parsed.get("families") or {}
    by_family: Dict[str, list] = {}
    order: list = []
    for s in parsed.get("samples") or []:
        base = _base_family(s["name"], families)
        if base not in by_family:
            by_family[base] = []
            order.append(base)
        by_family[base].append(s)
    # a family with a type and help but no sample still shows its header
    for name in families:
        if name not in by_family:
            by_family[name] = []
            order.append(name)
    lines = []
    for base in sorted(order):
        meta = families.get(base) or {}
        lines.append(
            f"# HELP {base} {_escape_help(meta.get('help') or base)}")
        lines.append(f"# TYPE {base} {meta.get('type') or 'untyped'}")
        for s in by_family[base]:
            pairs = [f'{k}="{_escape(v)}"'
                     for k, v in (s.get("labels") or {}).items()]
            body = "{" + ",".join(pairs) + "}" if pairs else ""
            line = f"{s['name']}{body} {_fmt(s['value'])}"
            ex = s.get("exemplar")
            if ex is not None:
                exl = ",".join(f'{k}="{_escape(v)}"'
                               for k, v in (ex.get("labels") or {}).items())
                line += f" # {{{exl}}} {_fmt(ex['value'])}"
                if ex.get("ts") is not None:
                    line += f" {float(ex['ts']):.3f}"
            lines.append(line)
    return "\n".join(lines) + ("\n" if lines else "")


def sample_value(parsed: dict, name: str, **labels) -> Optional[float]:
    """The first sample named ``name`` whose labels contain ``labels``."""
    for s in parsed["samples"]:
        if s["name"] == name and all(
                s["labels"].get(k) == str(v) for k, v in labels.items()):
            return s["value"]
    return None


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "parse_prometheus", "render_exposition",
           "sample_value"]
