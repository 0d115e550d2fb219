"""Training-health telemetry: per-layer numerics.

Counterpart of ``bigdl_tpu/obs/health.py`` (:1-317).  Per layer (one
parameter leaf, named by its JAX tree path, e.g. ``"0/weight"``) one
row ``[grad_sq, param_sq, update_sq, nonfinite_grad_count]`` of an
``(L, 4)`` f32 tensor, computed on the trainer's device:

* :func:`tree_layer_stats`: ``LocalOptimizer``'s, from the gradient and
  parameter lists;
* :func:`flat_shard_stats`: ``DistriOptimizer``'s, from its shard of the
  flat vector: a position's layer is ``searchsorted`` of the cumulative
  layer ends, segment sums per layer (differences of f64 prefix sums:
  an f32 ``index_add_``, atomic adds on the card, read 4.5e-4 off the
  squared gradient norm of ResNet-50 on an H100), then
  one ``(L, 4)`` ``all_reduce`` makes the stats global.  ``positions``
  gives the flat coordinate of each shard element for the bucketed
  layout.

The gradient is the pre-clip one.  :class:`HealthMonitor` reads the
stats back every ``BIGDL_TORCH_HEALTH_EVERY`` steps (and on a step the
non-finite guard skipped, to name the offending layers), publishes the
per-layer gauges, feeds ``TrainSummary.add_health`` and runs the
loss/gradient-norm spike detector.  A trainer decides at dispatch
whether a step is a K-th one; every other guarded step hands the
monitor :class:`DeferredStats`, which keep the step's pre-clip
gradient and post-guard parameters and compute the stats only when
the monitor reads them, that is when the guard tripped (JAX computes
them on every step and fetches them then).  A step that did not trip
computes no stats and reads nothing back.
"""

from __future__ import annotations

import collections
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.obs import names as mnames

log = logging.getLogger("bigdl_tpu_torch.obs")

# columns of the stacked per-layer stats
GRAD_SQ, PARAM_SQ, UPDATE_SQ, NONFINITE = 0, 1, 2, 3


def _host(stats) -> np.ndarray:
    if isinstance(stats, torch.Tensor):
        return stats.detach().cpu().numpy()
    return np.asarray(stats)


def layer_names(params_tree) -> List[str]:
    """The tree path of each parameter leaf, in the JAX leaf order (the
    flat vector's): the label vocabulary of the per-layer metrics."""
    from bigdl_tpu_torch.utils import tree as T

    return ["/".join(str(k) for k in path)
            for path, _ in T.leaves_with_paths(params_tree)]


def layer_sizes(params_tree) -> List[int]:
    """Element count per leaf, in :func:`layer_names`' order."""
    from bigdl_tpu_torch.utils import tree as T

    return [int(v.numel()) for v in T.leaves(params_tree)]


# ------------------------------------------------------------ device math
def _row_stats(g, p, q):
    gf, pf = g.float(), p.float()
    df = q.float() - pf
    return torch.stack([torch.sum(gf * gf), torch.sum(pf * pf),
                        torch.sum(df * df),
                        torch.sum((~torch.isfinite(gf)).float())])


def tree_layer_stats(grads, params, new_params) -> torch.Tensor:
    """``LocalOptimizer``'s stats: one row a parameter of the three
    lists (JAX :78)."""
    return torch.stack([_row_stats(g, p, q)
                        for g, p, q in zip(grads, params, new_params)])


def _segment_sums(cols: torch.Tensor, seg: torch.Tensor,
                  n_seg: int) -> torch.Tensor:
    """Per-segment column sums of ``cols`` (rows in non-decreasing
    segment order): differences of f64 prefix sums at the segment
    ends, so a layer of millions of values sums without the rounding
    of f32 atomic adds.  A segment holding a NaN sums to NaN, one
    holding an inf (and no NaN) to inf, as a plain sum of these
    non-negative columns would."""
    counts = torch.bincount(seg, minlength=n_seg)
    ends = counts.cumsum(0)
    starts = ends - counts

    def seg_sum(v):
        # one 1-D scan a column: a scan along the outer dimension of an
        # (S, 4) tensor runs each column on one CUDA thread
        out = []
        for c in range(v.shape[1]):
            cs = torch.cumsum(v[:, c].contiguous(), 0, dtype=torch.float64)
            cs = torch.cat([cs.new_zeros(1), cs])
            out.append(cs[ends] - cs[starts])
        return torch.stack(out, dim=1)

    nan, inf = torch.isnan(cols), torch.isinf(cols)
    sums = seg_sum(torch.where(nan | inf, torch.zeros_like(cols), cols))
    n_nan, n_inf = seg_sum(nan.float()), seg_sum(inf.float())
    sums = torch.where(n_inf > 0, torch.full_like(sums, float("inf")), sums)
    sums = torch.where(n_nan > 0, torch.full_like(sums, float("nan")), sums)
    return sums.float()


def flat_shard_stats(gshard, wshard, new_wshard, shard_offset: int,
                     boundaries: torch.Tensor, group=None, positions=None,
                     reduce: bool = True) -> torch.Tensor:
    """``DistriOptimizer``'s stats from this rank's shard (JAX :102):
    position ``shard_offset + i`` (or ``positions[i]``, ascending, as
    the bucketed layout's are) falls in layer ``searchsorted(
    boundaries, idx, side="right")``; pad positions land in a dropped
    extra segment.  The per-layer sums (``_segment_sums``) are summed
    over the ``group``'s ranks in one ``all_reduce`` (``reduce=False``
    leaves them local)."""
    n_layers = int(boundaries.shape[0])
    shard_len = gshard.shape[0]
    dev = gshard.device
    idx = positions if positions is not None else \
        torch.arange(shard_len, device=dev, dtype=torch.int64) + shard_offset
    seg = torch.searchsorted(boundaries, idx, right=True)
    gf, wf = gshard.float(), wshard.float()
    df = new_wshard.float() - wf
    cols = torch.stack([gf * gf, wf * wf, df * df,
                        (~torch.isfinite(gf)).float()], dim=1)
    stats = _segment_sums(cols, seg, n_layers + 1)[:n_layers].contiguous()
    if reduce:
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size(group) > 1:
            dist.all_reduce(stats, group=group)
    return stats


# ------------------------------------------------------------ host analysis
def nonfinite_layers(stats: np.ndarray,
                     names: Sequence[str]) -> List[str]:
    """Names of layers with any non-finite gradient element, flat-layout
    order (the first entry is the first offender)."""
    arr = np.asarray(stats)
    return [names[i] for i in range(min(len(names), arr.shape[0]))
            if arr[i, NONFINITE] > 0]


def summarize(stats: np.ndarray, names: Sequence[str],
              eps: float = 1e-12) -> dict:
    """Derived per-layer numbers from one fetched ``(L, 4)`` array:
    ``{layer: {grad_norm, param_norm, update_ratio, nonfinite}}`` plus
    the global gradient norm."""
    arr = np.asarray(stats, np.float64)
    layers = {}
    for i, name in enumerate(names[: arr.shape[0]]):
        gsq, psq, usq, nf = arr[i]
        layers[name] = {
            "grad_norm": float(np.sqrt(gsq)),
            "param_norm": float(np.sqrt(psq)),
            "update_ratio": float(np.sqrt(usq) / (np.sqrt(psq) + eps)),
            "nonfinite": int(nf) if np.isfinite(nf) else -1,
        }
    with np.errstate(invalid="ignore"):
        global_grad = float(np.sqrt(arr[:, GRAD_SQ].sum()))
    return {"layers": layers, "global_grad_norm": global_grad}


class DeferredStats:
    """A step's stats, computed only if the monitor reads them: ``fn``
    takes the tensors the step kept (fresh ones, never the live
    parameters a later step overwrites).  At world > 1 ``fn`` runs the
    stats' ``all_reduce``; every rank reads the same steps (the cadence
    and the MIN-reduced guard agree), so every rank enters it."""

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def __call__(self) -> torch.Tensor:
        return self._fn()


class HealthMonitor:
    """The host half: the fetch cadence, the metric, trace and
    TensorBoard fan-out, non-finite localization and the anomaly
    detector.  A trainer makes one only when ``BIGDL_TORCH_HEALTH_EVERY
    > 0``; without it the step computes no stats at all."""

    def __init__(self, names: Sequence[str], every: int, registry=None,
                 tracer=None, summary=None, window: int = 64,
                 spike_factor: float = 10.0):
        from bigdl_tpu_torch import obs
        from bigdl_tpu_torch.obs.trace import NULL_TRACER

        self.names = list(names)
        self.every = max(1, int(every))
        self.registry = registry if registry is not None \
            else obs.get_registry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.summary = summary
        self.spike_factor = float(spike_factor)
        self.fetches = 0          # device->host health transfers, total
        self.anomalies = 0
        self._loss_window: collections.deque = collections.deque(
            maxlen=max(8, int(window)))
        self._gnorm_window: collections.deque = collections.deque(
            maxlen=max(8, int(window)))
        self.last: Optional[dict] = None
        self._grad_gauge = self.registry.gauge(
            mnames.GRAD_NORM,
            "Per-layer global gradient L2 norm (pre-clip)",
            labels=("layer",))
        self._param_gauge = self.registry.gauge(
            mnames.PARAM_NORM, "Per-layer parameter L2 norm",
            labels=("layer",))
        self._ratio_gauge = self.registry.gauge(
            mnames.UPDATE_RATIO,
            "Per-layer ||update|| / ||param|| ratio", labels=("layer",))
        self._gnorm_hist = self.registry.histogram(
            mnames.GLOBAL_GRAD_NORM,
            "Global (all-layer) gradient L2 norm per health sample",
            buckets=(1e-4, 1e-3, 1e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
                     100.0, 1e3, 1e4))
        self._nonfinite_ctr = self.registry.counter(
            mnames.NONFINITE_LAYERS_TOTAL,
            "Non-finite-gradient steps attributed per layer",
            labels=("layer",))
        self._anomaly_ctr = self.registry.counter(
            mnames.NUMERICS_ANOMALIES_TOTAL,
            "Loss / grad-norm spikes vs the rolling median",
            labels=("kind",))

    # ------------------------------------------------------------- cadence
    def wants(self, step: int, ok: bool = True) -> bool:
        """Read this step's stats?  Every K steps, and always when the
        non-finite guard tripped (localization is that read's
        point)."""
        return (not ok) or step % self.every == 0

    # ------------------------------------------------------------- ingest
    def on_step(self, step: int, stats, ok: bool, loss: float):
        """Called when the step's loss is read, with its ``(L, 4)``
        stats (a device tensor, :class:`DeferredStats`, or None on a step
        the trainer kept none for).  Reads them back only when
        :meth:`wants` says so; the loss-spike check is free (the loss is
        on the host already)."""
        self._spike("loss_spike", self._loss_window, step, loss)
        if stats is None or not self.wants(step, ok):
            return None
        if isinstance(stats, DeferredStats):
            stats = stats()
        arr = _host(stats)        # the one device -> host health read
        self.fetches += 1
        summ = summarize(arr, self.names)
        self.last = {"step": step, **summ}
        for name, row in summ["layers"].items():
            # a NaN gauge carries no information (the non-finite counter
            # below is the signal for that); keep the last finite value
            for gauge, key in ((self._grad_gauge, "grad_norm"),
                               (self._param_gauge, "param_norm"),
                               (self._ratio_gauge, "update_ratio")):
                if np.isfinite(row[key]):
                    gauge.labels(layer=name).set(row[key])
        g = summ["global_grad_norm"]
        if np.isfinite(g):
            self._gnorm_hist.observe(g)
            self._spike("grad_norm_spike", self._gnorm_window, step, g)
        if self.summary is not None:
            add = getattr(self.summary, "add_health", None)
            if add is not None:
                add(step, summ["layers"])
        if not ok:
            self._report_nonfinite(step, arr, loss)
        return summ

    def _report_nonfinite(self, step: int, arr: np.ndarray, loss: float):
        bad = nonfinite_layers(arr, self.names)
        first = bad[0] if bad else None
        counts = {self.names[i]: int(arr[i, NONFINITE])
                  for i in range(min(len(self.names), arr.shape[0]))
                  if arr[i, NONFINITE] > 0}
        if not bad:
            # grads finite but the loss was not — attribute to the loss
            first = "<loss>"
        log.warning(
            "non-finite localization at step %d: first offender %s "
            "(all: %s)", step, first, bad or "loss only")
        self.tracer.event("health.nonfinite_layers", step=step,
                          first=first, layers=bad, counts=counts,
                          loss=loss)
        for name in (bad or [first]):
            self._nonfinite_ctr.labels(layer=name).inc()

    def _spike(self, kind: str, window: collections.deque, step: int,
               value: float):
        """Rolling-median spike detector (mirrors the slow-step
        detector: 8-observation warmup, factor from config, structured
        event + counter)."""
        if self.spike_factor <= 0 or value is None \
                or not np.isfinite(value):
            return
        v = abs(float(value))
        if len(window) >= 8:
            med = float(np.median(window))
            if med > 0 and v > med * self.spike_factor:
                self.anomalies += 1
                log.warning("numerics anomaly at step %d: %s %.6g vs "
                            "rolling median %.6g (> %gx)", step, kind, v,
                            med, self.spike_factor)
                self.tracer.event("health.anomaly", kind=kind, step=step,
                                  value=v, median=med,
                                  factor=self.spike_factor)
                self._anomaly_ctr.labels(kind=kind).inc()
        window.append(v)


def monitor_from_config(params_tree, tracer=None, summary=None):
    """A :class:`HealthMonitor` when ``BIGDL_TORCH_HEALTH_EVERY`` > 0,
    else None (the trainers then compute no stats)."""
    from bigdl_tpu_torch.config import ObsConfig

    cfg = ObsConfig.from_env()
    if cfg.health_every <= 0:
        return None
    return HealthMonitor(layer_names(params_tree), cfg.health_every,
                         tracer=tracer, summary=summary,
                         window=cfg.health_window,
                         spike_factor=cfg.health_spike_factor)
