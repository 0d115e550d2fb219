"""Expert parallelism: a GShard-style Mixture-of-Experts layer.

Counterpart of ``bigdl_tpu/parallel/moe.py`` (``MoE`` :38), with its
numerics:

* routing as dense one-hot dispatch/combine contractions, top-1
  (switch) or top-2, each expert taking at most ``C = max(1,
  ceil(capacity_factor · S · k / E))`` tokens; the slots a routing
  iteration fills carry over to the next (``slot_base``), so a
  2nd-choice token never lands in a 1st-choice token's slot; a token
  past capacity contributes 0;
* top-2 outputs renormalized by the kept gates;
* the switch load-balancing loss (``aux_loss_weight · E · Σ frac ·
  mean prob``), returned by ``forward_with_aux``;
* ReLU experts; the (E, C, D) buffers cast to the input dtype where
  they are exchanged.

The expert FFN is ``einsum`` work outside any kernel, in the JAX
package too.

With a ``mesh`` whose ``expert_axis`` has n > 1 ranks, each rank holds
E/n experts (its slice, by its coordinate; ``set_params`` takes the
global (E, ...) tensors and keeps the slice) and the input is the
global (B, T, D) on every rank, GSPMD's meaning of JAX's replicated
input.  Every rank routes every token, so the dispatched buffer of its
own experts is already at hand; their outputs cross ``parallel/wire``
in one ``all_to_all`` (each rank's (E/n, C, D) block to every rank),
after which every rank combines every token and holds the whole
output.  With ``wire=`` set the compressed round trip applies to both
buffers, as JAX's (each rank quantizes its expert block, the blocks of
JAX's flat buffer where ``block`` divides E/n·C·D).  The backward
assumes every rank computes the same loss from the output: a rank's
experts get their own gradient, and the dispatch path's input gradient
is summed over the ranks.  The ``all_to_all`` and
``sharding_constraint`` counters and the ``path="moe"`` savings gauge
record what JAX's :125-156 records.

Beside it, with no JAX counterpart, :class:`SigmoidMoE`: the dropless,
sigmoid-routed layer with shared experts of DeepSeek-V3 (the published
``deepseek_v3`` modeling code), told which experts it holds:

* s = sigmoid(x·W_rᵀ) in f32 over all ``n_experts``; the top ``top_k``
  of s + b, where b (``router.bias``, a buffer that is neither trained
  nor cast) serves the selection only; gates w_k = ``scaling`` ·
  s_k / Σ s over the chosen (one expert group: the group-limited
  selection is the identity);
* y = Σ over the chosen experts this rank holds (experts [first, first
  + count)) of w_k·E_k(x), plus the shared experts S(x); E and S are
  SwiGLUs.  No capacity: no token is dropped.  What the absent experts
  add is left out, as on one rank of an expert-parallel deployment
  without its exchange;
* the held assignments are permuted by expert into one (M, d) buffer of
  static size (every assignment, each group padded to 8 rows), the
  group ends kept on the device; each projection of the held experts
  is one grouped GEMM (``torch._grouped_mm``) over it, and the rows go
  back weighted by a gather and sum a token.  Nothing in the forward or
  the backward reads a count on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.nn.mla import SwiGLU, draw
from bigdl_tpu_torch.nn.module import AbstractModule, Composite
from bigdl_tpu_torch.parallel.tensor_parallel import _CopyToGroup, constrain
from bigdl_tpu_torch.utils.profiler import _profiler_enabled, annotate

_EXPERT_PARAMS = ("w_in", "b_in", "w_out", "b_out")


class _GatherExperts(torch.autograd.Function):
    """Every rank's (E/n, C, D) expert block to every rank, through the
    wire's all_to_all: the whole (E, C, D) buffer.  The backward keeps
    this rank's block of the (replicated) cotangent, through the same
    wire's round trip."""

    @staticmethod
    def forward(ctx, block, group, n, idx, spec):
        from bigdl_tpu_torch.parallel import wire as W

        ctx.args = (n, idx, spec)
        rows = block.unsqueeze(0).expand((n,) + tuple(block.shape))
        out = W.all_to_all(rows.contiguous(), group, n, spec)
        return out.reshape((n * block.shape[0],) + tuple(block.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        from bigdl_tpu_torch.parallel import wire as W

        n, idx, spec = ctx.args
        e = g.shape[0] // n
        own = g[idx * e:(idx + 1) * e].contiguous()
        return W.roundtrip(own, spec), None, None, None, None


class MoE(AbstractModule):
    """Token-routed FFN bank: (B, T, D) -> (B, T, D)."""

    param_names = ("gate", "w_in", "b_in", "w_out", "b_out")
    config_names = ("dim", "hidden", "n_experts", "top_k",
                    "capacity_factor", "aux_loss_weight")

    def __init__(self, dim: int, hidden: int, n_experts: int,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 mesh=None, expert_axis: str = "expert",
                 aux_loss_weight: float = 0.01, wire=None):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 or 2")
        from bigdl_tpu_torch.parallel import wire as W

        self.dim = dim
        self.hidden = hidden
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.mesh = mesh
        self.expert_axis = expert_axis
        self.aux_loss_weight = aux_loss_weight
        # opt-in compressed wire for the expert buffers; like mesh, a
        # placement knob, not part of the serialized config
        self.wire = W.resolve(wire)
        self.n_exp = 1
        if mesh is not None and expert_axis in mesh.shape:
            self.n_exp = int(mesh.shape[expert_axis])
        if n_experts % self.n_exp:
            raise ValueError(f"{n_experts} experts do not split over "
                             f"{self.n_exp} {expert_axis!r} ranks")
        self.reset()

    def _own(self, a):
        """This rank's experts of a global (E, ...) array."""
        if self.n_exp == 1:
            return a
        e = self.n_experts // self.n_exp
        i = self.mesh.index(self.expert_axis)
        return a[i * e:(i + 1) * e]

    def reset(self):
        """Draw the weights from ``RandomGenerator.RNG`` in JAX's order
        and distributions (JAX :70-87), then keep this rank's experts."""
        e, d, h = self.n_experts, self.dim, self.hidden
        rng = RandomGenerator.RNG
        # gate: (D, E); experts: batched FFN weights
        self._set_param("gate", rng.normal(
            0.0, math.sqrt(1.0 / d), (d, e)).astype(np.float32))
        self._set_param("w_in", self._own(rng.normal(
            0.0, math.sqrt(2.0 / d), (e, d, h)).astype(np.float32)))
        self._set_param("b_in", self._own(np.zeros((e, h), np.float32)))
        self._set_param("w_out", self._own(rng.normal(
            0.0, math.sqrt(1.0 / h), (e, h, d)).astype(np.float32)))
        self._set_param("b_out", self._own(np.zeros((e, d), np.float32)))
        return self

    def set_params(self, params) -> None:
        """Copy a params tree in; an expert tensor given whole (E, ...),
        as a JAX ``MoE``'s, gives this rank its slice."""
        params = dict(params)
        for n in _EXPERT_PARAMS:
            v = params.get(n)
            if v is not None and self.n_exp > 1 \
                    and v.shape[0] == self.n_experts:
                params[n] = self._own(v)
        super().set_params(params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_with_aux(x)[0]

    def _account(self, cap: int, buf_dtype) -> None:
        """The all_to_all bytes of the (E, C, D) buffers' exchange pair
        (JAX :125-156)."""
        from bigdl_tpu_torch.obs import collectives as C
        from bigdl_tpu_torch.parallel import wire as W

        e, d, n = self.n_experts, self.dim, self.n_exp
        baseline = 2 * C.all_to_all_bytes(e * cap * d, buf_dtype, n)
        if self.wire is None:
            C.record("all_to_all", buf_dtype, baseline, axis_size=n)
        elif not self.wire.scaled:            # bfloat16 cast-only wire
            moved = 2 * C.all_to_all_bytes(e * cap * d, "bfloat16", n)
            C.record("all_to_all", self.wire.wire_name, moved, axis_size=n)
            C.record_savings("moe", baseline, moved)
        else:
            # a destination's slice of the buffer, blocked to the wire
            # quantum the quantizer uses
            blk = W.effective_block(e * cap * d // n, self.wire.block)
            payload = 2 * C.all_to_all_bytes(e * cap * d,
                                             self.wire.wire_name, n)
            scales = 2 * C.all_to_all_bytes(e * cap * d // blk, "float32",
                                            n)
            C.record("all_to_all", self.wire.wire_name, payload,
                     axis_size=n)
            C.record("all_to_all", "float32", scales, axis_size=n)
            C.record_savings("moe", baseline, payload + scales)

    def forward_with_aux(self, x: torch.Tensor):
        """``(output, aux_loss)``: add the load-balancing term to a
        training loss through this return."""
        from bigdl_tpu_torch.parallel import wire as W

        b, t, d = x.shape
        s = b * t
        e = self.n_experts
        cap = max(1, int(math.ceil(self.capacity_factor * s * self.top_k
                                   / e)))
        xs = x.reshape(s, d)
        # the dtype the (E, C, D) buffers cross in: a bf16 model ships
        # (and is billed) at bf16 width
        buf_dtype = x.dtype
        # the contractions accumulate in f32 (JAX's preferred_element_type),
        # or in f64 for an f64 input
        acc = torch.promote_types(x.dtype, torch.float32)
        n = self.n_exp
        if n > 1:
            self._account(cap, buf_dtype)

        # x @ gate in their promoted dtype, as jnp's matmul
        pt = torch.promote_types(xs.dtype, self.gate.dtype)
        probs = torch.softmax(torch.matmul(xs.to(pt), self.gate.to(pt)),
                              dim=-1)                                # (S, E)

        # --- top-k expert choice ---------------------------------------
        dispatch = xs.new_zeros((s, e, cap))
        combine = torch.zeros((s, e, cap), dtype=acc,
                              device=x.device)
        masked = probs
        aux_frac = probs.new_zeros((e,), dtype=torch.float32)
        # slots already taken in each expert's buffer by earlier routing
        # iterations
        slot_base = probs.new_zeros((e,), dtype=torch.float32)
        for _ in range(self.top_k):
            choice = torch.argmax(masked, dim=-1)                   # (S,)
            onehot = F.one_hot(choice, e).float()
            # position of each token within its expert's buffer
            pos = (torch.cumsum(onehot, dim=0) - onehot) + slot_base
            pos_tok = (pos * onehot).sum(dim=-1)                    # (S,)
            keep = (pos_tok < cap).float()
            gatep = (probs * onehot).sum(dim=-1) * keep             # (S,)
            # a slot past capacity is dropped by keep (one_hot of it is
            # zeros in JAX; torch's needs an index in range)
            poh = F.one_hot(pos_tok.long().clamp(max=cap - 1), cap).float()
            d1 = onehot[:, :, None] * poh[:, None, :] * keep[:, None, None]
            dispatch = dispatch + d1.to(dispatch.dtype)
            combine = combine + gatep[:, None, None] * d1
            aux_frac = aux_frac + onehot.mean(dim=0)
            slot_base = slot_base + onehot.sum(dim=0)
            masked = masked * (1.0 - onehot)

        # load-balance aux loss (switch transformer eq. 4)
        aux_loss = self.aux_loss_weight * e * torch.sum(
            aux_frac / self.top_k * probs.mean(dim=0))

        # --- dispatch -> expert FFN -> combine ---------------------------
        xd = xs if n == 1 else _CopyToGroup.apply(
            xs, self.mesh.group(self.expert_axis))
        xin = torch.einsum("sec,sd->ecd", dispatch.to(acc),
                           xd.to(acc)).to(buf_dtype)
        if n > 1:
            constrain(xin, self.mesh, self.expert_axis, None, None)
        xin = self._own(xin)
        if n > 1 and self.wire is not None:
            xin = W.roundtrip(xin, self.wire)
        h = F.relu(torch.matmul(xin.to(acc), self.w_in.to(acc))
                   + self.b_in[:, None, :])
        out = (torch.matmul(h, self.w_out.to(acc))
               + self.b_out[:, None, :]).to(buf_dtype)
        if n > 1:
            out = _GatherExperts.apply(
                out, self.mesh.group(self.expert_axis), n,
                self.mesh.index(self.expert_axis), self.wire)
            constrain(out, self.mesh, self.expert_axis, None, None)
        y = torch.einsum("sec,ecd->sd", combine, out.to(acc))
        # renormalize top-2 so the kept gates sum to 1 (dropped: 0)
        if self.top_k > 1:
            gsum = combine.sum(dim=(1, 2))
            y = y / torch.clamp_min(gsum, 1e-9)[:, None]
        return y.to(x.dtype).reshape(b, t, d), aux_loss

    def __repr__(self):
        return (f"MoE(dim={self.dim}, hidden={self.hidden}, "
                f"experts={self.n_experts}, top_k={self.top_k})")


# rows a group of the permuted buffer is padded to: the grouped GEMM's
# weight gradient wants each group's rows a multiple of 16 bytes
GROUP_ROWS = 8
# the regions a SigmoidMoE forward opens, in order
MOE_REGIONS = ("moe.route", "moe.dispatch", "moe.experts", "moe.shared",
               "moe.combine")


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """x with one more row of zeros, the row that unused indices read."""
    return F.pad(x, (0, 0, 0, 1))


def dispatch_plan(idx: torch.Tensor, first: int, count: int):
    """Where each routed assignment goes, all on the device.  ``idx``
    (S, k) are the chosen experts; experts [first, first + count) are
    held.  Returns (src, pos, offs, loads): the buffer has M = S·k +
    GROUP_ROWS·count rows, held expert g's rows (padded to GROUP_ROWS)
    before g + 1's; ``src`` (M,) is each row's token (S for a padding or
    unused row), ``pos`` (S, k) each assignment's row (M when the expert
    is not held), ``offs`` (count,) int32 the groups' row ends, ``loads``
    (count,) the assignments each held expert got."""
    s, k = idx.shape
    n = s * k
    m = n + GROUP_ROWS * count
    dev = idx.device
    local = idx.reshape(-1) - first
    key = torch.where((local >= 0) & (local < count), local,
                      torch.full_like(local, count))
    counts = torch.zeros(count + 1, dtype=torch.int64, device=dev) \
        .scatter_add_(0, key, torch.ones_like(key))
    order = torch.argsort(key, stable=True)
    skey = key[order]
    rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0)
                                          - counts)[skey]
    padded = (counts[:count] + GROUP_ROWS - 1) // GROUP_ROWS * GROUP_ROWS
    ends = torch.cumsum(padded, 0)
    held = skey < count
    row = torch.where(held, (ends - padded)[skey.clamp(max=count - 1)] + rank,
                      torch.full_like(skey, m))
    src = torch.full((m + 1,), s, dtype=torch.int64, device=dev) \
        .scatter_(0, row, order // k)[:m]
    pos = torch.empty(n, dtype=torch.int64, device=dev) \
        .scatter_(0, order, row).view(s, k)
    return src, pos, ends.to(torch.int32), counts[:count]


def _dsilu(x: torch.Tensor) -> torch.Tensor:
    sig = torch.sigmoid(x)
    return sig * (1.0 + x * (1.0 - sig))


class _RoutedExperts(torch.autograd.Function):
    """The held experts' part of a SigmoidMoE: x (S, d), w_gate_up
    (G, d, 2F), w_down (G, F, d), the gates w (S, k) f32 and the plan of
    :func:`dispatch_plan`; returns Σ_k w·E_k(x) over held experts, (S, d)
    f32.  Two grouped GEMMs forward and four backward
    (``torch._grouped_mm``: (M, K) rows in groups ending at ``offs`` by
    (G, K, N), or (K, M) by (M, N) to (G, K, N) for a weight's
    gradient; rows past ``offs[-1]`` come out unspecified, and no index
    reads them).  The backward forms dL/dw from (g·W_downᵀ)·a, so it
    keeps neither the rows' outputs nor their inputs, only the gate/up
    product h."""

    @staticmethod
    def forward(ctx, x, w_gu, w_down, w, src, pos, offs):
        with annotate("moe.dispatch"):
            xs = _pad_row(x)[src]
        with annotate("moe.experts"):
            h = torch._grouped_mm(xs, w_gu, offs=offs)
            gate, up = h.chunk(2, dim=-1)
            y = torch._grouped_mm(F.silu(gate) * up, w_down, offs=offs)
        with annotate("moe.combine"):
            out = (_pad_row(y)[pos].float() * w[..., None]).sum(1)
        ctx.save_for_backward(x, w_gu, w_down, w, src, pos, offs, h)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w_gu, w_down, w, src, pos, offs, h = ctx.saved_tensors
        dt, m = x.dtype, src.shape[0]
        g_rows = _pad_row(g.to(dt))[src]
        w_rows = torch.zeros(m + 1, dtype=w.dtype, device=w.device) \
            .scatter_(0, pos.reshape(-1), w.reshape(-1))[:m, None]
        gate, up = (t.float() for t in h.chunk(2, dim=-1))
        act = F.silu(gate)
        a = (act * up).to(dt)
        e = torch._grouped_mm(g_rows, w_down.transpose(-2, -1),
                              offs=offs).float()
        dw = _pad_row((e * a.float()).sum(-1, keepdim=True))[pos][..., 0]
        dw_down = torch._grouped_mm(a.t(), (g_rows.float() * w_rows).to(dt),
                                    offs=offs)
        da = e * w_rows
        dh = torch.cat((da * up * _dsilu(gate), da * act), dim=-1).to(dt)
        dw_gu = torch._grouped_mm(_pad_row(x)[src].t(), dh, offs=offs)
        dxs = torch._grouped_mm(dh, w_gu.transpose(-2, -1), offs=offs)
        dx = _pad_row(dxs)[pos].float().sum(1).to(dt)
        return dx, dw_gu, dw_down, dw, None, None, None


class MoEStats:
    """The held experts' loads by layer, (layers, count) on the device:
    each SigmoidMoE forward that runs while a profiler or the obs tracer
    records adds its loads there, with no read of its own; :meth:`read`
    reads them once, after the run."""

    def __init__(self, n_layers: int, count: int, device):
        self.loads = torch.zeros((n_layers, count), dtype=torch.int64,
                                 device=device)

    def add(self, layer: int, loads: torch.Tensor) -> None:
        self.loads[layer].add_(loads)

    def read(self) -> dict:
        """{"held": routed assignments to held experts by layer,
        "max_over_mean": the largest held expert's load over the mean,
        by layer (0 for a layer that saw nothing)}."""
        loads = self.loads.double().cpu()
        mean = loads.mean(1)
        return {"held": loads.sum(1).long().tolist(),
                "max_over_mean": torch.where(
                    mean > 0, loads.max(1).values / mean.clamp_min(1e-30),
                    torch.zeros_like(mean)).tolist()}

    def publish(self, registry=None) -> dict:
        """:meth:`read`, also into the obs registry (by default the
        process's) under ``MOE_HELD_ASSIGNMENTS_TOTAL`` and
        ``MOE_MAX_LOAD_RATIO``, one label a layer; returns the read."""
        from bigdl_tpu_torch import obs
        from bigdl_tpu_torch.obs import names

        out = self.read()
        reg = registry if registry is not None else obs.get_registry()
        held = reg.counter(names.MOE_HELD_ASSIGNMENTS_TOTAL,
                           "Routed assignments to held experts",
                           labels=("layer",))
        ratio = reg.gauge(names.MOE_MAX_LOAD_RATIO,
                          "Largest held expert's load over the mean",
                          labels=("layer",))
        for layer, (n, r) in enumerate(zip(out["held"],
                                           out["max_over_mean"])):
            held.labels(layer=str(layer)).inc(n)
            ratio.labels(layer=str(layer)).set(r)
        return out


class Router(AbstractModule):
    """The gate: ``weight`` (n_experts, dim), run in f32 (``keep_f32``:
    the trainer's compute-dtype cast leaves it alone), and ``bias``
    (n_experts,), the selection bias, a state buffer."""

    param_names = ("weight",)
    state_names = ("bias",)

    def __init__(self, dim: int, n_experts: int, std: float,
                 generator: torch.Generator):
        super().__init__()
        self._set_param("weight", draw((n_experts, dim), std, generator))
        self.weight.keep_f32 = True
        self.register_buffer("bias", torch.zeros(n_experts,
                                                 device=generator.device))


class HeldExperts(AbstractModule):
    """The SwiGLU experts this rank holds, stacked for the grouped GEMM:
    ``w_gate_up`` (count, dim, 2·hidden), gate's columns first, and
    ``w_down`` (count, hidden, dim)."""

    param_names = ("w_gate_up", "w_down")

    def __init__(self, dim: int, hidden: int, count: int, std: float,
                 generator: torch.Generator):
        super().__init__()
        self._set_param("w_gate_up", draw((count, dim, 2 * hidden), std,
                                          generator))
        self._set_param("w_down", draw((count, hidden, dim), std, generator))


class SigmoidMoE(Composite):
    """The dropless, sigmoid-routed MoE with shared experts (the module
    docstring): (B, T, dim) -> (B, T, dim).  Children ``router``,
    ``experts`` (the held ``count`` of ``n_experts``, from ``first``) and
    ``shared`` (a SwiGLU of width ``n_shared · hidden``).  ``stats``
    (a :class:`MoEStats`) takes this layer's loads as row ``layer``."""

    def __init__(self, dim: int, hidden: int, n_experts: int, top_k: int,
                 n_shared: int, scaling: float, first: int, count: int,
                 std: float, generator: torch.Generator,
                 stats: "MoEStats" = None, layer: int = 0):
        super().__init__()
        if first < 0 or first + count > n_experts:
            raise ValueError(f"held experts [{first}, {first + count}) "
                             f"outside the {n_experts} routed")
        self.n_experts, self.top_k, self.scaling = n_experts, top_k, scaling
        self.first, self.count = first, count
        self.stats, self.layer = stats, layer
        self._add_child("router", Router(dim, n_experts, std, generator))
        self._add_child("experts", HeldExperts(dim, hidden, count, std,
                                               generator))
        self._add_child("shared", SwiGLU(dim, n_shared * hidden, std,
                                         generator))

    def route(self, x: torch.Tensor):
        """(idx, w): the chosen experts (S, k) of x (S, dim) and their
        gates, f32."""
        router = self.router
        s = torch.sigmoid(F.linear(x.float(), router.weight.float()))
        idx = torch.topk(s + router.bias, self.top_k, dim=-1).indices
        g = s.gather(1, idx)
        return idx, g / (g.sum(-1, keepdim=True) + 1e-20) * self.scaling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        xs = x.reshape(b * t, d)
        with annotate("moe.route"):
            idx, w = self.route(xs)
        with annotate("moe.dispatch"):
            src, pos, offs, loads = dispatch_plan(idx, self.first,
                                                  self.count)
            if self.stats is not None and (
                    _profiler_enabled() or _tracer_enabled()):
                self.stats.add(self.layer, loads)
        routed = _RoutedExperts.apply(xs, self.experts.w_gate_up,
                                      self.experts.w_down, w, src, pos, offs)
        with annotate("moe.shared"):
            shared = self.shared(xs)
        with annotate("moe.combine"):
            return (routed.to(x.dtype) + shared).view(b, t, d)


def _tracer_enabled() -> bool:
    from bigdl_tpu_torch import obs

    return obs.get_tracer().enabled


__all__ = ["MoE", "SigmoidMoE", "MoEStats", "Router", "HeldExperts",
           "dispatch_plan", "GROUP_ROWS", "MOE_REGIONS"]
