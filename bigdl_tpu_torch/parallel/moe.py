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
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.nn.module import AbstractModule
from bigdl_tpu_torch.parallel.tensor_parallel import _CopyToGroup, constrain

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


__all__ = ["MoE"]
