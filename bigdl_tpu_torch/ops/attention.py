"""Scaled-dot-product attention: plain reference + flash attention.

Counterpart of ``bigdl_tpu/ops/attention.py``:

* ``_reference_attention`` (JAX :52) is plain torch, the default path;
* ``flash_attention`` is the flash forward (JAX ``_flash_fwd_kernel``,
  :120, launched at :356).  On a CUDA tensor it launches the
  hand-written kernel ``csrc/flash_fwd.cu`` (in bf16 on the tensor
  cores, P carried as a bf16 hi + lo pair; in f32 on the CUDA cores);
  on a CPU tensor it runs ``flash_attention_plain``, the same tiled
  online softmax in torch;
* its gradient is the blockwise flash backward (JAX
  ``_flash_attention_vjp``, :320-324, 519-623) in ``_FlashAttention``:
  the forward saves (q, k, v, out, lse) and ``flash_backward`` rebuilds
  the score tiles from lse.  On a CUDA tensor it launches
  ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu`` (JAX
  ``_flash_bwd_dq_kernel`` :390 and ``_flash_bwd_dkv_kernel`` :445); on a
  CPU tensor it runs ``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain``;
* ``dot_product_attention`` (JAX :679) dispatches between them.

``impl="auto"`` follows :func:`static_dispatch`, the JAX package's
static policy (JAX :631-676), which takes the kernel only on a TPU at
Tq·Tk >= 4096²: on this card and on the CPU it is the reference path.
With the auto-tuner on (``BIGDL_TORCH_TUNER=1``, ``ops/autotune.py``)
the cached per-shape search decides instead.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from bigdl_tpu_torch.ops import _cuda

# the kernels' q and key tiles, which the plain versions fold in the
# same steps
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (32, 64, 128)
# (q·k width, v width) pairs the kernels take: every D of HEAD_DIMS, and
# latent attention's 128 + 64 rotary dims against values of 128 (bf16)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)


def _reference_attention(q, k, v, *, causal: bool, scale: float,
                         mask=None, seq_offset: int = 0):
    """Plain softmax(q kᵀ) v over (B, H, Tq, D) x (B, H, Tk, D), f32
    scores, fully masked rows guarded to zeros (JAX :52-83)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(tq, device=q.device)[:, None] + seq_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        scores = scores.masked_fill(~(qpos >= kpos), float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    # a row max of -inf (fully masked row) shifts by 0, so the row is 0
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    unnorm = torch.exp(scores - row_max)
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / denom.clamp_min(1e-30)
    out = torch.matmul(probs, v.float())
    return out.to(q.dtype)


def _causal_tiles(tq: int, tk: int, causal: bool, seq_offset: int) -> int:
    """Key tiles of ``BLOCK_K`` that q rows [0, tq) reach: all of Tk's,
    or under ``causal`` up to the diagonal of the last row, at absolute
    position ``seq_offset + tq - 1`` (JAX ``_diag_kblocks``)."""
    n_tiles = -(-tk // BLOCK_K)
    if causal:
        n_tiles = min(n_tiles, -(-(seq_offset + tq) // BLOCK_K))
    return n_tiles


def flash_attention_plain(q, k, v, *, causal: bool, scale: float,
                          seq_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward in plain torch: q (BH, Tq, D) against k
    (BH, Tk, D) and v (BH, Tk, Dv), key tiles of ``BLOCK_K`` folded into
    a running f32 (m, l, acc).  Under ``causal`` query row i sits at
    absolute position ``seq_offset + i`` and sees keys 0..seq_offset + i.
    Returns O in q's dtype and the per-row logsumexp (BH, Tq) f32 in
    scaled-score units.  The arithmetic is the kernel's, tile for
    tile."""
    bh, tq, _ = q.shape
    tk = k.shape[1]
    qs = q.float() * scale
    m = torch.full((bh, tq), float("-inf"), device=q.device)
    l = torch.zeros((bh, tq), device=q.device)
    acc = torch.zeros((bh, tq, v.shape[-1]), device=q.device)
    qpos = torch.arange(tq, device=q.device)[:, None] + seq_offset
    n_tiles = _causal_tiles(tq, tk, causal, seq_offset)
    for kt in range(n_tiles):
        k0, k1 = kt * BLOCK_K, min((kt + 1) * BLOCK_K, tk)
        ks = k[:, k0:k1].float()
        vs = v[:, k0:k1].float()
        s = torch.matmul(qs, ks.transpose(1, 2))            # (BH, Tq, bk)
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill(~(qpos >= kpos), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        shift = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        p = torch.exp(s - shift[..., None])
        alpha = torch.where(torch.isfinite(m), torch.exp(m - shift),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vs)
        m = m_new
    lc = l.clamp_min(1e-30)
    out = (acc / lc[..., None]).to(q.dtype)
    return out, m + torch.log(lc)


def _check_flash_args(q, k, v, seq_offset):
    if not isinstance(seq_offset, int) or seq_offset < 0:
        raise ValueError(f"seq_offset must be an int >= 0, got {seq_offset!r}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants (B, H, T, D) q, k and v")
    if k.shape[:-1] != v.shape[:-1] or q.shape[:2] != k.shape[:2] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k and v differ in dtype")


def flash_bwd_dq_plain(q, k, v, g, lse, delta, *, causal: bool,
                       scale: float, seq_offset: int = 0) -> torch.Tensor:
    """dQ of the flash backward in plain torch (JAX
    ``_flash_bwd_dq_kernel``, :390-442): q (BH, Tq, D), g (BH, Tq, Dv),
    k (BH, Tk, D), v (BH, Tk, Dv), lse/delta (BH, Tq) f32.  Key tiles of
    ``BLOCK_K`` up to the causal diagonal (query row i at position
    ``seq_offset + i``); per tile ``P = exp(scale·q·kᵀ − lse)``,
    ``dP = g·vᵀ``, ``dS = P∘(dP − δ)``, ``dq += dS·k``; at the end
    ``dq *= scale``.  f32 arithmetic, the result in q's dtype."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    qs = q.float() * scale
    gf = g.float()
    acc = torch.zeros((bh, tq, d), device=q.device)
    qpos = torch.arange(tq, device=q.device)[:, None] + seq_offset
    n_tiles = _causal_tiles(tq, tk, causal, seq_offset)
    for kt in range(n_tiles):
        k0, k1 = kt * BLOCK_K, min((kt + 1) * BLOCK_K, tk)
        ks = k[:, k0:k1].float()
        vs = v[:, k0:k1].float()
        s = torch.matmul(qs, ks.transpose(1, 2))            # (BH, Tq, bk)
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill(~(qpos >= kpos), float("-inf"))
        p = torch.exp(s - lse[..., None])
        dp = torch.matmul(gf, vs.transpose(1, 2))
        ds = p * (dp - delta[..., None])
        acc = acc + torch.matmul(ds, ks)
    return (acc * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, *, causal: bool,
                        scale: float, seq_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of the flash backward in plain torch (JAX
    ``_flash_bwd_dkv_kernel``, :445-516), shapes as
    :func:`flash_bwd_dq_plain`.  For each key tile of ``BLOCK_K``, q
    tiles of ``BLOCK_Q`` from the causal lower bound
    ``q0 = ⌊max(k0 − seq_offset, 0) / BLOCK_Q⌋`` (:499-504); a key tile
    that no query reaches keeps zeros.  Per tile ``dv += Pᵀ·g`` and
    ``dk += dSᵀ·(scale·q)``.  f32 arithmetic, the results in k's and v's
    dtype."""
    bh, tq, d = q.shape
    tk, dvw = k.shape[1], v.shape[-1]
    qs = q.float() * scale
    gf = g.float()
    dk = torch.zeros((bh, tk, d), device=q.device)
    dv = torch.zeros((bh, tk, dvw), device=q.device)
    for kt in range(-(-tk // BLOCK_K)):
        k0, k1 = kt * BLOCK_K, min((kt + 1) * BLOCK_K, tk)
        ks = k[:, k0:k1].float()
        vs = v[:, k0:k1].float()
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        acc_dk = torch.zeros((bh, k1 - k0, d), device=q.device)
        acc_dv = torch.zeros((bh, k1 - k0, dvw), device=q.device)
        lo = max(k0 - seq_offset, 0) // BLOCK_Q if causal else 0
        for qt in range(lo, -(-tq // BLOCK_Q)):
            q0, q1 = qt * BLOCK_Q, min((qt + 1) * BLOCK_Q, tq)
            s = torch.matmul(qs[:, q0:q1], ks.transpose(1, 2))  # (BH, bq, bk)
            if causal:
                qpos = torch.arange(q0, q1, device=q.device)[:, None] \
                    + seq_offset
                s = s.masked_fill(~(qpos >= kpos), float("-inf"))
            p = torch.exp(s - lse[:, q0:q1, None])
            acc_dv = acc_dv + torch.matmul(p.transpose(1, 2), gf[:, q0:q1])
            dp = torch.matmul(gf[:, q0:q1], vs.transpose(1, 2))
            ds = p * (dp - delta[:, q0:q1, None])
            acc_dk = acc_dk + torch.matmul(ds.transpose(1, 2), qs[:, q0:q1])
        dk[:, k0:k1] = acc_dk
        dv[:, k0:k1] = acc_dv
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_args(q, v):
    dims = (q.shape[-1], v.shape[-1])
    if dims not in HEAD_DIM_PAIRS:
        raise ValueError(f"the flash kernels take (D, Dv) in "
                         f"{HEAD_DIM_PAIRS}, got {dims}")
    if q.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"the flash kernels take f32 or bf16, got {q.dtype}")
    if dims[0] != dims[1] and q.dtype != torch.bfloat16:
        raise ValueError(f"the flash kernels take (D, Dv) = {dims} in bf16 "
                         f"only, got {q.dtype}")


def _check_cp_async_aligned(who: str = "flash_backward", **tensors) -> None:
    """The bf16 kernels copy their (BH, T, D) inputs into shared memory
    in 16-byte pieces (``cp.async``): each must start on a 16-byte
    boundary.  Raises, naming ``who`` and the tensor, rather than
    copying."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(
                f"{who}: bf16 {name} must start on a 16-byte "
                f"boundary for the kernels' 16-byte copies, got address "
                f"{x.data_ptr():#x}")


def _flash_fwd_operands(q, k, v):
    """q, k and v as the ``flash_fwd`` kernel takes them: checked,
    contiguous and, in bf16 (the tensor-core kernel), 16-byte aligned,
    or a ValueError."""
    _check_kernel_args(q, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16:
        _check_cp_async_aligned("flash_attention", q=q, k=k, v=v)
    return q, k, v


def _flash_forward(q, k, v, *, causal: bool, scale: float, with_lse: bool,
                   seq_offset: int = 0):
    """The flash forward over flat (BH, T, D) tensors: (O, lse or None).
    In bf16 the kernel runs on the tensor cores and wants q, k and v
    16-byte aligned (checked after ``contiguous``); in f32 it runs on
    the CUDA cores."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     seq_offset=seq_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    q, k, v = _flash_fwd_operands(q, k, v)
    out = q.new_empty(q.shape[:2] + v.shape[2:])
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
           if with_lse else None)
    _cuda.launch_flash_fwd(q, k, v, out, lse, causal=causal, scale=scale,
                           seq_offset=seq_offset)
    return out, lse


def flash_backward(q, k, v, out, lse, g, *, causal: bool, scale: float,
                   seq_offset: int = 0):
    """The blockwise flash backward over flat (BH, T, D) tensors (JAX
    ``_flash_backward``, :519-595): (dq, dk, dv) in the dtypes of q, k
    and v.  ``δ = rowsum(g∘out)`` in f32 is plain torch, as JAX leaves it
    to XLA (:538-541).  A CUDA tensor goes to the ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` kernels, and anything they do not take raises; a
    CPU tensor goes to the plain versions.  In bf16 the kernels run on
    the tensor cores and want q, k, v and g 16-byte aligned (checked
    here, after ``contiguous``); in f32 they run on the CUDA cores."""
    delta = (g.float() * out.float()).sum(dim=-1)
    if q.device.type == "cpu":
        dq = flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal,
                                scale=scale, seq_offset=seq_offset)
        dk, dv = flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                     scale=scale, seq_offset=seq_offset)
        return dq, dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward: unsupported device {q.device}")
    _check_kernel_args(q, v)
    q, k, v, lse = q.contiguous(), k.contiguous(), v.contiguous(), \
        lse.contiguous()
    g = g.to(q.dtype).contiguous()
    if q.dtype == torch.bfloat16:
        _check_cp_async_aligned(q=q, k=k, v=v, g=g)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _cuda.launch_flash_bwd_dq(q, k, v, g, lse, delta, dq, causal=causal,
                              scale=scale, seq_offset=seq_offset)
    _cuda.launch_flash_bwd_dkv(q, k, v, g, lse, delta, dk, dv,
                               causal=causal, scale=scale,
                               seq_offset=seq_offset)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention over flat (BH, T, D) q, k, v with the blockwise
    backward (JAX ``_flash_attention_vjp``, :320-324, 598-623): the
    forward saves (q, k, v, out, lse), the backward is
    :func:`flash_backward`.  Returns (out, lse); lse takes no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, seq_offset):
        out, lse = _flash_forward(q, k, v, causal=causal, scale=scale,
                                  with_lse=True, seq_offset=seq_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.seq_offset = causal, scale, seq_offset
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, causal=ctx.causal,
                                    scale=ctx.scale,
                                    seq_offset=ctx.seq_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, seq_offset: int = 0,
                    with_lse: bool = False):
    """Flash attention over (B, H, Tq, D) q, (B, H, Tk, D) k and
    (B, H, Tk, Dv) v; any Tq and Tk.  Returns O (B, H, Tq, Dv), or
    (O, lse) with lse (B·H, Tq) f32 when ``with_lse``.  ``seq_offset``
    (an int >= 0, JAX's meaning) places the query block at absolute
    positions [seq_offset, seq_offset + Tq) of the kv sequence under
    ``causal`` (chunked causal attention); it is ignored when ``causal``
    is False.

    A CUDA tensor goes to the ``flash_fwd`` kernel ((D, Dv) in
    ``HEAD_DIM_PAIRS``: D = Dv in 32/64/128, f32 or bf16, or (192, 128) in
    bf16; bf16 q, k and v 16-byte aligned after ``contiguous``), and
    anything that kernel does not take raises; a CPU
    tensor goes to :func:`flash_attention_plain`.  Where grad is enabled
    and an input requires it, the call goes through ``_FlashAttention``,
    whose backward is :func:`flash_backward`: dq, dk and dv come back in
    the dtypes of q, k and v."""
    _check_flash_args(q, k, v, seq_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, tq, d = q.shape
    tk, dv = k.shape[2], v.shape[-1]
    qr = q.reshape(b * h, tq, d)
    kr = k.reshape(b * h, tk, d)
    vr = v.reshape(b * h, tk, dv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(qr, kr, vr, causal, scale,
                                         seq_offset)
    else:
        out, lse = _flash_forward(qr, kr, vr, causal=causal, scale=scale,
                                  with_lse=with_lse, seq_offset=seq_offset)
    out = out.reshape(b, h, tq, dv)
    return (out, lse) if with_lse else out


def static_dispatch(q_shape, k_shape, v_shape, dtype, *,
                    mask_is_none: bool = True, seq_offset=0,
                    backend: Optional[str] = None):
    """The ``impl="auto"`` policy as a function of static shapes (JAX
    :631-676): ``(impl, plan)``, impl "kernel" where JAX's is "pallas"
    (a "tpu" backend, a shape that tiles by 128 and Tq·Tk >= 4096²) and
    "reference" everywhere else, this card (backend "gpu") and the CPU
    included.  The plan is always None: the port's kernels take any T
    with one 64x64 tile shape, so JAX's VMEM guard and superblock plans
    have no counterpart.  ``backend`` defaults to the tuner's platform
    ("gpu" where CUDA is available, else "cpu")."""
    t = q_shape[-2]
    tk = k_shape[-2]
    tiles = (
        mask_is_none
        and tuple(k_shape) == tuple(v_shape)
        and tuple(q_shape[:2]) == tuple(k_shape[:2])
        and q_shape[-1] == k_shape[-1]
        and t >= 128 and t % 128 == 0
        and tk >= 128 and tk % 128 == 0
        and isinstance(seq_offset, int) and seq_offset >= 0
    )
    if backend is None:
        from bigdl_tpu_torch.ops import autotune

        backend = autotune.platform()
    impl = ("kernel" if backend == "tpu" and tiles and t * tk >= 4096 * 4096
            else "reference")
    return impl, None


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          scale: Optional[float] = None, impl: str = "auto",
                          seq_offset: int = 0):
    """Attention entry point used by ``nn.MultiHeadAttention``.

    q, k, v: (batch, heads, seq, head_dim).  impl: "auto"
    (:func:`static_dispatch`, "reference" on this card; with
    ``BIGDL_TORCH_TUNER=1`` the cached auto-tuner decision for the shape
    overrides it), "reference", or "kernel" (:func:`flash_attention`).
    A masked call has one candidate, the reference, and never asks the
    tuner."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto":
        from bigdl_tpu_torch.ops import autotune

        impl, plan = static_dispatch(
            q.shape, k.shape, v.shape, q.dtype, mask_is_none=mask is None,
            seq_offset=seq_offset, backend=autotune.platform(q.device))
        if mask is None and autotune.enabled():
            decision = autotune.decide_attention(
                q.shape, k.shape, q.dtype, causal=causal,
                seq_offset=seq_offset, static_impl=impl, plan=plan,
                arrays=(q, k, v))
            if decision is not None:
                impl = decision["impl"]
    if impl == "kernel":
        if mask is not None:
            raise ValueError("the flash kernel has no explicit-mask support;"
                             " use impl='reference'")
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               seq_offset=seq_offset)
    if impl != "reference":
        raise ValueError(f"impl must be auto|reference|kernel, got {impl!r}")
    return _reference_attention(q, k, v, causal=causal, scale=scale,
                                mask=mask, seq_offset=seq_offset)


__all__ = ["dot_product_attention", "static_dispatch", "flash_attention",
           "flash_attention_plain", "flash_backward", "flash_bwd_dq_plain",
           "flash_bwd_dkv_plain"]
