"""The port's flash backward against bigdl_tpu/ops/attention.py.

``TA.flash_attention`` differentiated by torch autograd goes through the
port's ``_FlashAttention`` and, on a CPU tensor, the plain versions of
the two backward kernels (what the CUDA kernels are held to on the
card).  Its dq/dk/dv must match ``jax.vjp`` of the JAX package's Pallas
flash attention run in interpret mode (the ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` backward) on the same numpy inputs and
cotangent, and, at the ragged lengths the JAX kernel does not take,
``jax.vjp`` of its lax reference.

Limits: atol 2e-5, rtol 1e-5 in f32, the forward's limits
(``test_torch_port_attention.py``), tighter than the 1e-4 that JAX's own
tests hold its backward to (``tests/test_ops.py:64-66``): both sides
compute the same f32 products and differ only in summation order.  A
bf16 backward computes in f32 from the bf16 values and rounds once at
the end, so it must equal the f32 backward of the same values rounded
to bf16, exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import attention as JA
from bigdl_tpu_torch.ops import _cuda
from bigdl_tpu_torch.ops import attention as TA

ATOL, RTOL = 2e-5, 1e-5


def _inputs(b, h, tq, tk, d, seed):
    """q, k, v and the cotangent g as f32 numpy arrays."""
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32)
                 for t in (tq, tk, tk, tq))


def _port_grads(q, k, v, g, causal, dtype=torch.float32):
    qt, kt, vt = (torch.tensor(x, dtype=dtype, requires_grad=True)
                  for x in (q, k, v))
    out = TA.flash_attention(qt, kt, vt, causal=causal)
    return out, torch.autograd.grad(out, (qt, kt, vt),
                                    torch.tensor(g, dtype=dtype))


def _jax_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_grads(got, want):
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("t", [16, 64, 128, 256])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_pallas_backward_interpret(t, d, causal):
    q, k, v, g = _inputs(2, 2, t, t, d, seed=t + d + causal)
    want_out, want = _jax_grads(
        lambda q, k, v: JA.flash_attention(q, k, v, causal=causal,
                                           interpret=True), q, k, v, g)
    out, got = _port_grads(q, k, v, g, causal)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL,
                               rtol=RTOL)
    _assert_grads(got, want)


@pytest.mark.parametrize("tq,tk,causal", [(13, 13, True), (70, 70, True),
                                          (5, 130, False), (70, 9, False)])
def test_ragged_grads_match_reference_vjp(tq, tk, causal):
    """Ragged tiles, which the port masks and the JAX kernel never
    meets (it falls back to the lax reference and its vjp)."""
    q, k, v, g = _inputs(1, 2, tq, tk, 32, seed=tq * tk)
    _, want = _jax_grads(
        lambda q, k, v: JA._reference_attention(
            q, k, v, causal=causal, scale=32 ** -0.5), q, k, v, g)
    _, got = _port_grads(q, k, v, g, causal)
    _assert_grads(got, want)


@pytest.mark.parametrize("t,causal", [(128, False), (256, True)])
def test_plain_kernels_match_pallas_with_jax_lse_and_delta(t, causal):
    """``flash_bwd_dq_plain``/``flash_bwd_dkv_plain`` called directly
    with JAX's forward residuals: its lse (reshaped from its
    (BH, Tq/bq, bq) layout to the port's (BH, Tq)) and δ = rowsum(g∘O),
    against JAX's ``_flash_backward`` in interpret mode."""
    b, h, d = 1, 3, 32
    scale = d ** -0.5
    q, k, v, g = _inputs(b, h, t, t, d, seed=5 * t + causal)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = JA._flash_forward(jq, jk, jv, causal, scale, True,
                                 with_lse=True)
    want = JA._flash_backward(jq, jk, jv, out, lse, jg, causal, scale, True)
    flat = [torch.from_numpy(x.reshape(b * h, t, d)) for x in (q, k, v, g)]
    lse_t = torch.from_numpy(np.array(lse).reshape(b * h, t))
    delta = torch.from_numpy(
        (np.asarray(out) * g).sum(-1).reshape(b * h, t))
    dq = TA.flash_bwd_dq_plain(*flat, lse_t, delta, causal=causal,
                               scale=scale)
    dk, dv = TA.flash_bwd_dkv_plain(*flat, lse_t, delta, causal=causal,
                                    scale=scale)
    for name, a, w in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w).reshape(
            b * h, t, d), atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_is_the_f32_backward_rounded(causal):
    t, d = 96, 32
    q, k, v, g = (torch.from_numpy(x).reshape(4, t, d).bfloat16()
                  for x in _inputs(2, 2, t, t, d, seed=11 + causal))
    out, lse = TA.flash_attention_plain(q, k, v, causal=causal, scale=0.25)
    got = TA.flash_backward(q, k, v, out, lse, g, causal=causal, scale=0.25)
    want = TA.flash_backward(q.float(), k.float(), v.float(), out.float(),
                             lse, g.float(), causal=causal, scale=0.25)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16, name
        assert torch.equal(a, w.bfloat16()), f"d{name}"
    # and through autograd: gradients in the inputs' dtype, near f32
    qn, kn, vn, gn = (x.float().reshape(2, 2, t, d).numpy()
                      for x in (q, k, v, g))
    _, g16 = _port_grads(qn, kn, vn, gn, causal, dtype=torch.bfloat16)
    _, g32 = _port_grads(qn, kn, vn, gn, causal)
    for a, w in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        # the bf16 forward's rounded O feeds δ: within 1% of the largest
        # f32 gradient (8 significant bits each on O, g and the result)
        err = (a.float() - w).abs().max().item()
        assert err <= 1e-2 * w.abs().max().item()


def _bf16_parts(x, split):
    """``x`` as the bf16 operands the tensor-core kernels feed their
    second products: hi = bf16(x) and lo = bf16(x − hi), or hi alone."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _bf16_kernel_model(q, k, v, g, lse, delta, causal, scale, split):
    """dq, dk, dv in f32 as the bf16 kernels form them: S and dP from
    the bf16 operands summed in f32; P and dS enter dS·K, Pᵀ·dO and
    dSᵀ·Q as bf16 parts whose f32 products are summed.  Untiled: the
    order of the sums is not the point here."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale
    keep = torch.ones(s.shape[1:], dtype=torch.bool)
    if causal:
        keep = (torch.arange(s.shape[1])[:, None]
                >= torch.arange(s.shape[2])[None, :])
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros(()))
    ds = p * (torch.matmul(gf, vf.transpose(1, 2)) - delta[..., None])
    dq = sum(torch.matmul(x, kf) for x in _bf16_parts(ds, split)) * scale
    dk = sum(torch.matmul(x.transpose(1, 2), qf)
             for x in _bf16_parts(ds, split)) * scale
    dv = sum(torch.matmul(x.transpose(1, 2), gf)
             for x in _bf16_parts(p, split))
    return dq, dk, dv


@pytest.mark.parametrize("bh,tq,tk,d,causal", [(4, 128, 128, 64, True),
                                               (4, 70, 131, 32, False)])
def test_bf16_kernels_hi_lo_split_holds_the_f32_backward(bh, tq, tk, d,
                                                         causal):
    """Why the bf16 kernels carry P and dS as a bf16 hi + lo pair: the
    JAX kernels and the plain versions keep them in f32.  With the split
    the f32 sums stay within 2^-16 of the largest |gradient| and the
    bf16 result within one bf16 ulp of it (chip_smoke.py phase 10's
    limit); one rounding of P and dS to bf16 errs some 500 times more in
    f32, already as large as that ulp at these small shapes."""
    rs = np.random.RandomState(tq + tk + d)
    q, g = (torch.from_numpy(rs.randn(bh, tq, d).astype(np.float32))
            .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(bh, tk, d).astype(np.float32))
            .bfloat16() for _ in range(2))
    scale = d ** -0.5
    out, lse = TA.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    delta = (g.float() * out.float()).sum(dim=-1)

    def plain(*xs):
        return (TA.flash_bwd_dq_plain(*xs, lse, delta, causal=causal,
                                      scale=scale),
                *TA.flash_bwd_dkv_plain(*xs, lse, delta, causal=causal,
                                        scale=scale))

    want16 = plain(q, k, v, g)
    want32 = plain(q.float(), k.float(), v.float(), g.float())
    split = _bf16_kernel_model(q, k, v, g, lse, delta, causal, scale, True)
    single = _bf16_kernel_model(q, k, v, g, lse, delta, causal, scale, False)
    for name, a, b, w32, w16 in zip("qkv", split, single, want32, want16):
        mag = w32.abs().max().item()
        err = (a - w32).abs().max().item()
        assert err <= 2.0 ** -16 * mag, f"d{name}: {err / mag:.2e}"
        assert 50 * err < (b - w32).abs().max().item(), f"d{name}"
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        err16 = (a.bfloat16().float() - w16.float()).abs().max().item()
        assert err16 <= ulp, f"d{name}: {err16:.3e} > one ulp {ulp:.3e}"


def test_bf16_kernel_inputs_must_be_16_byte_aligned():
    """The bf16 kernels copy q, k, v and g in 16-byte pieces: a tensor
    that starts off a 16-byte boundary raises, naming it, and is never
    copied."""
    buf = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    TA._check_cp_async_aligned(q=buf[:64], k=buf[8:72])
    with pytest.raises(ValueError, match="bf16 k must start on a 16-byte "
                                         "boundary"):
        TA._check_cp_async_aligned(q=buf[:64], k=buf[1:65])


def test_cpu_autograd_runs_the_function_and_the_plain_backward(monkeypatch):
    """The routing the CUDA zero-gradient fault slipped through: the CPU
    path must differentiate through ``_FlashAttention`` and the plain
    backward kernels, not through autograd of ``flash_attention_plain``
    (whose ops torch would differentiate one by one)."""
    calls = {"dq": 0, "dkv": 0}
    dq_plain, dkv_plain = TA.flash_bwd_dq_plain, TA.flash_bwd_dkv_plain

    def dq(*a, **kw):
        calls["dq"] += 1
        return dq_plain(*a, **kw)

    def dkv(*a, **kw):
        calls["dkv"] += 1
        return dkv_plain(*a, **kw)

    monkeypatch.setattr(TA, "flash_bwd_dq_plain", dq)
    monkeypatch.setattr(TA, "flash_bwd_dkv_plain", dkv)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 40, 40, 16, 3))
    q.requires_grad_()
    out = TA.flash_attention(q, k, v, causal=True)
    # the graph: views around the Function, none of the plain forward's
    # matmuls, exps or masks
    names, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        names.add(type(node).__name__)
        todo += [n for n, _ in node.next_functions if n is not None]
    assert "_FlashAttentionBackward" in names
    assert names <= {"_FlashAttentionBackward", "ViewBackward0",
                     "AccumulateGrad"}, names
    dq_, = torch.autograd.grad(out, (q,), g)
    assert calls == {"dq": 1, "dkv": 1}
    assert torch.isfinite(dq_).all() and dq_.abs().max() > 0
    assert _cuda.launches["flash_bwd_dq"] == 0


def test_no_grad_calls_are_unchanged(monkeypatch):
    """Under ``torch.no_grad`` (the serving path) the call skips the
    Function and asks the forward for no lse, as before."""
    def refuse(*a, **kw):
        raise AssertionError("no_grad call went through _FlashAttention")

    monkeypatch.setattr(TA._FlashAttention, "apply", refuse)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 33, 33, 16, 9))
    for x in (q, k, v):
        x.requires_grad_()
    with torch.no_grad():
        out = TA.flash_attention(q, k, v, causal=True)
        both = TA.flash_attention(q, k, v, causal=True, with_lse=True)
    want, want_lse = TA.flash_attention_plain(
        *(x.detach().reshape(2, 33, 16) for x in (q, k, v)), causal=True,
        scale=0.25)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out.reshape(2, 33, 16), want)
    assert torch.equal(both[0], out) and torch.equal(both[1], want_lse)
    # and inputs that need no gradient skip it with grad enabled too
    out2 = TA.flash_attention(q.detach(), k.detach(), v.detach(),
                              causal=True)
    assert torch.equal(out2, out)
