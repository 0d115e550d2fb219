"""bigdl_tpu_torch/ops/attention.py against bigdl_tpu/ops/attention.py.

The flash forward's plain version (what the port's wrapper runs on a
CPU tensor, and what the CUDA kernel is held to on the card) must match
the JAX package's Pallas flash kernel run in interpret mode, for the
output and for the per-row logsumexp.  Limits: atol 2e-5, rtol 1e-5 in
f32 (the two sum in different orders).  The bf16 kernel's arithmetic
(bf16 products summed in f32, P entering P·V as a bf16 hi + lo pair)
is modelled in torch and held to the Pallas kernel within one bf16 ulp
of the largest |o|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops import attention as JA
from bigdl_tpu_torch.ops import _cuda
from bigdl_tpu_torch.ops import attention as TA

ATOL, RTOL = 2e-5, 1e-5


def _qkv(b, h, tq, tk, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32)
                 for t in (tq, tk, tk))


@pytest.mark.parametrize("t", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_pallas_interpret(t, causal):
    q, k, v = _qkv(2, 2, t, t, 16, seed=t + causal)
    want = np.asarray(JA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    got = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_lse_matches_pallas_interpret(t, causal):
    b, h, d = 1, 3, 32
    q, k, v = _qkv(b, h, t, t, d, seed=7 * t + causal)
    scale = d ** -0.5
    out, lse = JA._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, scale, True,
                                 with_lse=True)
    want_lse = np.asarray(lse).reshape(b * h, t)
    got, got_lse = TA.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, with_lse=True)
    assert got_lse.shape == (b * h, t) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("tq,tk,causal", [(13, 13, True), (70, 70, True),
                                          (5, 130, False), (70, 9, False)])
def test_flash_plain_ragged_matches_reference(tq, tk, causal):
    """The port takes any Tq and Tk (the JAX kernel needs multiples of
    8): ragged tiles against the JAX lax reference."""
    q, k, v = _qkv(1, 2, tq, tk, 32, seed=tq * tk)
    want = np.asarray(JA._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=32 ** -0.5))
    got = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax_reference(causal):
    q, k, v = _qkv(2, 2, 24, 24, 16, seed=3)
    want = np.asarray(JA._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=0.25))
    got = TA._reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  scale=0.25)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_reference_fully_masked_rows_are_zero():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 4, 4, 8, seed=0))
    mask = torch.zeros((4, 4), dtype=torch.bool)
    mask[1:] = True
    out = TA._reference_attention(q, k, v, causal=False, scale=1.0,
                                  mask=mask)
    assert torch.isfinite(out).all()
    assert (out[0, 0, 0] == 0).all()


def test_bf16_inputs_keep_dtype_and_track_f32():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 32, 32, 16, seed=1))
    ref = TA.flash_attention(q, k, v, causal=True)
    got = TA.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=5e-2)


def test_dispatch_policy_and_impls():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 32, 32, 16, seed=2))
    ref = TA._reference_attention(q, k, v, causal=True, scale=0.25)
    auto = TA.dot_product_attention(q, k, v, causal=True)
    assert torch.equal(auto, ref)  # auto keeps the static reference policy
    kern = TA.dot_product_attention(q, k, v, causal=True, impl="kernel")
    np.testing.assert_allclose(kern.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="impl"):
        TA.dot_product_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="mask"):
        TA.dot_product_attention(q, k, v, impl="kernel",
                                 mask=torch.ones((32, 32), dtype=torch.bool))


def test_flash_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 8, 8, 16, seed=4))
    with pytest.raises(ValueError, match="seq_offset"):
        TA.flash_attention(q, k, v, causal=True, seq_offset=-1)
    with pytest.raises(ValueError, match="shapes"):
        TA.flash_attention(q, k[:, :1], v, causal=True)
    with pytest.raises(ValueError, match="dtype"):
        TA.flash_attention(q, k.double(), v, causal=True)


def test_cpu_tensors_never_launch_the_kernel():
    _cuda.reset_launches()
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 8, 8, 16, seed=5))
    TA.flash_attention(q, k, v, causal=True)
    assert _cuda.launches["flash_fwd"] == 0


def _bf16_parts(x, split):
    """``x`` as the bf16 operands the tensor-core forward feeds P·V:
    hi = bf16(x) and lo = bf16(x − hi), or hi alone."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _bf16_fwd_kernel_model(q, k, v, causal, scale, split):
    """O in f32 as the bf16 ``flash_fwd`` kernel forms it: S from the
    bf16 operands summed in f32, times scale; the online softmax over key
    tiles of ``BLOCK_K``; P = exp(S − m) entering P·V as bf16 parts whose
    f32 products are summed."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    qf, kf, vf = (x.float() for x in (q, k, v))
    m = torch.full((bh, tq), float("-inf"))
    l = torch.zeros((bh, tq))
    acc = torch.zeros((bh, tq, d))
    qpos = torch.arange(tq)[:, None]
    for k0 in range(0, tk, TA.BLOCK_K):
        k1 = min(k0 + TA.BLOCK_K, tk)
        s = torch.matmul(qf, kf[:, k0:k1].transpose(1, 2)) * scale
        if causal:
            s = s.masked_fill(~(qpos >= torch.arange(k0, k1)[None, :]),
                              float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        shift = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        p = torch.exp(s - shift[..., None])
        alpha = torch.where(torch.isfinite(m), torch.exp(m - shift),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + sum(
            torch.matmul(x, vf[:, k0:k1]) for x in _bf16_parts(p, split))
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("b,h,t,d,causal", [(2, 2, 128, 64, True),
                                            (1, 2, 192, 32, False)])
def test_bf16_forward_hi_lo_split_holds_the_f32_forward(b, h, t, d, causal):
    """Why the bf16 forward carries P as a bf16 hi + lo pair: the JAX
    kernel multiplies P in f32 by V in f32 (:171-174).  With the split
    the f32 output stays within 2^-16 of the largest |o| of JAX's
    (Pallas in interpret mode, on the same bf16 values in f32), and
    rounded to bf16 within one bf16 ulp of JAX's own bf16 forward
    (chip_smoke.py phase 3's limit); one rounding of P to bf16 errs over
    50 times more in f32."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(b, h, t, t, d, seed=t + d + causal))
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (q, k, v))
    want32 = torch.from_numpy(np.asarray(JA.flash_attention(
        jq, jk, jv, causal=causal, interpret=True))).reshape(b * h, t, d)
    want16 = JA.flash_attention(jq.astype(jnp.bfloat16),
                                jk.astype(jnp.bfloat16),
                                jv.astype(jnp.bfloat16), causal=causal,
                                interpret=True)
    assert want16.dtype == jnp.bfloat16
    want16 = torch.from_numpy(np.asarray(want16.astype(jnp.float32))
                              ).reshape(b * h, t, d)
    flat = [x.reshape(b * h, t, d) for x in (q, k, v)]
    split = _bf16_fwd_kernel_model(*flat, causal, scale, True)
    single = _bf16_fwd_kernel_model(*flat, causal, scale, False)
    mag = want32.abs().max().item()
    err = (split - want32).abs().max().item()
    assert err <= 2.0 ** -16 * mag, f"{err / mag:.2e}"
    assert 50 * err < (single - want32).abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    err16 = (split.bfloat16().float() - want16).abs().max().item()
    assert err16 <= ulp, f"{err16:.3e} > one ulp {ulp:.3e}"


def test_bf16_forward_inputs_must_be_16_byte_aligned():
    """The bf16 forward kernel copies q, k and v in 16-byte pieces: a
    tensor that starts off a 16-byte boundary raises, naming it, and is
    never copied; f32 inputs (the CUDA-core kernel) are not checked."""
    buf = torch.zeros(3 * 2 * 64 * 32 + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    n = 2 * 64 * 32
    q, k = buf[:n].view(2, 64, 32), buf[n:2 * n].view(2, 64, 32)
    v_off = buf[2 * n + 1:3 * n + 1].view(2, 64, 32)
    got = TA._flash_fwd_operands(q, k, buf[2 * n:3 * n].view(2, 64, 32))
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(got, (q, k)))
    with pytest.raises(ValueError, match="flash_attention: bf16 v must start "
                                         "on a 16-byte boundary"):
        TA._flash_fwd_operands(q, k, v_off)
    f32 = torch.zeros(3 * n + 1)
    TA._flash_fwd_operands(*(f32[i * n + 1:(i + 1) * n + 1].view(2, 64, 32)
                             for i in range(3)))
