"""bigdl_tpu_torch/ops/attention.py against bigdl_tpu/ops/attention.py.

The flash forward's plain version (what the port's wrapper runs on a
CPU tensor, and what the CUDA kernel is held to on the card) must match
the JAX package's Pallas flash kernel run in interpret mode, for the
output and for the per-row logsumexp.  Limits: atol 2e-5, rtol 1e-5 in
f32 (the two sum in different orders)."""

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
        TA.flash_attention(q, k, v, causal=True, seq_offset=4)
    with pytest.raises(ValueError, match="shapes"):
        TA.flash_attention(q, k[:, :1], v, causal=True)
    with pytest.raises(ValueError, match="dtype"):
        TA.flash_attention(q, k.double(), v, causal=True)


def test_cpu_tensors_never_launch_the_kernel():
    _cuda.reset_launches()
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 8, 8, 16, seed=5))
    TA.flash_attention(q, k, v, causal=True)
    assert _cuda.launches["flash_fwd"] == 0
