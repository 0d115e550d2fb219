"""The port's flash kernels at a query offset against bigdl_tpu's.

``seq_offset`` places the query block at absolute positions
[seq_offset, seq_offset + Tq) of the kv sequence under causal masking
(chunked causal attention, JAX ``flash_attention``'s static argument).
On a CPU tensor the port runs the plain versions of the three kernels
(``flash_attention_plain``, ``flash_bwd_dq_plain``,
``flash_bwd_dkv_plain``), which the CUDA kernels are held to on the
card.  They must match ``jax.vjp`` of the JAX package's Pallas flash
attention in interpret mode at the same offset, and, at the ragged
lengths the JAX kernel does not take, ``jax.vjp`` of its lax reference.

Offsets: 0, 37 (not a multiple of the 64-row tiles), 128 and Tk − Tq
(every row sees every key its position allows up to the end).  Limits:
atol and rtol 1e-5 in f32 (both sides compute the same f32 products in
another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import attention as JA
from bigdl_tpu_torch.ops import attention as TA

ATOL, RTOL = 1e-5, 1e-5


def _inputs(b, h, tq, tk, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32)
                 for t in (tq, tk, tk, tq))


def _port(q, k, v, g, causal, off):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = TA.flash_attention(qt, kt, vt, causal=causal, seq_offset=off)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _jax(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_all(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=RTOL,
                               err_msg="out")
    for name, a, b in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("tq,tk", [(128, 256), (64, 192)])
@pytest.mark.parametrize("off", ["0", "37", "128", "tk-tq"])
@pytest.mark.parametrize("causal", [True, False])
def test_offset_matches_pallas_interpret(tq, tk, off, causal):
    off = tk - tq if off == "tk-tq" else int(off)
    q, k, v, g = _inputs(1, 2, tq, tk, 32, seed=tq + tk + off + causal)
    want = _jax(lambda q, k, v: JA.flash_attention(
        q, k, v, causal=causal, interpret=True, seq_offset=off), q, k, v, g)
    _assert_all(_port(q, k, v, g, causal, off), want)


@pytest.mark.parametrize("tq,tk,off", [(70, 133, 37), (70, 133, 63),
                                       (13, 200, 187), (100, 100, 5)])
def test_ragged_offset_matches_reference_vjp(tq, tk, off):
    """Tq not a multiple of 64 at offsets that break tile alignment,
    against JAX's lax reference at the same offset."""
    q, k, v, g = _inputs(1, 2, tq, tk, 32, seed=tq * tk + off)
    want = _jax(lambda q, k, v: JA._reference_attention(
        q, k, v, causal=True, scale=32 ** -0.5, seq_offset=off), q, k, v, g)
    _assert_all(_port(q, k, v, g, True, off), want)


@pytest.mark.parametrize("off", [0, 37, 128])
def test_plain_kernels_match_pallas_with_jax_lse(off):
    """The three plain versions called directly: the forward's O and
    lse, then dq and dkv from JAX's residuals (its lse reshaped to the
    port's (BH, Tq)), against JAX's ``_flash_forward`` /
    ``_flash_backward`` in interpret mode at the same offset."""
    b, h, tq, tk, d = 1, 2, 128, 256, 32
    scale = d ** -0.5
    q, k, v, g = _inputs(b, h, tq, tk, d, seed=off + 11)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = JA._flash_forward(jq, jk, jv, True, scale, True,
                                 with_lse=True, seq_offset=off)
    want = JA._flash_backward(jq, jk, jv, out, lse, jg, True, scale, True,
                              seq_offset=off)
    flat = [torch.from_numpy(x.reshape(b * h, -1, d)) for x in (q, k, v, g)]
    lse_t = torch.from_numpy(np.array(lse).reshape(b * h, tq))
    o_t, l_t = TA.flash_attention_plain(*flat[:3], causal=True, scale=scale,
                                        seq_offset=off)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(out).reshape(
        b * h, tq, d), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(l_t.numpy(), lse_t.numpy(), atol=ATOL,
                               rtol=RTOL)
    delta = torch.from_numpy((np.asarray(out) * g).sum(-1).reshape(b * h, tq))
    dq = TA.flash_bwd_dq_plain(*flat, lse_t, delta, causal=True, scale=scale,
                               seq_offset=off)
    dk, dv = TA.flash_bwd_dkv_plain(*flat, lse_t, delta, causal=True,
                                    scale=scale, seq_offset=off)
    for name, a, w in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w).reshape(
            a.shape), atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


def test_unreached_key_tiles_get_zero_gradient():
    """At offset 0 a 64-row query block against 256 keys reaches only
    the first key tile: dkv's loop runs no q tile for the other three,
    which must still come back as exact zeros."""
    q, k, v, g = _inputs(1, 1, 64, 256, 32, seed=3)
    _, (_, dk, dv) = _port(q, k, v, g, True, 0)
    assert not np.any(dk[..., 64:, :]) and not np.any(dv[..., 64:, :])
    assert np.any(dk[..., :64, :])


def test_dispatch_kernel_takes_the_offset():
    """``dot_product_attention(impl="kernel", seq_offset=k)`` runs the
    flash path (no raise) and equals the reference arm."""
    q, k, v, _ = _inputs(1, 2, 40, 90, 32, seed=9)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    kern = TA.dot_product_attention(q, k, v, causal=True, impl="kernel",
                                    seq_offset=50)
    ref = TA.dot_product_attention(q, k, v, causal=True, impl="reference",
                                   seq_offset=50)
    np.testing.assert_allclose(kern.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)
