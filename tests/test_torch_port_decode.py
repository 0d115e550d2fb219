"""bigdl_tpu_torch/ops/decode_attention.py against
bigdl_tpu/ops/decode_attention.py.

The paged flash-decode's plain version (what the port's wrapper runs on
a CPU tensor, and what the CUDA kernel is held to on the card) and the
dense path must match the JAX package's Pallas decode kernel run in
interpret mode and its dense path, across ragged lengths and page
boundaries, and finite garbage (1e30) in trash page 0 must never reach
a live slot.  Limit: atol 1e-5 in f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops import decode_attention as JD
from bigdl_tpu.serving.cache import gather_pages as j_gather_pages
from bigdl_tpu_torch.ops import _cuda
from bigdl_tpu_torch.ops import decode_attention as TD
from bigdl_tpu_torch.serving.cache import gather_pages

ATOL = 1e-5


def _state(b=4, h=4, d=16, p=8, maxp=8, pool=24, seed=0, lengths=None):
    """Random paged state with ragged lengths and a permuted page table;
    slot 0 is inactive (length 0, trash table row)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, d).astype(np.float32)
    kp = rs.randn(pool, h, p, d).astype(np.float32)
    vp = rs.randn(pool, h, p, d).astype(np.float32)
    if lengths is None:
        lengths = [0, p - 1, p, min(3 * p - 1, maxp * p - 1)][:b]
        lengths += [1] * (b - len(lengths))
    tbl = np.zeros((b, maxp), np.int32)
    free = list(range(1, pool))
    rs.shuffle(free)
    for i, ln in enumerate(lengths):
        need = ln // p + 1 if ln else 0
        for j in range(min(need, maxp)):
            tbl[i, j] = free.pop()
    return q, kp, vp, tbl, np.asarray(lengths, np.int32)


def _jax(state, p, impl):
    q, kp, vp, tbl, lens = (jnp.asarray(x) for x in state)
    return np.asarray(JD.paged_decode_attention(q, kp, vp, tbl, lens,
                                                page_size=p, impl=impl))


def _torch(state, p, impl):
    q, kp, vp, tbl, lens = (torch.from_numpy(x) for x in state)
    return TD.paged_decode_attention(q, kp, vp, tbl, lens, page_size=p,
                                     impl=impl).numpy()


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_matches_pallas_interpret_and_dense(impl):
    state = _state(b=3, h=2, d=8, p=4, maxp=4, pool=16)
    got = _torch(state, 4, impl)
    np.testing.assert_allclose(got, _jax(state, 4, "pallas_interpret"),
                               atol=ATOL)
    np.testing.assert_allclose(got, _jax(state, 4, "dense"), atol=ATOL)


@pytest.mark.parametrize("length", [1, 7, 8, 9, 15, 16, 17, 23])
def test_across_page_boundaries(length):
    state = _state(b=2, maxp=3, seed=length, lengths=[length, 1])
    want = _jax(state, 8, "pallas_interpret")
    for impl in ("dense", "kernel"):
        np.testing.assert_allclose(_torch(state, 8, impl), want, atol=ATOL)


def test_dense_matches_jax_dense_ragged():
    state = _state()
    np.testing.assert_allclose(_torch(state, 8, "dense"),
                               _jax(state, 8, "dense"), atol=ATOL)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_trash_page_never_read(impl):
    q, kp, vp, tbl, lens = _state()
    clean = _torch((q, kp, vp, tbl, lens), 8, impl)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 1e30
    vp2[0] = 1e30
    dirty = _torch((q, kp2, vp2, tbl, lens), 8, impl)
    live = lens > 0
    np.testing.assert_array_equal(dirty[live], clean[live])
    assert np.isfinite(dirty[live]).all()


def test_plain_skips_columns_past_every_live_page():
    """A bucket wider than the live pages changes nothing."""
    q, kp, vp, tbl, lens = _state(lengths=[5, 9, 0, 12], maxp=8)
    narrow = _torch((q, kp, vp, tbl[:, :2], lens), 8, "kernel")
    wide = _torch((q, kp, vp, tbl, lens), 8, "kernel")
    np.testing.assert_array_equal(narrow, wide)


def test_bf16_cache_with_f32_query():
    q, kp, vp, tbl, lens = (torch.from_numpy(x) for x in _state(seed=3))
    ref = TD.paged_decode(q, kp, vp, tbl, lens, page_size=8)
    got = TD.paged_decode(q, kp.bfloat16(), vp.bfloat16(), tbl, lens,
                          page_size=8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-2)


def test_helpers_match_jax():
    for args in [(0, 8, 8), (7, 8, 8), (8, 8, 8), (23, 8, 8), (63, 8, 8),
                 (1000, 8, 8), (511, 16, 32)]:
        assert TD.used_page_bucket(*args) == JD.used_page_bucket(*args)
    for impl in ("dense", "fused"):
        assert TD.decode_hbm_bytes(impl, 8, 8, 16, 16, 4) == \
            JD.decode_hbm_bytes(impl, 8, 8, 16, 16, 4)
    pages = np.arange(3 * 2 * 4 * 5, dtype=np.float32).reshape(3, 2, 4, 5)
    table = np.asarray([[2, 1], [0, 0]], np.int32)
    np.testing.assert_array_equal(
        gather_pages(torch.from_numpy(pages), torch.from_numpy(table)).numpy(),
        np.asarray(j_gather_pages(jnp.asarray(pages), jnp.asarray(table))))


def test_dispatch_and_validation():
    q, kp, vp, tbl, lens = (torch.from_numpy(x) for x in _state())
    auto = TD.paged_decode_attention(q, kp, vp, tbl, lens, page_size=8)
    dense = TD.paged_decode_attention(q, kp, vp, tbl, lens, page_size=8,
                                      impl="dense")
    assert torch.equal(auto, dense)
    with pytest.raises(ValueError, match="impl"):
        TD.paged_decode_attention(q, kp, vp, tbl, lens, page_size=8,
                                  impl="fused")
    with pytest.raises(ValueError, match="page_size"):
        TD.paged_decode(q, kp, vp, tbl, lens, page_size=4)
    with pytest.raises(ValueError, match="tables"):
        TD.paged_decode(q, kp, vp, tbl[:2], lens, page_size=8)
    _cuda.reset_launches()
    TD.paged_decode(q, kp, vp, tbl, lens, page_size=8)
    assert _cuda.launches["paged_decode"] == 0  # a CPU tensor: plain version
