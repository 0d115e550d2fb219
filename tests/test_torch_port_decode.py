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
    assert TD.decode_hbm_bytes("dense", 8, 8, 16, 16, 4) == \
        JD.decode_hbm_bytes("dense", 8, 8, 16, 16, 4)
    # the port's fused is a torch body, not XLA's fused gather: it pays
    # dense's gathered copy and score plane, plus an f32 widening copy
    # of a narrower cache, where JAX counts the ideal read
    assert TD.decode_hbm_bytes("fused", 8, 8, 16, 16, 4) == \
        TD.decode_hbm_bytes("dense", 8, 8, 16, 16, 4)
    n_kv = 2.0 * 8 * 4 * 16 * 8 * 16
    assert TD.decode_hbm_bytes("fused", 8, 8, 16, 16, 4, 2) == \
        TD.decode_hbm_bytes("dense", 8, 8, 16, 16, 4, 2) + 2.0 * n_kv * 4
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
                                  impl="pallas")
    fused = TD.paged_decode_attention(q, kp, vp, tbl, lens, page_size=8,
                                      impl="fused")
    assert fused.shape == dense.shape
    with pytest.raises(ValueError, match="page_size"):
        TD.paged_decode(q, kp, vp, tbl, lens, page_size=4)
    with pytest.raises(ValueError, match="tables"):
        TD.paged_decode(q, kp, vp, tbl[:2], lens, page_size=8)
    _cuda.reset_launches()
    TD.paged_decode(q, kp, vp, tbl, lens, page_size=8)
    assert _cuda.launches["paged_decode"] == 0  # a CPU tensor: plain version


# the split-KV kernel's work units: up to ROWS key rows of one page; a
# CTA's warps take the units of its split in turn
ROWS, WARPS = 16, 4


def _fold(state, s, v):
    """Fold scores s (n,) and value rows v (n, Dh) into (m, l, acc) as a
    warp does, in f32."""
    m, l, acc = state
    m_new = max(m, float(s.max()))
    shift = np.float32(m_new if np.isfinite(m_new) else 0.0)
    alpha = np.float32(np.exp(np.float32(m) - shift)) if np.isfinite(m) \
        else np.float32(0.0)
    p = np.exp(s - shift).astype(np.float32)
    return (m_new, np.float32(l * alpha + p.sum(dtype=np.float32)),
            (acc * alpha + p @ v).astype(np.float32))


def _merge(states):
    """Merge (m, l, acc) states in the given order: the CTA's warps, then
    the merge kernel's splits."""
    mx = max(st[0] for st in states)
    shift = np.float32(mx if np.isfinite(mx) else 0.0)
    l = np.float32(0.0)
    acc = np.zeros_like(states[0][2])
    for m, lw, a in states:
        sc = np.float32(np.exp(np.float32(m) - shift)) if np.isfinite(m) \
            else np.float32(0.0)
        l = np.float32(l + lw * sc)
        acc = (acc + a * sc).astype(np.float32)
    return mx, l, acc


def _split_decode_model(q, kp, vp, tbl, lens, p, splits):
    """The paged_decode kernel's arithmetic in numpy f32: split s of a
    slot takes its live columns [s·cps, (s+1)·cps) with cps =
    ceil(live / S), each split's warps fold their units of up to ROWS
    rows, the warps' states merge in order, then the S splits' partials
    merge in order into acc / max(l, 1e-30)."""
    b, h, d = q.shape
    maxp = tbl.shape[1]
    qs = q.astype(np.float32) * np.float32(d ** -0.5)
    out = np.zeros((b, h, d), np.float32)
    empty = (-np.inf, np.float32(0.0), np.zeros(d, np.float32))
    for i in range(b):
        npos = max(0, min(int(lens[i]) + 1, maxp * p))
        live = -(-npos // p)
        cps = -(-live // splits)
        for hh in range(h):
            parts = []
            for s in range(splits):
                c0 = min(s * cps, live)
                c1 = min(c0 + cps, live)
                units = [(col, r0) for col in range(c0, c1)
                         for r0 in range(0, p, ROWS) if col * p + r0 < npos]
                warps = [empty] * WARPS
                for u, (col, r0) in enumerate(units):
                    n = min(ROWS, p - r0, npos - col * p - r0)
                    rows = slice(r0, r0 + n)
                    ks = kp[tbl[i, col], hh, rows].astype(np.float32)
                    vs = vp[tbl[i, col], hh, rows].astype(np.float32)
                    warps[u % WARPS] = _fold(warps[u % WARPS],
                                             ks @ qs[i, hh], vs)
                parts.append(_merge(warps))
            _, l, acc = _merge(parts)
            out[i, hh] = acc / max(l, np.float32(1e-30))
    return out


# (lengths, page size, table width, splits): empty splits (a slot shorter
# than its S), S that does not divide the bucket, a single live page,
# lengths at a page boundary (P - 1, P, 2P - 1), S = 1, and pages of 32
# rows (two units each)
SPLIT_CASES = [
    ([5, 0, 30, 1], 8, 4, 3),
    ([31, 16, 7, 8], 8, 5, 2),
    ([3, 3, 3, 3], 8, 2, 4),
    ([7, 8, 15, 23], 8, 3, 2),
    ([20, 9, 0, 12], 8, 4, 1),
    ([40, 63, 31, 32], 32, 2, 2),
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: f"len{c[0]}_P{c[1]}_maxp{c[2]}_S{c[3]}")
def test_split_kv_model_matches_pallas_interpret(case):
    """The split-KV kernel's arithmetic (splits of the live pages,
    warps' units of up to 16 rows, partials merged in fixed order) is
    JAX's ``_decode_kernel`` run in interpret mode, within 1e-5 in f32;
    trash page 0 holds 1e30 and is never read for a live slot."""
    lens, p, maxp, splits = case
    b = len(lens)
    pool = 1 + b * maxp
    q, kp, vp, tbl, lengths = _state(b=b, h=2, d=32, p=p, maxp=maxp,
                                     pool=pool, seed=sum(lens),
                                     lengths=lens)
    kp[0] = 1e30
    vp[0] = 1e30
    want = _jax((q, kp, vp, tbl, lengths), p, "pallas_interpret")
    got = _split_decode_model(q, kp, vp, tbl, lengths, p, splits)
    live = lengths > 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL)
    np.testing.assert_allclose(got[live], _torch((q, kp, vp, tbl, lengths),
                                                 p, "kernel")[live],
                               atol=ATOL)


def test_decode_splits_fill_the_card_and_count_in_the_bytes():
    """Two CTAs an SM at the serving batch, at most one split a table
    column, at least one; the kernel's bytes add its partials'."""
    assert TD.decode_splits(8, 8, 32) == 5           # 320 CTAs on 132 SMs
    assert TD.decode_splits(8, 8, 2) == 2
    assert TD.decode_splits(1, 8, 64) == 33
    assert TD.decode_splits(64, 8, 32) == 1
    assert TD.decode_splits(8, 8, 32, sms=16) == 1
    split = 2.0 * 8 * 8 * 5 * (64 + 2) * 4
    # JAX's fused count is the ideal read: the pages once, q and out
    assert TD.decode_hbm_bytes("kernel", 8, 8, 64, 16, 32) == \
        JD.decode_hbm_bytes("fused", 8, 8, 64, 16, 32) + split
    assert TD.decode_hbm_bytes("kernel", 64, 8, 64, 16, 32) == \
        JD.decode_hbm_bytes("fused", 64, 8, 64, 16, 32)
