"""The port's serving tier (``bigdl_tpu_torch.serving``) on the CPU.

The oracle is the JAX package's ``TransformerLM.generate`` at
temperature 0 (its Pallas flash prefill in interpret mode): the port's
``LMEngine`` must return the same tokens for requests admitted into the
middle of an in-flight batch and across a preemption refold, with the
decode attention on the dense path and on the paged kernel's plain
version."""

import threading

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_build
from bigdl_tpu_torch.serving import (LMEngine, PagedKVCache, RequestQueue,
                                     ServeRequest)
from bigdl_tpu_torch.serving.engine import HANDOFF_ERROR
from bigdl_tpu_torch.utils.convert import load_jax_params

SMALL = dict(dim=32, n_head=4, n_layer=2, max_len=64)


@pytest.fixture(scope="module")
def models():
    JRandom.RNG.set_seed(13)
    jm = j_build(48, attn_impl="pallas", **SMALL)
    TRandom.RNG.set_seed(0)
    tm = t_build(48, attn_impl="kernel", device="cpu", **SMALL)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    return jm, tm


@pytest.fixture(scope="module")
def oracle(models):
    """JAX generate() tokens, memoised per (prompt, n)."""
    jm, _ = models
    params = jm.params()
    memo = {}

    def ref(prompt, n):
        key = (tuple(int(t) for t in prompt), n)
        if key not in memo:
            memo[key] = [int(t) for t in np.asarray(jm.generate(
                params, np.asarray(prompt)[None, :], n))[0]]
        return memo[key]

    return ref


def _out(prompt, req):
    return [int(t) for t in list(prompt) + req.tokens]


@pytest.mark.parametrize("decode_attn", ["dense", "kernel"])
def test_mid_batch_admission_matches_jax_generate(models, oracle,
                                                  decode_attn):
    _, tm = models
    rs = np.random.RandomState(1)
    p1, p2, p3 = (rs.randint(0, 48, (n,)) for n in (5, 9, 4))
    eng = LMEngine(tm, max_batch=2, page_size=8, decode_attn=decode_attn,
                   device="cpu")
    r1 = eng.submit(p1, 10)
    r2 = eng.submit(p2, 3)
    for _ in range(3):     # r2 completes, r1 still in flight
        eng.pump()
    assert r2.done and not r1.done
    r3 = eng.submit(p3, 7)  # admitted into the freed slot
    eng.pump()
    assert eng.active_count() == 2
    eng.run_until_idle(60)
    eng.close()
    assert _out(p1, r1) == oracle(p1, 10)
    assert _out(p2, r2) == oracle(p2, 3)
    assert _out(p3, r3) == oracle(p3, 7)


@pytest.mark.parametrize("decode_attn", ["dense", "kernel"])
def test_preemption_refold_matches_jax_generate(models, oracle,
                                                decode_attn):
    _, tm = models
    rs = np.random.RandomState(2)
    p1, p2 = rs.randint(0, 48, (5,)), rs.randint(0, 48, (9,))
    # both requests cannot be resident at full length: the youngest is
    # preempted and re-prefilled with its generated prefix
    eng = LMEngine(tm, max_batch=2, page_size=4, num_pages=8,
                   decode_attn=decode_attn, device="cpu")
    a, b = eng.submit(p1, 12), eng.submit(p2, 12)
    eng.run_until_idle(120)
    assert eng.stats()["preemptions"] >= 1
    eng.close()
    assert _out(p1, a) == oracle(p1, 12)
    assert _out(p2, b) == oracle(p2, 12)


def test_engine_matches_port_generate_with_prompt_spanning_buckets(models):
    """A prompt that fills a page exactly and one that pads a 32-token
    bucket: prefill padding and trash-page writes leave the tokens
    equal to the port's own generate()."""
    _, tm = models
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 48, (n,)) for n in (8, 17, 30)]
    eng = LMEngine(tm, max_batch=4, page_size=8, decode_attn="kernel",
                   device="cpu")
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.run_until_idle(60)
    eng.close()
    for p, r in zip(prompts, reqs):
        want = tm.generate(p[None], 6)[0].tolist()
        assert _out(p, r) == want


def test_slot_and_page_reuse_and_stats(models):
    _, tm = models
    eng = LMEngine(tm, max_batch=2, page_size=8, num_pages=9, device="cpu")
    total = eng.cache.free_pages()
    for wave in range(3):
        reqs = [eng.submit([1 + wave, 2, 3], 4) for _ in range(2)]
        eng.run_until_idle(60)
        assert all(r.done and r.error is None for r in reqs)
        assert eng.cache.free_pages() == total
        assert eng.active_count() == 0
    st = eng.stats()
    assert st["requests"] == 6 and st["tokens"] == 24
    assert st["decode_attn"] == "auto" and st["preemptions"] == 0
    assert st["ttft_p50_s"] is not None and st["decode_ms_mean"] > 0
    eng.close()


def test_static_admission_drains_first(models):
    _, tm = models
    eng = LMEngine(tm, max_batch=2, page_size=8, admission="static",
                   device="cpu")
    r1 = eng.submit([1, 2, 3], 6)
    r2 = eng.submit([4, 5, 6], 2)
    eng.pump()
    eng.pump()                 # r2 done, r1 still decoding
    assert r2.done and not r1.done
    r3 = eng.submit([7, 8], 2)
    eng.pump()
    assert eng.active_count() == 1   # r3 waits for the batch to drain
    eng.run_until_idle(60)
    assert r1.done and r3.done
    eng.close()


def test_argument_checks(models):
    _, tm = models
    eng = LMEngine(tm, max_batch=2, page_size=4, num_pages=5, device="cpu")
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit([1, 2, 3], 40)   # needs 11 pages, the pool has 4
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1, 2, 3], 100)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], 3)
    eng.close()
    with pytest.raises(ValueError, match="decode_attn"):
        LMEngine(tm, decode_attn="pallas", device="cpu")
    with pytest.raises(ValueError, match="admission"):
        LMEngine(tm, admission="eager", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        LMEngine(tm, device="meta")


def test_background_loop_and_close_hands_off(models):
    _, tm = models
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu").start()
    done = eng.submit([3, 1, 4], 5).wait(timeout=60)
    assert done.error is None and len(done.tokens) == 5
    eng.close()
    # requests left when the engine closes finish with the handoff error
    eng2 = LMEngine(tm, max_batch=1, page_size=8, device="cpu")
    a, b = eng2.submit([1, 2], 20), eng2.submit([2, 3], 20)
    eng2.pump()
    eng2.close()
    assert a.done and b.done
    assert a.error == HANDOFF_ERROR and b.error == HANDOFF_ERROR


def test_paged_cache_allocator():
    c = PagedKVCache(2, 4, 8, page_size=4, num_pages=9, max_slots=2,
                     max_len=32, device="cpu")
    assert c.kp.shape == (2, 9, 4, 4, 8) and c.kp.dtype == torch.float32
    assert c.free_pages() == 8          # page 0 reserved as trash
    pages = c.alloc(0, 10)              # ceil(10/4) = 3 pages
    assert len(pages) == 3 and 0 not in pages
    assert list(c.page_tables[0][:3]) == pages
    c.lengths[0] = 12
    assert c.needs_growth(0) and c.grow(0)
    tables, lengths = c.device_tables(pages=2)
    assert tables.shape == (2, 2) and tables.dtype == torch.int32
    assert lengths.tolist() == [12, 0]
    c.release(0)
    assert c.free_pages() == 8 and not c.page_tables[0].any()


def test_request_queue_blocks_when_full_and_takes_greedily():
    q = RequestQueue(capacity=2)
    q.submit(ServeRequest(payload=[1]))
    q.submit(ServeRequest(payload=[2]))
    with pytest.raises(TimeoutError):
        q.submit(ServeRequest(payload=[3]), timeout=0.05)
    t = threading.Thread(target=q.submit, args=(ServeRequest(payload=[4]),))
    t.start()
    got = q.take(1)
    assert [r.payload for r in got] == [[1]]
    t.join(timeout=5)
    assert not t.is_alive()
    assert [r.payload for r in q.take(5)] == [[2], [4]]
    assert q.take(1, timeout=0.01) == []
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(ServeRequest(payload=[5]))
