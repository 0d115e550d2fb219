"""The port's TP-sharded decode (``LMEngine(tp=...)``, ``serving/tp.py``)
against bigdl_tpu.serving, on the CPU.

On JAX's serving fixture (vocab 48, dim 32, 4 heads, 2 layers,
``tests/test_serving.py:15-19``) in gloo processes through
``tests/torch_port_parallel_worker.py``, rank 0 leading and the others
following: ``LMEngine(tp=2)`` and ``LMEngine(tp=4)`` return the tokens
of JAX's ``LMEngine(tp=...)`` and of ``generate()`` for the prompts of
``tests/test_serving.py:191-201``, with the dense and the fused decode
attention; the int8 wire records what JAX's records (``serve_tp_psum``
among the counters, the ``path="serve"`` savings above 2, JAX's
``:203-219``) and still serves; int8 with tp and a tp that does not
divide the heads raise as JAX's engine does; at ``tp=2`` a swap the
leader flips between steps, a drain's handoff records and every logit
row sampled from equal the ``tp=1`` engine's (the logits within 1e-5:
the reductions add the ranks' partial sums in another order)."""

import json
import os
import sys

import numpy as np
import pytest

import jax

from bigdl_tpu import obs as jobs
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu.serving import LMEngine as JLMEngine

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__))))
import torch_port_parallel_worker as PW  # noqa: E402

WORLDS = [2, 4]


def _collectives() -> dict:
    out = {}
    metrics = jobs.get_registry().snapshot()["metrics"]
    for name, labels in (("bigdl_collective_bytes_total", ("op", "dtype")),
                         ("bigdl_collective_wire_savings_ratio", ("path",))):
        for s in metrics.get(name, {}).get("samples", []):
            key = "|".join((name,) + tuple(s["labels"][k] for k in labels))
            out[key] = s["value"]
    return out


@pytest.fixture(scope="module")
def jmodel():
    JRandom.RNG.set_seed(13)
    return j_build(48, attn_impl="xla", **PW.SERVE_LM)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jmodel):
    tmp = tmp_path_factory.mktemp("tp_decode")
    weights = PW.save_weights(str(tmp / "w.npz"), serve=jax.tree.map(
        np.asarray, jmodel.params()))
    return {w: PW.launch(tmp, w, "decode", weights) for w in WORLDS}


_JAX_TOKENS: dict = {}


def _jax_tokens(jmodel, tp=None) -> list:
    """JAX's tokens for the two prompts, from ``generate()`` or from its
    ``LMEngine(tp=...)``, laid out as the worker's (memoised)."""
    if tp not in _JAX_TOKENS:
        _JAX_TOKENS[tp] = _run_jax(jmodel, tp)
    return _JAX_TOKENS[tp]


def _run_jax(jmodel, tp) -> list:
    p1, p2 = PW.serve_prompts()
    if tp is None:
        params = jmodel.params()
        outs = [list(np.asarray(jmodel.generate(params, p[None], n))[0])
                for p, n in ((p1, 6), (p2, 3))]
    else:
        eng = JLMEngine(jmodel, max_batch=2, page_size=8, tp=tp)
        r1, r2 = eng.submit(p1, 6), eng.submit(p2, 3)
        eng.run_until_idle(120)
        eng.close()
        outs = [list(p1) + r1.tokens, list(p2) + r2.tokens]
    return [int(t) for t in outs[0]] + [-1] + [int(t) for t in outs[1]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("attn", ["dense", "fused"])
def test_tp_tokens_equal_jax_engine_and_generate(jmodel, ranks, world,
                                                 attn):
    want = _jax_tokens(jmodel)
    assert _jax_tokens(jmodel, tp=world) == want
    assert ranks[world][0][f"tokens_{attn}"].tolist() == want


@pytest.mark.parametrize("world", WORLDS)
def test_int8_wire_records_what_jax_records(jmodel, ranks, world):
    jobs.reset()
    JLMEngine(jmodel, max_batch=2, page_size=8, tp=world, wire="int8")
    want = _collectives()
    assert any("|serve_tp_psum|" in k for k in want)
    assert want["bigdl_collective_wire_savings_ratio|serve"] > 2.0
    for r in ranks[world]:
        assert json.loads(str(r["c_int8"])) == want
    toks = ranks[world][0]["tokens_int8"]
    assert len(toks) == 6 and all(0 <= t < 48 for t in toks)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["exclusive", "divide"])
def test_tp_errors_raise_as_jax(jmodel, ranks, world, key):
    kw = dict(int8=True, tp=2) if key == "exclusive" else dict(tp=3)
    with pytest.raises(ValueError, match=key) as jerr:
        JLMEngine(jmodel, **kw)
    for r in ranks[world]:
        assert str(r[f"error_{key}"]) == str(jerr.value)


@pytest.mark.parametrize("name", ["swap", "drain"])
def test_swap_and_drain_at_tp2_match_tp1(ranks, name):
    r = ranks[2][0]
    assert r[f"{name}_tp"].tolist() == r[f"{name}_tp1"].tolist()
    if name == "swap":
        toks = r["swap_tp"].tolist()
        assert toks[-2:] == [-2, 1]      # one swap, flipped on every rank
    else:
        recs = json.loads(str(r["drain_tp"]))
        assert len(recs) == 2 and all(x["tokens_done"] for x in recs)


def test_step_logits_at_tp2_match_tp1(ranks):
    r = ranks[2][0]
    assert r["logit_tokens_tp"].tolist() == r["logit_tokens_tp1"].tolist()
    # the prefill's row, then 5 steps of both slots
    assert r["logits_tp"].shape == r["logits_tp1"].shape == (11, 48)
    np.testing.assert_allclose(r["logits_tp"], r["logits_tp1"], rtol=1e-5,
                               atol=1e-5)
