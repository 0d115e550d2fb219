"""The port's live weight rollout (``publish_checkpoint``,
``CheckpointWatcher``, ``CanaryController``, ``divergence_probe``) and
the specs of ``TransformerLM`` and its layers, against the JAX package
on the CPU.

Limits: a module saved by one package and loaded by the other gives
logits within 1e-5 of the saver's (the same f32 weights; matmuls summed
in other orders) and bit-equal weights; the specs equal JAX's; a
watcher's swap, a refusal and its reason equal JAX's watcher's on the
same published files, and temperature-0 tokens after the swap equal
exactly; the canary's decisions equal JAX's under the same virtual
clock and signal series (a hypothesis property).  Directories come
from ``tmp_path``; both packages' telemetry is reset around each
test."""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from bigdl_tpu import obs as jobs
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu.nn import attention as JA
from bigdl_tpu.serving import LMEngine as JEngine
from bigdl_tpu.serving import rollout as jroll
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import obs
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_build
from bigdl_tpu_torch.nn import attention as TA
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.serving import (CanaryController, CheckpointWatcher,
                                     LMEngine, publish_checkpoint,
                                     token_divergence)
from bigdl_tpu_torch.serving import rollout as troll
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils.convert import load_jax_params

TINY = dict(dim=32, n_head=4, n_layer=2, max_len=64)
VOCAB = 64
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    for var in ("BIGDL_TORCH_REQTRACE_SAMPLE", "BIGDL_TORCH_TRACE_DIR",
                "BIGDL_TORCH_OBS_STRICT", "BIGDL_TORCH_ROLLOUT_WATCH",
                "BIGDL_REQTRACE_SAMPLE", "BIGDL_TRACE_DIR",
                "BIGDL_ROLLOUT_WATCH", "BIGDL_FAULT_PLAN"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_lm(seed, attn_impl="xla"):
    JRandom.RNG.set_seed(seed)
    return j_build(VOCAB, attn_impl=attn_impl, **TINY)


def _port_lm(jm, attn_impl="reference"):
    tm = t_build(VOCAB, attn_impl=attn_impl, device="cpu", **TINY)
    load_jax_params(tm, _np(jm.params()))
    return tm


def _tokens(seed=0, n=(2, 9)):
    return np.random.RandomState(seed).randint(0, VOCAB, n).astype(np.int32)


def _port_logits(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


def _jax_logits(jm, x):
    out, _ = jm.apply(jm.params(), jm.state(), x)
    return np.asarray(out)


def _ref(jm, prompt, n):
    return [int(t) for t in np.asarray(jm.generate(
        jm.params(), np.asarray(prompt)[None, :], n))[0]]


def _counter(name, **labels):
    fams = {f.name: f for f in obs.get_registry().families()}
    fam = fams.get(name)
    if fam is None:
        return 0.0
    return sum(c.value for key, c in fam.child_items()
               if all(dict(zip(fam.labelnames, key)).get(k) == v
                      for k, v in labels.items()))


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("build", [
    lambda M: M.LayerNorm(16, eps=1e-6),
    lambda M: M.MultiHeadAttention(16, 4, causal=True, with_bias=False),
    lambda M: M.TransformerBlock(16, 2, mlp_ratio=2, dropout=0.1),
    lambda M: M.PositionalEmbedding(12, 16),
], ids=["layernorm", "mha", "block", "positional"])
def test_attention_layer_specs_equal_jax(build):
    """Each layer records JAX's config keys and values."""
    assert build(TA).get_config() == build(JA).get_config()


def test_transformer_lm_and_embedding_specs_equal_jax():
    jm = j_build(VOCAB, attn_impl="auto", remat=True, dropout=0.1, **TINY)
    tm = t_build(VOCAB, attn_impl="auto", remat=True, dropout=0.1,
                 device="cpu", **TINY)
    assert TS.module_to_spec(tm) == JS.module_to_spec(jm)
    assert TT.TokenEmbedding(VOCAB, 8).get_config() == \
        {"vocab_size": VOCAB, "dim": 8}
    # attn_impl in the JAX package's words, both ways
    assert t_build(VOCAB, attn_impl="kernel", device="cpu",
                   **TINY).get_config()["attn_impl"] == "pallas"
    assert t_build(VOCAB, attn_impl="reference", device="cpu",
                   **TINY).get_config()["attn_impl"] == "lax"
    assert t_build(VOCAB, attn_impl="pallas_interpret", device="cpu",
                   **TINY).attn_impl == "kernel"


def test_port_saved_lm_loads_in_jax(tmp_path):
    """Port save_module -> JAX load_module: the same weights (exactly)
    and logits within 1e-5."""
    tm = _port_lm(_jax_lm(3))
    path = TS.save_module(tm, str(tmp_path / "lm"))
    jm = JS.load_module(path)
    assert type(jm).__name__ == "TransformerLM"
    x = _tokens(1)
    want = _port_logits(tm, x)
    got = _jax_logits(jm, x)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(_np(jm.params())),
            TS.T.leaves_with_paths(tm.params())):
        np.testing.assert_array_equal(a, b.detach().numpy())


def test_jax_saved_lm_loads_in_the_port(tmp_path):
    """JAX save_module -> port load_module (built on the CPU, the JAX
    attn_impl read as the port's): logits within 1e-5."""
    jm = _jax_lm(4, attn_impl="xla")
    path = JS.save_module(jm, str(tmp_path / "lm"))
    tm = TS.load_module(path)
    assert tm.device == torch.device("cpu")
    assert tm.attn_impl == "reference" and tm.n_layer == TINY["n_layer"]
    x = _tokens(2)
    want = _jax_logits(jm, x)
    got = _port_logits(tm, x)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


# ---------------------------------------------------------------- watcher
@pytest.fixture(scope="module")
def models():
    """(JAX model v0, port model v0, JAX model v1, port model v1)."""
    j0, j1 = _jax_lm(11), _jax_lm(12)
    return j0, _port_lm(j0), j1, _port_lm(j1)


def test_publish_then_watchers_swap_like_jax(tmp_path, models):
    """The port publishes v1; the port's watcher and JAX's watcher each
    verify and swap it into their engine; tokens after the swap equal
    JAX's engine's and generate() on v1's weights."""
    j0, t0, j1, t1 = models
    d = str(tmp_path)
    te = LMEngine(_port_lm(j0), max_batch=2, page_size=8, device="cpu")
    je = JEngine(j0, j0.params(), max_batch=2, page_size=8)
    tw, jw = CheckpointWatcher(te, d), jroll.CheckpointWatcher(je, d)
    try:
        assert tw.poll_once() is None and jw.poll_once() is None
        prefix = publish_checkpoint(t1, d, "v1")
        assert sorted(os.listdir(d)) == ["v1.manifest.json",
                                         "v1.model.npz"]
        assert tw.poll_once() == "v1" and jw.poll_once() == "v1"
        assert tw.poll_once() is None
        assert (te.weight_version, te.manifest_sha) == \
            (je.weight_version, je.manifest_sha)
        assert te.manifest_sha == troll.manifest_digest(prefix) \
            == jroll.manifest_digest(prefix)
        p = [7, 3, 9, 12]
        tr, jr = te.submit(p, 6), je.submit(p, 6)
        te.run_until_idle(60)
        je.run_until_idle(120)
    finally:
        te.close()
        je.close()
    assert tr.tokens == [int(t) for t in jr.tokens]
    assert p + tr.tokens == _ref(j1, p, 6)
    assert tw.stats()["swapped"] == ["v1"]
    assert _counter(names.SERVE_WEIGHT_SWAPS_TOTAL, version="v1") == 1


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupted_publish_refused_like_jax(tmp_path, models, damage):
    """A publish damaged after its manifest: both watchers refuse it with
    the same reason, count it, and never swap; a manifest-less prefix
    is skipped, not refused."""
    j0, t0, j1, t1 = models
    d = str(tmp_path)
    prefix = publish_checkpoint(t1, d, "v2")
    with open(prefix + ".model.npz", "r+b") as fh:
        if damage == "flip":
            fh.seek(100)
            byte = fh.read(1)
            fh.seek(100)
            fh.write(bytes([byte[0] ^ 0x01]))
        else:
            fh.truncate(os.path.getsize(prefix + ".model.npz") // 2)
    TS.save_module(t1, os.path.join(d, "v3.model"))   # no manifest yet
    te = LMEngine(t0, max_batch=2, page_size=8, device="cpu")
    je = JEngine(j0, j0.params(), max_batch=2, page_size=8)
    tw, jw = CheckpointWatcher(te, d), jroll.CheckpointWatcher(je, d)
    try:
        assert tw.poll_once() is None and jw.poll_once() is None
        assert tw.poll_once() is None
    finally:
        te.close()
        je.close()
    assert tw.rejected == jw.rejected and list(tw.rejected) == [prefix]
    assert te.weight_version == "v0" and te.swaps == 0
    reason = "checksum" if damage == "flip" else "size"
    assert reason in tw.rejected[prefix]
    assert _counter(names.ROLLOUT_REJECTED_TOTAL, reason=reason) == 1
    assert troll._reason_class(tw.rejected[prefix]) == reason


def test_watcher_needs_a_directory(models):
    _, t0, _, _ = models
    eng = LMEngine(t0, max_batch=2, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="BIGDL_TORCH_ROLLOUT_WATCH"):
        CheckpointWatcher(eng)
    eng.close()


# ----------------------------------------------------------------- canary
class _Fleet:
    def __init__(self, names_):
        self.versions = {n: "v0" for n in names_}
        self.calls = []

    def set_version(self, name, version):
        self.calls.append(("set", name, version))
        self.versions[name] = version

    def drain(self, name):
        self.calls.append(("drain", name))

    def undrain(self, name):
        self.calls.append(("undrain", name))


def _run_canary(mod, n_replicas, script, kw):
    """Drive one controller through ``script``: ("offer", version, t) or
    ("eval", divergence, burn, t).  Returns everything it decided."""
    fleet = _Fleet([f"r{i}" for i in range(n_replicas)])
    sig = {"div": 0.0, "alerts": []}
    ctl = mod.CanaryController(
        sorted(fleet.versions), set_version=fleet.set_version,
        incumbent="v0", measure_divergence=lambda: sig["div"],
        alerts=lambda: list(sig["alerts"]), drain=fleet.drain,
        undrain=fleet.undrain, clock=lambda: 0.0, **kw)
    out = []
    for step in script:
        if step[0] == "offer":
            out.append(("offer", ctl.offer(step[1], now=step[2])))
        else:
            sig["div"] = step[1]
            sig["alerts"] = [mod.SLO_BURN_ALERT] if step[2] else []
            out.append(("eval", ctl.evaluate(now=step[3])))
        out.append(("state", ctl.stats(), dict(fleet.versions)))
    return out, fleet.calls, ctl.rollbacks, ctl.promotions


_steps = st.lists(st.one_of(
    st.tuples(st.just("offer"), st.sampled_from(["v1", "v2", "v3"])),
    st.tuples(st.just("eval"), st.sampled_from([0.0, 0.04, 0.05, 0.3]),
              st.booleans())), min_size=1, max_size=25)


@settings(max_examples=60, deadline=None)
@given(steps=_steps, n_replicas=st.integers(1, 8),
       fraction=st.sampled_from([0.1, 0.25, 0.5]),
       for_count=st.integers(1, 3), hold_evals=st.integers(1, 3),
       dts=st.lists(st.floats(0.0, 20.0), min_size=25, max_size=25))
def test_canary_decisions_equal_jax(steps, n_replicas, fraction, for_count,
                                    hold_evals, dts):
    """The same offers and signal series on the same virtual clock: the
    same offers refused, evaluations, promotions, rollbacks (with their
    drain, revert, undrain order) and cooldown refusals."""
    script, t = [], 0.0
    for step, dt in zip(steps, dts):
        t += dt
        script.append(step + (t,))
    kw = dict(fraction=fraction, divergence_threshold=0.05,
              for_count=for_count, hold_evals=hold_evals, cooldown_s=30.0)
    assert _run_canary(troll, n_replicas, script, kw) == \
        _run_canary(jroll, n_replicas, script, kw)


def test_canary_rollback_drains_reverts_undrains_and_counts():
    script = [("offer", "v1", 0.0), ("eval", 0.5, False, 1.0),
              ("eval", 0.0, False, 2.0), ("eval", 0.5, False, 3.0),
              ("eval", 0.5, False, 4.0), ("offer", "v2", 10.0),
              ("offer", "v2", 40.0)]
    out, calls, rollbacks, _ = _run_canary(
        troll, 8, script, dict(fraction=0.25, for_count=2, hold_evals=3,
                               cooldown_s=30.0))
    assert [o[1] for o in out if o[0] == "offer"] == [True, False, True]
    assert calls[2:8] == [("drain", "r0"), ("set", "r0", "v0"),
                          ("undrain", "r0"), ("drain", "r1"),
                          ("set", "r1", "v0"), ("undrain", "r1")]
    assert rollbacks == [{"version": "v1", "reason": "divergence",
                          "t": 4.0}]
    assert _counter(names.ROLLOUT_ROLLBACKS_TOTAL,
                    reason="divergence") == 1
    with pytest.raises(ValueError, match="at least 1 replica"):
        CanaryController([], set_version=lambda n, v: None, incumbent="v0")


def test_divergence_probe_and_token_divergence_equal_jax():
    prompts = [[1, 2], [3], [4, 5, 6]]

    def canary(p, n):
        return [(t * 7) % 5 for t in p][:n] + [0] * (n - len(p))

    def incumbent(p, n):
        out = list(canary(p, n))
        if p[0] == 4:
            out[-1] += 1        # one token of four differs
        return out

    for a, b in (([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 9]), ([], []),
                 ([4], [5, 6, 7])):
        assert token_divergence(a, b) == jroll.token_divergence(a, b)
    assert troll.divergence_probe(canary, incumbent, prompts, 4)() == \
        jroll.divergence_probe(canary, incumbent, prompts, 4)() == 0.25
