"""The port's kernel auto-tuner against bigdl_tpu/ops/autotune.py.

Mirrors ``tests/test_autotune.py`` class by class where the behaviour
is shared, in the port's words ("reference"/"kernel" where the JAX
package says "lax"/"pallas"): the golden key format and the JSON
store's contract, the tuner-off pinning of ``static_dispatch`` against
JAX's at the same shapes and backends, never losing to the static
policy (the same fake timings and costs go into both packages'
``_resolve`` and must crown the same winner), the regression gate
(``obs/regress.check`` against JAX's on the same trajectories), the
CPU search that never proposes the kernel, and the decision flow.  The
port's own contracts follow: the clones a measurement times never reach
the caller's graph, nothing is measured during a CUDA graph capture,
and a failing kernel candidate raises instead of dropping out.  JAX's
symmetric VMEM guard and superblock plans have no counterpart; one test
says why."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.obs import regress as JRG
from bigdl_tpu.ops import attention as JA
from bigdl_tpu.ops import autotune as JT
from bigdl_tpu_torch.obs import regress as TRG
from bigdl_tpu_torch.ops import attention as TA
from bigdl_tpu_torch.ops import autotune as TT
from bigdl_tpu_torch.ops import conv_bn as TC

# the JAX package's labels in the port's words
PORT_LABEL = {"lax": "reference", "pallas_x": "kernel"}


@pytest.fixture(autouse=True)
def _tuner_off_by_default(monkeypatch):
    for v in ("BIGDL_TORCH_TUNER", "BIGDL_TORCH_TUNER_CACHE",
              "BIGDL_TORCH_TUNER_MEASURE", "BIGDL_TUNER", "BIGDL_TUNER_CACHE",
              "BIGDL_TUNER_MEASURE"):
        monkeypatch.delenv(v, raising=False)
    TT.reset()
    JT.reset()
    yield
    TT.reset()
    JT.reset()


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """The port's tuner on, with a fresh cache file."""
    cache = tmp_path / "tuner.json"
    monkeypatch.setenv("BIGDL_TORCH_TUNER", "1")
    monkeypatch.setenv("BIGDL_TORCH_TUNER_CACHE", str(cache))
    TT.reset()
    return cache


def _decide_attn(**kw):
    args = dict(causal=True, seq_offset=0, static_impl="reference",
                plan=None, device="cpu")
    args.update(kw)
    return TT.decide_attention((1, 2, 128, 16), (1, 2, 256, 16),
                               torch.float32, **args)


# ------------------------------------------------------------ cache keys
class TestCacheStore:
    @pytest.mark.parametrize("site,shape,tdt,jdt,plat,extra", [
        ("attn", "b1h2tq128tk256d16", torch.bfloat16, jnp.bfloat16, "tpu",
         "c1o0"),
        ("conv_bn_kxk", "n2c8h8w8o16k3s2p1", torch.float32, jnp.float32,
         "cpu", ""),
        ("decode_attn", "b8h8d64p16m4", "bfloat16", jnp.bfloat16, "gpu", ""),
    ])
    def test_golden_key_format(self, site, shape, tdt, jdt, plat, extra):
        key = TT.cache_key(site, shape, tdt, plat, extra=extra)
        assert key == JT.cache_key(site, shape, jdt, plat, extra=extra)
        assert TT.cache_key("attn", "b1h2tq128tk256d16", torch.bfloat16,
                            "tpu", extra="c1o0") == \
            "attn|b1h2tq128tk256d16|bfloat16|tpu|c1o0"

    def test_miss_then_hit_and_persistence(self, tuner):
        d1 = _decide_attn()
        assert d1 is not None and d1["source"] in ("model", "measured")
        stats = TT.get_cache().stats()
        assert stats["misses"] == 1 and stats["hits"] == 0
        d2 = _decide_attn()
        assert d2["impl"] == d1["impl"]
        assert TT.get_cache().stats()["hits"] == 1
        doc = json.load(open(tuner, encoding="utf-8"))
        assert doc["version"] == 1
        assert list(doc["decisions"]) == [
            "attn|b1h2tq128tk256d16|float32|cpu|c1o0"]
        # a fresh process (reset) on the same file: a hit
        TT.reset()
        assert _decide_attn()["source"] == d1["source"]
        assert TT.get_cache().stats() == {
            "path": str(tuner), "entries": 1, "hits": 1, "misses": 0,
            "corrupt": False}

    def test_platform_mismatch_is_a_miss(self, tuner):
        gpu_key = "attn|b1h2tq128tk256d16|float32|gpu|c1o0"
        tuner.write_text(json.dumps({
            "version": 1,
            "decisions": {gpu_key: {"impl": "kernel", "site": "attn",
                                    "label": "rigged",
                                    "static": "reference"}}}))
        TT.reset()
        d = _decide_attn()
        assert d["impl"] == "reference"     # a fresh CPU search
        stats = TT.get_cache().stats()
        assert stats["misses"] == 1 and stats["hits"] == 0
        doc = json.load(open(tuner, encoding="utf-8"))
        assert len(doc["decisions"]) == 2  # the gpu entry kept beside it

    def test_corrupt_cache_falls_back_to_static(self, tuner):
        tuner.write_text("{definitely not json")
        TT.reset()
        assert TT.get_cache().corrupt
        d = _decide_attn()
        assert d["source"] == "corrupt_cache" and d["impl"] == "reference"
        assert tuner.read_text() == "{definitely not json"

    def test_cache_rebuilt_when_path_changes(self, tmp_path, monkeypatch):
        monkeypatch.setenv("BIGDL_TORCH_TUNER", "1")
        monkeypatch.setenv("BIGDL_TORCH_TUNER_CACHE", str(tmp_path / "a.json"))
        c1 = TT.get_cache()
        monkeypatch.setenv("BIGDL_TORCH_TUNER_CACHE", str(tmp_path / "b.json"))
        c2 = TT.get_cache()
        assert c1 is not c2 and c2.path.endswith("b.json")


# ------------------------------------------------- tuner-off pinning
class TestTunerOffPinning:
    # JAX test_autotune.py's grid, plus this card's backend
    CASES = [
        ((1, 8, 512, 64), (1, 8, 512, 64), "cpu"),
        ((1, 8, 4096, 64), (1, 8, 4096, 64), "cpu"),
        ((1, 8, 512, 64), (1, 8, 512, 64), "tpu"),
        ((1, 8, 2048, 64), (1, 8, 2048, 64), "tpu"),
        ((1, 8, 4096, 64), (1, 8, 4096, 64), "tpu"),
        ((1, 8, 2048, 128), (1, 8, 32768, 128), "tpu"),
        ((1, 8, 32768, 128), (1, 8, 2048, 128), "tpu"),
        ((1, 8, 4104, 64), (1, 8, 4104, 64), "tpu"),
        ((2, 8, 4096, 64), (2, 8, 4096, 64), "gpu"),
        ((16, 8, 512, 64), (16, 8, 512, 64), "gpu"),
    ]

    @pytest.mark.parametrize("qs,ks,backend", CASES)
    @pytest.mark.parametrize("mask_is_none", [True, False])
    def test_static_dispatch_pinned_to_jax(self, qs, ks, backend,
                                           mask_is_none):
        want, _ = JA.static_dispatch(qs, ks, ks, jnp.bfloat16,
                                     mask_is_none=mask_is_none,
                                     backend=backend)
        impl, plan = TA.static_dispatch(qs, ks, ks, torch.bfloat16,
                                        mask_is_none=mask_is_none,
                                        backend=backend)
        assert impl == PORT_LABEL["pallas_x" if want == "pallas" else want]
        assert plan is None

    def test_this_card_is_always_reference(self):
        for qs, ks, _ in self.CASES:
            assert TA.static_dispatch(qs, ks, ks, torch.bfloat16,
                                      backend="gpu")[0] == "reference"

    def test_tuner_off_never_consults_autotune(self, monkeypatch):
        def boom(*a, **kw):  # pragma: no cover - must not run
            raise AssertionError("tuner consulted while disabled")

        for name in ("decide_attention", "decide_conv_bn",
                     "decide_decode_attn", "decide_int8_mm"):
            monkeypatch.setattr(TT, name, boom)
        from bigdl_tpu_torch.ops import (decode_attention, int8_matmul,
                                         quantize_per_channel)

        q = torch.ones((1, 2, 128, 16))
        out = TA.dot_product_attention(q, q, q, causal=True)
        assert torch.equal(out, TA._reference_attention(
            q, q, q, causal=True, scale=0.25))
        x = torch.ones((1, 4, 8, 8))
        w = torch.ones((8, 4, 3, 3))
        TC.conv_bn_stats(x, w, torch.zeros(8), stride=1, pad=1)
        qd = torch.ones((2, 2, 16))
        pool = torch.ones((3, 2, 4, 16))
        decode_attention.paged_decode_attention(
            qd, pool, pool, torch.ones((2, 2), dtype=torch.int32),
            torch.ones(2, dtype=torch.int32), page_size=4)
        wq, ws = quantize_per_channel(torch.ones((4, 16)))
        int8_matmul(torch.ones((3, 16)), wq, ws, impl="auto", device="cpu")


# -------------------------------------------------- never lose to static
def _port_candidates():
    return {"reference": {"impl": "reference"}, "kernel": {"impl": "kernel"}}


def _jax_candidates():
    return {"lax": {"impl": "lax", "blocks": None},
            "pallas_x": {"impl": "pallas", "blocks": [64, 64, 128, 64]}}


def _both_resolve(monkeypatch, tmp_path, times, analytic):
    """The same timings (static's, then the other's) or costs through
    both packages' ``_resolve``: (port record, JAX record)."""
    for pre in ("BIGDL_TORCH_", "BIGDL_"):
        monkeypatch.setenv(pre + "TUNER", "1")
        monkeypatch.setenv(pre + "TUNER_CACHE",
                           str(tmp_path / f"{pre}cache.json"))
        if times:
            monkeypatch.setenv(pre + "TUNER_MEASURE", "1")
    TT.reset()
    JT.reset()
    out = []
    for mod, cands, static, arrays in (
            (TT, _port_candidates(), "reference", (torch.ones((2, 2)),)),
            (JT, _jax_candidates(), "lax", (jnp.ones((2, 2)),))):
        seq = iter(times)
        monkeypatch.setattr(mod, "_measure",
                            lambda probe, args, iters: next(seq))
        labels = list(cands)
        costs = {lbl: a for lbl, a in zip(labels, analytic)}
        probes = {lbl: (lambda x: x) for lbl in labels} if times else {}
        out.append(mod._resolve("attn", "test|k|f32|cpu", cands, static,
                                costs, probes, arrays))
    return out


class TestNeverLosesToStatic:
    def _resolve(self, monkeypatch, times):
        monkeypatch.setenv("BIGDL_TORCH_TUNER_MEASURE", "1")
        seq = iter(times)
        monkeypatch.setattr(TT, "_measure", lambda probe, args, iters:
                            next(seq))
        analytic = {"reference": (1e6, 1e6), "kernel": (1e6, 1e6)}
        probes = {"reference": lambda x: x, "kernel": lambda x: x * 2}
        return TT._resolve("attn", f"test|{len(times)}x{times[0]}|f32|cpu",
                           _port_candidates(), "reference", analytic,
                           probes, (torch.ones((2, 2)),))

    def test_static_kept_on_loss(self, tuner, monkeypatch):
        rec = self._resolve(monkeypatch, [0.001, 0.002])
        assert rec["label"] == "reference" and rec["source"] == "measured"

    def test_faster_candidate_wins_and_is_gated(self, tuner, monkeypatch):
        rec = self._resolve(monkeypatch, [0.002, 0.001])
        assert rec["label"] == "kernel"
        assert rec["gate"]["status"] == "pass"
        assert rec["measured_s"]["kernel"] < rec["measured_s"]["reference"]

    def test_regress_gate_flags_a_regression(self):
        v = TT._gate_measured("kernel", 2.0, "reference", 1.0)
        assert v["status"] == "violation" and v["ratio"] == 2.0
        assert v == JT._gate_measured("pallas_x", 2.0, "lax", 1.0) | {
            "violations": v["violations"]}
        v = TT._gate_measured("kernel", 0.9, "reference", 1.0)
        assert v["status"] == "pass"

    def test_model_decision_must_beat_static(self, tuner):
        analytic = {"reference": (1e6, 1e6), "kernel": (1e6, 1e6)}
        rec = TT._resolve("attn", "test|model-tie|f32|cpu",
                          _port_candidates(), "reference", analytic, {},
                          None)
        assert rec["label"] == "reference" and rec["source"] == "model"

    def test_model_impl_flip_needs_decisive_margin(self, tuner):
        analytic = {"reference": (1e6, 1e9), "kernel": (1e6, 0.75e9)}
        rec = TT._resolve("attn", "test|model-margin-1|f32|cpu",
                          _port_candidates(), "reference", analytic, {},
                          None)
        assert rec["label"] == "reference"
        analytic = {"reference": (1e6, 1e9), "kernel": (1e6, 1e8)}
        rec = TT._resolve("attn", "test|model-margin-2|f32|cpu",
                          _port_candidates(), "reference", analytic, {},
                          None)
        assert rec["label"] == "kernel" and rec["source"] == "model"

    @pytest.mark.parametrize("times", [
        [0.001, 0.002], [0.002, 0.001], [0.001, 0.001], [0.0020, 0.00199],
        [1.0, 0.4]])
    def test_measured_winners_match_jax(self, tmp_path, monkeypatch, times):
        """Label for label where the other candidate is slower or faster
        by more than ``_MEASURE_MARGIN``; inside it the port calls a tie
        and keeps static, where the JAX package takes any faster one."""
        port, jax_rec = _both_resolve(monkeypatch, tmp_path, times,
                                      [(1e6, 1e6), (1e6, 1e6)])
        assert port["source"] == jax_rec["source"] == "measured"
        static_s, other_s = times
        if (1 - TT._MEASURE_MARGIN) * static_s <= other_s < static_s:
            assert jax_rec["label"] == "pallas_x"
            assert port["label"] == "reference" and "gate" not in port
            return
        assert port["label"] == PORT_LABEL[jax_rec["label"]]
        assert (port.get("gate") or {}).get("status") == \
            (jax_rec.get("gate") or {}).get("status")

    @pytest.mark.parametrize("other_s, label", [
        (0.00199, "reference"), (0.00191, "reference"),
        (0.0019, "reference"), (0.00189, "kernel")])
    def test_a_win_inside_the_margin_is_a_tie(self, tuner, monkeypatch,
                                               other_s, label):
        """The static candidate at 2 ms: another must come in under
        (1 - 0.05) x 2 = 1.9 ms to take the site."""
        assert TT._MEASURE_MARGIN == 0.05
        rec = self._resolve(monkeypatch, [0.002, other_s])
        assert rec["label"] == label and rec["source"] == "measured"
        assert ("gate" in rec) == (label == "kernel")

    @pytest.mark.parametrize("analytic", [
        [(1e6, 1e6), (1e6, 1e6)], [(1e6, 1e9), (1e6, 0.75e9)],
        [(1e6, 1e9), (1e6, 1e8)], [(1e6, 1e8), (1e6, 1e9)],
        [(1e12, 1e6), (1e9, 1e6)]])
    def test_model_winners_match_jax(self, tmp_path, monkeypatch, analytic):
        port, jax_rec = _both_resolve(monkeypatch, tmp_path, [], analytic)
        assert port["label"] == PORT_LABEL[jax_rec["label"]]
        assert port["source"] == jax_rec["source"] == "model"
        assert port["scores"] == {PORT_LABEL[k]: v
                                  for k, v in jax_rec["scores"].items()}

    @pytest.mark.parametrize("causal", [True, False])
    def test_kernel_cost_is_jaxs_unstreamed_plan(self, causal):
        """The kernel candidate's analytic cost is JAX's ``_attn_cost``
        for a kernel whose plan streams no superblock (the port's 64x64
        tiles over the whole Tq and Tk)."""
        for b, h, tq, tk, d in ((16, 8, 512, 512, 64), (2, 8, 4096, 4096, 64),
                                (1, 2, 200, 333, 32)):
            want = JT._attn_cost("pallas", (64, 64, tk, tq), b, h, tq, tk,
                                 d, jnp.bfloat16, causal)
            got = TT._attn_cost("kernel", b, h, tq, tk, d, torch.bfloat16,
                                causal)
            assert got == pytest.approx(want, rel=1e-12)

    def test_unmeasurable_cpu_search_never_proposes_the_kernel(self, tuner):
        d = _decide_attn(static_impl="reference")
        assert d["impl"] == "reference" and d["source"] == "model"
        assert set(d["scores"]) == {"reference"}

    def test_the_kernel_is_a_candidate_on_the_card(self, tuner):
        """On a CUDA device the kernel is priced (no tensors here, so
        the model decides) and, against the reference's whole f32 score
        plane, clears the margin at the long-context shape."""
        d = TT.decide_attention((2, 8, 4096, 64), (2, 8, 4096, 64),
                                torch.bfloat16, causal=True, seq_offset=0,
                                static_impl="reference", device="cuda")
        assert set(d["scores"]) == {"reference", "kernel"}
        assert d["key"].endswith("|gpu|c1o0")
        assert d["impl"] == "kernel" and d["source"] == "model"


# ------------------------------------------------------ the regression gate
def _entry(src, plat, step, value=None, rnd=0):
    return {"source": src, "round": rnd, "platform": plat, "value": value,
            "step_time_s": step, "step_time_p95_s": None,
            "compile_count": None}


@pytest.mark.parametrize("fresh,traj,tol", [
    (_entry("f", "gpu", 1.0), [_entry("a", "gpu", 0.9),
                               _entry("b", "gpu", 0.5, rnd=1)], None),
    (_entry("f", "gpu", 1.0), [_entry("a", "gpu", 0.8)], 1.3),
    (_entry("f", "gpu", 1.0), [_entry("a", "cpu", 0.1)], None),
    (_entry("f", "gpu", None, value=80.0),
     [_entry("a", "gpu", None, value=100.0)], 1.1),
    (_entry("f", "gpu", 1.0), [], None),
    ({"extras": {"step_time_s": 2.0}, "platform": "gpu", "value": 5.0},
     [_entry("a", "gpu", 1.0, value=10.0)], 1.5),
    ({"no": "extras"}, [_entry("a", "gpu", 1.0)], None),
])
def test_regress_check_matches_jax(fresh, traj, tol):
    assert TRG.check(fresh, traj, tol) == JRG.check(fresh, traj, tol)


def test_regress_tolerance_knob(monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_REGRESS_TOLERANCE", "1.1")
    v = TRG.check(_entry("f", "gpu", 1.2), [_entry("a", "gpu", 1.0)])
    assert v["tolerance"] == 1.1 and v["status"] == "violation"


def test_load_trajectory_matches_jax(tmp_path):
    for rnd, step in ((1, 0.5), (3, 0.4)):
        (tmp_path / f"BENCH_r0{rnd}.json").write_text(json.dumps({
            "parsed": {"platform": "gpu", "value": 10.0 * rnd,
                       "extras": {"step_time_s": step}}}))
    (tmp_path / "BENCH_r02.json").write_text("{torn")
    assert TRG.load_trajectory(str(tmp_path)) == \
        JRG.load_trajectory(str(tmp_path))
    assert len(TRG.load_trajectory(str(tmp_path))) == 2
    assert TRG.load_trajectory(None) == []


# --------------------------------------------- no counterpart in the port
def test_no_vmem_guard_or_superblock_plans_in_the_port():
    """JAX sizes its kv and q superblocks by a symmetric VMEM model
    (``_kv_fits_vmem``, ``_flash_plan``) because a TPU kernel holds
    whole blocks in VMEM; the port's kernels stream fixed 64x64 tiles
    from HBM at any Tq and Tk, so there is no plan to choose and
    ``static_dispatch`` returns None where JAX returns its plan.  The
    shapes JAX streams in superblocks run as they are."""
    impl, plan = TA.static_dispatch((1, 8, 2048, 128), (1, 8, 32768, 128),
                                    (1, 8, 32768, 128), torch.bfloat16,
                                    backend="tpu")
    assert impl == "kernel" and plan is None
    assert JA.static_dispatch((1, 8, 2048, 128), (1, 8, 32768, 128),
                              (1, 8, 32768, 128), jnp.bfloat16,
                              backend="tpu")[1] == (128, 128, 8192, 2048)
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 1, t, 32).astype(np.float32))
               for t in (64, 1024, 1024))
    out = TA.flash_attention(q, k, v, causal=True, seq_offset=960)
    ref = TA._reference_attention(q, k, v, causal=True, scale=32 ** -0.5,
                                  seq_offset=960)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


# ------------------------------------------------- the port's own contracts
def test_measurement_never_reaches_the_callers_graph(tuner, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TUNER_MEASURE", "1")
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 64, 16).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    out = TA.dot_product_attention(q, k, v, causal=True)
    rec = TT.get_cache().decisions[
        "attn|b1h2tq64tk64d16|float32|cpu|c1o0"]
    assert rec["source"] == "measured" and set(rec["measured_s"]) == {
        "reference"}
    assert q.grad is None and k.grad is None and v.grad is None
    out.sum().backward()
    ref = TA._reference_attention(q.detach(), k.detach(), v.detach(),
                                  causal=True, scale=0.25)
    assert torch.equal(out.detach(), ref)


def test_nothing_is_measured_during_a_graph_capture(tuner, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TUNER_MEASURE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    q = torch.ones((1, 2, 64, 16))
    d = TT.decide_attention(q.shape, q.shape, q.dtype, causal=True,
                            seq_offset=0, static_impl="reference",
                            arrays=(q, q, q))
    assert d["source"] == "model" and "measured_s" not in d


def test_measurement_under_no_grad(tuner, monkeypatch):
    """A site reached under ``torch.no_grad`` (the engine's prefill, an
    eval pass) or ``torch.inference_mode`` still measures its forward
    and backward probes and caches the decision."""
    monkeypatch.setenv("BIGDL_TORCH_TUNER_MEASURE", "1")
    rs = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 64, 16).astype(np.float32))
               for _ in range(3))
    x = torch.from_numpy(rs.randn(2, 8, 8, 8).astype(np.float32))
    w = torch.from_numpy(rs.randn(16, 8, 3, 3).astype(np.float32) * .1)
    s = torch.from_numpy(rs.randn(16).astype(np.float32))
    for i, mode in enumerate((torch.no_grad, torch.inference_mode)):
        with mode():
            out = TA.dot_product_attention(q[..., i:, :], k, v,
                                           causal=True)
            y, s1, s2 = TC.conv_bn_stats(x[:, :, i:], w, s, stride=2,
                                         pad=1)
        assert not out.requires_grad and not y.requires_grad
        attn = TT.get_cache().decisions[
            f"attn|b1h2tq{64 - i}tk64d16|float32|cpu|c1o0"]
        conv = TT.get_cache().decisions[
            f"conv_bn_kxk|n2c8h{8 - i}w8o16k3s2p1|float32|cpu"]
        assert attn["source"] == conv["source"] == "measured"
        assert set(attn["measured_s"]) == {"reference"}
        assert set(conv["measured_s"]) == {"kernel", "xla"}


def test_a_failing_kernel_candidate_raises(tuner, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TUNER_MEASURE", "1")

    def broken(*a, **kw):
        raise RuntimeError("flash_fwd kernel launch failed")

    monkeypatch.setattr(TA, "flash_attention", broken)
    q = torch.ones((1, 2, 64, 32))      # a head size the kernel takes
    with pytest.raises(TT.KernelCandidateError, match="launch failed"):
        TT.decide_attention(q.shape, q.shape, q.dtype, causal=True,
                            seq_offset=0, static_impl="reference",
                            arrays=(q, q, q), device="cuda")
    # a failing non-kernel candidate drops out, as in JAX
    monkeypatch.setattr(TT, "_measure", lambda probe, args, iters:
                        probe(*args))
    rec = TT._resolve(
        "attn", "test|drop|f32|cpu", _port_candidates(), "reference",
        {"reference": (1.0, 1.0), "kernel": (1.0, 1.0)},
        {"reference": lambda x: (_ for _ in ()).throw(RuntimeError("x")),
         "kernel": lambda x: 0.5}, (torch.ones(2),))
    assert rec["source"] == "model"


def test_configure_reaches_the_tuner(tmp_path, monkeypatch):
    import importlib

    C = importlib.import_module("bigdl_tpu_torch.config")
    try:
        C.configure(tuner=C.TunerConfig(enabled=True,
                                        cache_path=str(tmp_path / "t.json"),
                                        measure_iters=5))
        assert TT.enabled() and TT._cfg().measure_iters == 5
        assert TT.get_cache().path == str(tmp_path / "t.json")
    finally:
        C.reload_from_env()
    assert not TT.enabled()
    monkeypatch.setenv("BIGDL_TORCH_TUNER_MEASURE_ITERS", "7")
    assert C.refresh_from_env().tuner.measure_iters == 7
    assert C.TunerConfig() == C.TunerConfig(
        enabled=False, cache_path=None, measure=False, measure_iters=3)


# ------------------------------------------------- end-to-end decisions
class TestDecisionFlow:
    def test_conv_decision_golden_key_and_payload(self, tuner):
        d = TT.decide_conv_bn((2, 8, 8, 8), (16, 8, 3, 3), torch.float32,
                              stride=2, pad=1, device="cpu")
        assert d["impl"] in ("kernel", "xla")
        assert d["key"] == "conv_bn_kxk|n2c8h8w8o16k3s2p1|float32|cpu"
        assert d["static"] == "kernel"

    def test_conv_xla_arm_matches_the_kernel_arm(self, tuner, monkeypatch):
        """The tuner's "xla" arm computes the same function, gradients
        included, as the kernel arm (the plain version on the CPU)."""
        rs = np.random.RandomState(3)
        x = torch.from_numpy(rs.randn(2, 8, 8, 8).astype(np.float32))
        w = torch.from_numpy(rs.randn(16, 8, 3, 3).astype(np.float32) * .1)
        s = torch.from_numpy(rs.randn(16).astype(np.float32))
        outs = []
        for impl in ("kernel", "xla"):
            xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
            y, s1, s2 = TC.conv_bn_stats(xi, wi, s, stride=2, pad=1,
                                         impl=impl)
            (y.square().sum() + s1.sum() + s2.sum()).backward()
            outs.append([t.detach() for t in (y, s1, s2, xi.grad, wi.grad)])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="impl"):
            TC.conv_bn_stats(x, w, s, impl="pallas")
        monkeypatch.setenv("BIGDL_TORCH_TUNER_MEASURE", "1")
        TC.conv_bn_stats(x, w, s, stride=2, pad=1)
        rec = TT.get_cache().decisions[
            "conv_bn_kxk|n2c8h8w8o16k3s2p1|float32|cpu"]
        assert set(rec["measured_s"]) == {"kernel", "xla"}

    def test_attention_decision_with_tuner_enabled_dispatches(self, tuner):
        rs = np.random.RandomState(0)
        q = torch.from_numpy(rs.randn(1, 2, 128, 16).astype(np.float32))
        k = torch.from_numpy(rs.randn(1, 2, 256, 16).astype(np.float32))
        v = torch.from_numpy(rs.randn(1, 2, 256, 16).astype(np.float32))
        got = TA.dot_product_attention(q, k, v, causal=True)
        ref = TA._reference_attention(q, k, v, causal=True, scale=0.25)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-5)
        assert TT.summary()["decisions"], "no decision recorded"

    def test_decode_and_int8_decisions(self, tuner):
        from bigdl_tpu_torch.ops.decode_attention import decode_hbm_bytes

        d = TT.decide_decode_attn((8, 8, 64), 16, 4, torch.float32,
                                  device="cpu")
        assert d["key"] == "decode_attn|b8h8d64p16m4|float32|cpu"
        assert set(d["scores"]) == {"dense", "fused_p4", "fused_p1"}
        assert d["impl"] == "dense" and d["static"] == "dense"
        g = TT.decide_decode_attn((8, 8, 64), 16, 4, torch.bfloat16,
                                  device="cuda")
        assert "kernel" in g["scores"]
        assert g["scores"]["kernel"] == round(TT._score(
            4.0 * 8 * 8 * 4 * 16 * 64,
            decode_hbm_bytes("kernel", 8, 8, 64, 16, 4, 2), "gpu"), 9)
        m = TT.decide_int8_mm((4, 32), (64, 32), torch.float32,
                              device="cpu")
        assert m["key"] == "int8_mm|m4k32n64|float32|cpu"
        assert m["impl"] == "int8"

    def test_engine_resolves_each_bucket_once(self, tuner, monkeypatch):
        from bigdl_tpu_torch.models.transformer import build_transformer_lm
        from bigdl_tpu_torch.serving.engine import LMEngine

        calls = []
        decide = TT.decide_decode_attn

        def counting(*a, **kw):
            calls.append(a[2])
            return decide(*a, **kw)

        monkeypatch.setattr(TT, "decide_decode_attn", counting)
        model = build_transformer_lm(64, dim=32, n_head=2, n_layer=1,
                                     max_len=64, device="cpu")
        eng = LMEngine(model, max_batch=2, page_size=8, device="cpu")
        assert eng._decode_impl_for(2) == ("dense", 0)
        assert eng._decode_impl_for(2) == ("dense", 0)
        assert calls == [2]
        rec = TT.get_cache().decisions[
            "decode_attn|b2h2d16p8m2|float32|cpu"]
        assert rec["static"] == "dense"

    def test_summary_shape(self, tuner):
        _decide_attn()
        s = TT.summary()
        assert s["enabled"] is True and s["cache"]["entries"] == 1
        d = s["decisions"][0]
        assert {"key", "site", "impl", "label", "source", "static"} <= set(d)
        assert set(s) == set(JT.summary())

    def test_decision_telemetry(self, tuner):
        from bigdl_tpu_torch import obs
        from bigdl_tpu_torch.obs import names

        fam = obs.get_registry().counter(names.TUNER_DECISIONS_TOTAL,
                                         labels=("site", "impl"))
        before = fam.labels(site="attn", impl="reference").value
        _decide_attn()
        _decide_attn()
        assert fam.labels(site="attn", impl="reference").value == before + 2
