"""The DeepSeek-V3 family through the harness on the CPU, at a tiny size
(``data/*/tiny-deepseek-v3*.json``: latent attention at (24, 16), 3 of 8
routed experts a token, experts 2-5 held, one shared; the driver
``train_moe``): the program holds to the plain reference, the driver's
reference steps are ``reference.optim.run_steps``'s, and the float8
control and each fault of the new mechanism come out as not correct."""

import pytest
import torch

from benchmark import compare, traffic, weights
from benchmark.drivers import train, train_moe

import bench_cells

SEED = 2 ** 31 + 13
CELL = "tiny-deepseek-v3.train"
CELLS = {CELL: ("tiny-deepseek-v3", "train_tokens_per_s")}


def run(**kw) -> dict:
    return bench_cells.run(CELL, cells=CELLS, seed=SEED, **kw)


def test_the_program_holds_to_the_reference():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "grad_median_gap"}


def prepare():
    return bench_cells.harness.prepare(
        CELL, SEED, 1.0, False, "cpu", 0.0,
        roots=(bench_cells.DATA, bench_cells.harness.BENCH),
        bench=bench_cells.bench(CELLS))


@pytest.mark.parametrize("quant", [None, "fp8"])
def test_the_drivers_reference_steps_are_run_steps(quant):
    run_ = prepare()
    x, y = traffic.train_pool(run_.cell["traffic"], run_.config, SEED,
                              run_.device)
    batches = train.first_batches(run_, x, y)
    w0 = weights.make(run_.reference.weight_specs(run_.config), SEED,
                      run_.device)
    want = compare.reference_readings(
        train.reference_steps(run_, w0, batches, quant), w0)
    start = {k: t.clone() for k, t in w0.items()}
    got = train_moe.reference_steps(run_, w0, batches, quant)
    assert all(torch.equal(w0[k], start[k]) for k in w0)
    # the same products and updates in the same order: equal bit for bit
    for kind in ("losses", "grad_norms", "change_norms"):
        assert got[kind] == want[kind], kind


def test_a_traced_run_reads_the_moe_readers_without_a_device():
    out = run(trace=True)
    assert out["correct"], out["checks"]
    assert "dispatch_ms.tokens" in out["metrics"]
    # no device trace on the CPU: the device's metrics are left out
    for name in ("mla_roofline.tokens", "expert_roofline.tokens",
                 "device_idle.tokens"):
        assert name not in out["metrics"]


def test_the_expert_roofline_reads_only_the_experts_that_took_tokens():
    from types import SimpleNamespace

    from benchmark import harness, roofline

    reader = harness.reader("layer_metrics", "expert_roofline.tokens",
                            (harness.BENCH,))
    d, f = 2048, 1408
    cfg = {"compute_dtype": "bfloat16", "hidden_size": d,
           "moe_intermediate_size": f, "n_routed_experts": 8}

    def share(loads):
        run = SimpleNamespace(
            profile=SimpleNamespace(kernel_seconds=lambda pattern: 1e-3),
            family=SimpleNamespace(STATS=SimpleNamespace(
                loads=torch.tensor(loads))),
            config=cfg, record={"profile_steps": 2})
        return reader.read(run)

    # 2 steps of 400 rows, all on one of 8 experts: its weights only
    bound = sum(roofline.bound_s(2 * e, fl, "bfloat16")[0]
                for e, fl in reader.products(200, d, f, 1))
    assert share([[400, 0, 0, 0, 0, 0, 0, 0]]) == pytest.approx(
        100 * 2 * bound / 1e-3)
    assert share([[50] * 8]) > share([[400, 0, 0, 0, 0, 0, 0, 0]])
    assert share([[0] * 8]) is None


def _top_k_less_one(monkeypatch):
    """The program routes each token to one expert fewer than the
    configuration says (the gates normalised over those)."""
    from bigdl_tpu_torch.parallel.moe import SigmoidMoE

    real = SigmoidMoE.route

    def route(self, x):
        k = self.top_k
        self.top_k = k - 1
        try:
            return real(self, x)
        finally:
            self.top_k = k

    monkeypatch.setattr(SigmoidMoE, "route", route)


def _no_selection_bias(monkeypatch):
    """The program selects on the scores alone, without the bias."""
    from bigdl_tpu_torch.parallel.moe import SigmoidMoE

    real = SigmoidMoE.route

    def route(self, x):
        kept = self.router.bias.clone()
        self.router.bias.zero_()
        try:
            return real(self, x)
        finally:
            self.router.bias.copy_(kept)

    monkeypatch.setattr(SigmoidMoE, "route", route)


def _half_sequence(monkeypatch):
    """The program's loss over the first half of each sequence."""
    from bigdl_tpu_torch.optim.optimizer import LocalOptimizer

    loss = LocalOptimizer._loss

    def half(self, names, params, inp, tgt, seed):
        n = inp.shape[1] // 2
        return loss(self, names, params, inp[:, :n], tgt[:, :n], seed)

    monkeypatch.setattr(LocalOptimizer, "_loss", half)


FAULTS = [_top_k_less_one, _no_selection_bias, _half_sequence]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_fault_of_the_new_mechanism_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]


def test_the_float8_control_is_not_correct():
    run_ = prepare()
    readings = train_moe.control(run_)
    fails = [k for k, lim in run_.cell["limits"].items()
             if not readings[k] <= lim]
    assert "grad_median_gap" in fails, readings
