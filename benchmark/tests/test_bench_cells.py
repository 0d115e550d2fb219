"""Whole runs of the harness on the CPU at tiny sizes: the program holds
to the plain reference, a cell added as data files alone runs, and the
control and each fault a cell can have come out as not correct."""

import json
import math
import os

import pytest

from benchmark import control, harness

import bench_cells

SEED = 2 ** 31 + 11


@pytest.mark.parametrize("cell", list(bench_cells.CELLS))
def test_the_program_holds_to_the_reference(cell):
    out = bench_cells.run(cell, seed=SEED)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    e2e = bench_cells.CELLS[cell][1]
    assert out["metrics"][e2e]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert harness.forbidden_modules() == []


def test_a_traced_run_reads_its_per_layer_metrics():
    out = bench_cells.run("tiny-gpt2.train", trace=True, seed=SEED)
    assert out["correct"]
    assert {"dispatch_ms.tokens", "data_wait_ms.tokens"} <= set(
        out["metrics"])
    # no device on the CPU: the device's metrics are left out, not 0
    assert "device_idle.tokens" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_as_data_files_alone_runs(tmp_path):
    for kind, old, new in (("configs", "tiny-gpt2", "tiny-gpt2-b"),
                           ("workloads", "tiny-gpt2.train",
                            "tiny-gpt2-b.train")):
        os.makedirs(tmp_path / kind, exist_ok=True)
        data = json.load(open(os.path.join(bench_cells.DATA, kind,
                                           old + ".json")))
        if kind == "workloads":
            data["config"] = "tiny-gpt2-b"
            data["traffic"]["seq"] = 8
        (tmp_path / kind / (new + ".json")).write_text(json.dumps(data))
    cells = {"tiny-gpt2-b.train": ("tiny-gpt2-b", "train_tokens_per_s")}
    out = bench_cells.run("tiny-gpt2-b.train", cells=cells, seed=SEED,
                          roots=(str(tmp_path), bench_cells.DATA,
                                 harness.BENCH))
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0


def _unchanged(monkeypatch):
    from bigdl_tpu_torch.optim import optim_method

    for cls in (optim_method.SGD, optim_method.Adam):
        monkeypatch.setattr(cls, "step", lambda self, grads, params, state:
                            (list(params), state))


def _half_batch(monkeypatch):
    from bigdl_tpu_torch.optim.optimizer import LocalOptimizer

    loss = LocalOptimizer._loss

    def half(self, names, params, inp, tgt, seed):
        n = inp.shape[0] // 2
        return loss(self, names, params, inp[:n], tgt[:n], seed)

    monkeypatch.setattr(LocalOptimizer, "_loss", half)


FAULTS = [("tiny-resnet.train", _unchanged), ("tiny-resnet.train", _half_batch),
          ("tiny-gpt2.train", _unchanged), ("tiny-gpt2.train", _half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = bench_cells.run(cell, seed=SEED)
    assert not out["correct"], out["checks"]


def _fails(readings, limits):
    return [k for k, lim in limits.items()
            if not (math.isfinite(readings[k]) and readings[k] <= lim)]


@pytest.mark.parametrize("cell", ["tiny-resnet.train", "tiny-gpt2.train"])
def test_the_training_control_is_not_correct(cell):
    run = bench_cells.prepare(cell, seed=SEED)
    assert _fails(control.train_control(run), run.cell["limits"])


@pytest.mark.card
@pytest.mark.parametrize("cell", list(bench_cells.CELLS))
def test_on_the_card_the_program_holds_and_the_control_fails(cell, card):
    out = bench_cells.run(cell, seed=SEED, device=card)
    assert out["correct"], out["checks"]
    run = bench_cells.prepare(cell, seed=SEED, device=card)
    assert _fails(control.train_control(run), run.cell["limits"])
