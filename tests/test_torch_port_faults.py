"""The port's fault injector (``resilience/faults.py``) against the JAX
package's, on the CPU.

- A plan parses to the same faults, and a bad one raises the same
  ``ValueError`` message, in both packages.
- Each ``ckpt`` action damages the same files the same way (the bytes
  of both directories equal afterwards).
- A fault fires once in an injector's life, across a trainer's retry;
  ``Engine.reset()`` starts a fresh plan; ``publish:K:corrupt`` damages
  a published checkpoint the watcher's verify refuses.
- ``step:N:raise`` through ``DistriOptimizer`` at world 1 (the retry
  reloads the epoch's checkpoint) ends bit-equal to the uninterrupted
  port run and within 1e-5 of the JAX package's retried run on a
  1-device mesh, on a small conv/BN model; ``step:N:nan_grad`` is
  skipped by the guard in both, the summary's "NonFiniteSkips" reading
  1, and the weights within 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.resilience import faults as JF
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import obs
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.resilience import faults as TF
from bigdl_tpu_torch.serving.rollout import publish_checkpoint
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_distri_worker as W  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """A world of 1, no plan, fresh injectors and registry; retries
    without backoff in both packages."""
    for var in ("BIGDL_TORCH_FAULT_PLAN", "BIGDL_FAULT_PLAN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BIGDL_TORCH_RETRY_BACKOFF_BASE", "0")
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF_BASE", "0")
    Engine.reset()
    JF.reset_injector()
    obs.reset()
    yield
    Engine.reset()
    JF.reset_injector()
    obs.reset()


@pytest.mark.parametrize("spec", [
    "", "step:3:raise", "step:3:raise,step:7:nan_grad,ckpt:1:truncate",
    " ckpt:2:corrupt , publish:1:delete,ckpt:4:drop_optim ,",
    "step:x:raise", "step:3", "disk:1:corrupt", "step:1:truncate",
    "ckpt:1:raise", "publish:2:nan_grad"])
def test_plan_parses_as_jax(spec):
    def parse(mod):
        try:
            return [(f.site, f.index, f.action, f.fired)
                    for f in mod.FaultPlan.parse(spec).faults]
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(TF) == parse(JF)
    assert bool(TF.FaultPlan.parse("step:1:raise"))
    assert not TF.FaultPlan.parse(None)


def _pair(directory, seed):
    """A checkpoint-shaped pair of random bytes in ``directory``."""
    os.makedirs(directory)
    rs = np.random.RandomState(seed)
    prefix = os.path.join(directory, "checkpoint_1_5")
    for suffix, n in ((".model.npz", 4099), (".optim.npz", 517)):
        with open(prefix + suffix, "wb") as fh:
            fh.write(rs.bytes(n))
    return prefix


def _contents(directory):
    out = {}
    for f in sorted(os.listdir(directory)):
        with open(os.path.join(directory, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("action", ["truncate", "corrupt", "delete",
                                    "drop_optim"])
def test_each_ckpt_action_damages_the_same_files(tmp_path, action):
    before = _contents(os.path.dirname(_pair(str(tmp_path / "ref"), 5)))
    t_prefix = _pair(str(tmp_path / "t"), 5)
    j_prefix = _pair(str(tmp_path / "j"), 5)
    t_inj = TF.FaultInjector(TF.FaultPlan.parse(f"ckpt:2:{action}"))
    j_inj = JF.FaultInjector(JF.FaultPlan.parse(f"ckpt:2:{action}"))
    for _ in range(3):          # the second write is hit, once
        t_inj.on_checkpoint_write(t_prefix)
        j_inj.on_checkpoint_write(j_prefix)
    got, want = (_contents(str(tmp_path / "t")),
                 _contents(str(tmp_path / "j")))
    assert got == want
    assert got != before
    assert t_inj.ckpt_writes == j_inj.ckpt_writes == 3


def test_a_fault_fires_once_across_a_retry(tmp_path, monkeypatch):
    inj = TF.FaultInjector(TF.FaultPlan.parse("step:3:raise,"
                                              "step:4:nan_grad"))
    assert inj.on_step(2) is None
    with pytest.raises(TF.InjectedFault, match="step 3"):
        inj.on_step(3)
    assert inj.on_step(3) is None               # the replay passes
    assert inj.on_step(4) == "nan_grad" and inj.on_step(4) is None
    poisoned = TF.FaultInjector.poison_batch(torch.ones(2, 3))
    assert poisoned.dtype == np.float32 and np.isnan(poisoned).all()

    # the process injector: rebuilt when the plan changes, kept across
    # calls, dropped by Engine.reset
    monkeypatch.setenv("BIGDL_TORCH_FAULT_PLAN", "step:3:raise")
    Engine.init("cpu")
    first = TF.get_injector()
    assert first.active and TF.get_injector() is first
    Engine.reset()
    assert TF.get_injector() is not first

    # through the trainer: one raise at epoch 2's first step, one
    # reload of epoch 1's checkpoint, the run completes
    x, y = W.data(32)
    TRandom.RNG.set_seed(11)
    opt = TO.DistriOptimizer(W.small_model(TN),
                             TArray(x, y, 16, shuffle=False),
                             TN.ClassNLLCriterion(), 16,
                             wire_dtype="float32", device="cpu")
    opt.set_end_when(TO.Trigger.max_epoch(2))
    opt.set_checkpoint(str(tmp_path), TO.Trigger.every_epoch())
    opt.optimize()
    assert opt.retries == 1 and opt.state["neval"] == 5


def test_publish_fault_is_refused_by_verify(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_FAULT_PLAN", "publish:2:corrupt")
    TRandom.RNG.set_seed(1)
    m = TN.Sequential().add(TN.Linear(64, 64))
    first = publish_checkpoint(m, str(tmp_path), "v1")
    second = publish_checkpoint(m, str(tmp_path), "v2")
    assert TS.verify_checkpoint(first)[0]
    ok, reason = TS.verify_checkpoint(second)
    assert not ok and "checksum" in reason


def _port_distri(ck, epochs=3):
    x, y = W.data(64)
    TRandom.RNG.set_seed(11)
    model = W.small_model(TN)
    opt = TO.DistriOptimizer(model, TArray(x, y, 16, shuffle=False),
                             TN.ClassNLLCriterion(), 16,
                             wire_dtype="float32", device="cpu")
    opt.set_optim_method(TO.SGD(learningrate=0.2, momentum=0.9))
    opt.set_end_when(TO.Trigger.max_epoch(epochs))
    opt.set_checkpoint(str(ck), TO.Trigger.every_epoch())
    opt.optimize()
    return model, opt


def _jax_distri(ck, epochs=3):
    x, y = W.data(64)
    JRandom.RNG.set_seed(11)
    model = W.small_model(JN)
    mesh = JEngine.build_mesh({"data": 1}, devices=jax.devices()[:1])
    opt = JDistri(model, JArray(x, y, 16, shuffle=False),
                  JN.ClassNLLCriterion(), 16, mesh=mesh,
                  wire_dtype="float32")
    opt.set_optim_method(JO.SGD(learningrate=0.2, momentum=0.9))
    opt.set_end_when(JO.Trigger.max_epoch(epochs))
    opt.set_checkpoint(str(ck), JO.Trigger.every_epoch())
    opt.optimize()
    return model, opt


def test_step_raise_retry_matches_jax(tmp_path, monkeypatch):
    ref, ref_opt = _port_distri(tmp_path / "ref")
    monkeypatch.setenv("BIGDL_TORCH_FAULT_PLAN", "step:7:raise")
    monkeypatch.setenv("BIGDL_FAULT_PLAN", "step:7:raise")
    Engine.reset()
    model, opt = _port_distri(tmp_path / "ck")
    assert opt.retries == 1 and opt.state["neval"] == 13
    for a, b in zip(T.leaves(model.params()) + T.leaves(model.state()),
                    T.leaves(ref.params()) + T.leaves(ref.state())):
        assert torch.equal(a, b)
    assert torch.equal(opt.optim_method.state["velocity"],
                       ref_opt.optim_method.state["velocity"])
    JF.reset_injector()
    jm, jo = _jax_distri(tmp_path / "jck")
    assert jo.state["neval"] == 13
    for a, b in zip(T.leaves(model.params()) + T.leaves(model.state()),
                    jax.tree.leaves(jm.params())
                    + jax.tree.leaves(jm.state())):
        err = float(np.max(np.abs(a.detach().numpy() - np.asarray(b))))
        assert err <= TOL, err


class _Tape:
    """A train summary stub: the losses and the resilience counters."""

    def __init__(self):
        self.loss, self.resilience = {}, {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = float(value)

    def add_histogram(self, *a, **k):
        pass

    def get_summary_trigger(self, name):
        return None

    def add_resilience(self, step, **counters):
        self.resilience.update({k: v for k, v in counters.items()
                                if v is not None})


def test_nan_grad_is_skipped_as_jax(monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_FAULT_PLAN", "step:2:nan_grad")
    monkeypatch.setenv("BIGDL_FAULT_PLAN", "step:2:nan_grad")
    x, y = W.data(48)
    runs = []
    for N, O, R, Arr, opt_cls in (
            (TN, TO, TRandom, TArray, TO.LocalOptimizer),
            (JN, JO, JRandom, JArray, JO.LocalOptimizer)):
        R.RNG.set_seed(11)
        model = W.small_model(N)
        kw = {"device": "cpu"} if N is TN else {}
        opt = opt_cls(model, Arr(x, y, 16, shuffle=False),
                      N.ClassNLLCriterion(), 16, **kw)
        opt.set_optim_method(O.SGD(learningrate=0.2))
        opt.set_end_when(O.Trigger.max_epoch(1))
        tape = _Tape()
        opt.set_train_summary(tape)
        opt.optimize()
        runs.append((model, opt, tape))
    (tm, to, tt), (jm, jo, jt) = runs
    assert to.state["nonfinite_skips"] == jo.state["nonfinite_skips"] == 1
    assert tt.resilience == jt.resilience == {"nonfinite_skips": 1}
    assert np.isnan(tt.loss[2]) and np.isnan(jt.loss[2])
    for a, b in zip(T.leaves(tm.params()), jax.tree.leaves(jm.params())):
        err = float(np.max(np.abs(a.detach().numpy() - np.asarray(b))))
        assert err <= TOL, err
    fams = {f.name: f for f in obs.get_registry().families()}
    assert fams["bigdl_nonfinite_skips_total"].child_items()[0][1].value == 1
