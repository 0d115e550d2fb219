"""The port's LeNet-5, validation and evaluation against the JAX
package, on the CPU.

LeNet-5 trained 3 steps by both ``LocalOptimizer``s from the same seeds
and shuffle order: each loss within 1e-5, the final params within 2e-5
(the limits of ``test_torch_port_lm_train.py``).  ``evaluate_dataset``
with ``Top1Accuracy``, ``Top5Accuracy``, ``Loss`` and ``MAE`` over a
dataset whose last batch is ragged: counts equal, values within 1e-5;
``predict`` within 1e-5 and ``predict_class`` equal.  ``set_validation``
on ``several_iteration`` and ``every_epoch``: the validations, their
steps, values and ``state["score"]`` as JAX's; ``Plateau`` lowering
``lr_scale`` as JAX's does; a trigger that reads ``state["loss"]`` sees
that step's loss; and what is not ported raises."""

import gzip
import struct

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.dataset import mnist as JM
from bigdl_tpu.models.lenet import build_lenet5 as j_build
from bigdl_tpu.optim import evaluator as JE
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.dataset import mnist as TM
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models import rnn as TRNN
from bigdl_tpu_torch.optim import evaluator as TE


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach().numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _data(n, seed=42):
    x, y = TM.synthetic_mnist(n, seed=seed)
    return TM.normalize(x).astype(np.float32), y


def _models(seed=3):
    JRandom.RNG.set_seed(seed)
    jm = j_build()
    TRandom.RNG.set_seed(seed)
    tm = TL.build_lenet5(device="cpu")
    return jm, tm


class _Summary:
    """Train and validation summary: every scalar, by tag."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, step, value))

    def get_summary_trigger(self, name):
        return None

    def of(self, tag):
        return {s: v for t, s, v in self.rows if t == tag}


def _run(pkg, opt, seed=5, iters=None, epochs=None, val=None, sched=None,
         end=None, lr=0.1, n=96, batch=16):
    """Train LeNet-5 in one package: ``pkg`` is "jax" or "torch"."""
    x, y = _data(n)
    vx, vy = _data(40, seed=43)
    jm, tm = _models(seed)
    jax_side = pkg == "jax"
    model = jm if jax_side else tm
    O = JO if jax_side else TO
    crit = (JN if jax_side else TN).ClassNLLCriterion()
    kw = {} if jax_side else {"device": "cpu"}
    o = opt(model, (x, y), crit, batch_size=batch, **kw)
    o.set_optim_method(O.SGD(learningrate=lr, learningrate_schedule=(
        sched(O) if sched else None)))
    o.set_end_when(end(O) if end else O.Trigger.max_iteration(iters)
                   if iters else O.Trigger.max_epoch(epochs))
    summ, vsumm = _Summary(), _Summary()
    o.set_train_summary(summ).set_val_summary(vsumm)
    if val is not None:
        o.set_validation(val(O), (vx, vy), [O.Top1Accuracy(), O.Loss()],
                         batch_size=16)
    TRandom.RNG.set_seed(1)
    JRandom.RNG.set_seed(1)
    return o.optimize(), o, summ, vsumm


def test_three_step_trajectory_matches_jax():
    jm, _, jsum, _ = _run("jax", JLocal, iters=3)
    tm, _, tsum, _ = _run("torch", TO.LocalOptimizer, iters=3)
    jl, tl = jsum.of("Loss"), tsum.of("Loss")
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    for n in (1, 2, 3):
        np.testing.assert_allclose(tl[n], jl[n], atol=1e-5, err_msg=f"{n}")
    jp, tp = _flat(jax.tree.map(np.asarray, jm.params())), _flat(tm.params())
    assert set(jp) == set(tp) and len(jp) == 8
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-5, err_msg=k)


def test_evaluate_dataset_matches_jax_with_a_ragged_tail():
    jm, tm = _models(7)
    x, y = _data(70, seed=9)          # 70 = 4 x 16 + 6
    onehot = np.eye(10, dtype=np.float32)[y.astype(int) - 1]
    cases = [(y, [JO.Top1Accuracy(), JO.Top5Accuracy(), JO.Loss()],
              [TO.Top1Accuracy(), TO.Top5Accuracy(), TO.Loss()]),
             (onehot, [JO.MAE()], [TO.MAE()])]
    for labels, jmeth, tmeth in cases:
        want = JE.evaluate_dataset(jm, JArray(x, labels, 16), jmeth,
                                   mesh=None)
        got = TE.evaluate_dataset(tm, TArray(x, labels, 16), tmeth,
                                  device="cpu")
        for w, g in zip(want, got):
            assert g.name == w.name and g.count == w.count == 70
            np.testing.assert_allclose(g.result()[0], w.result()[0],
                                       rtol=1e-5, atol=1e-6, err_msg=g.name)
            if g.name.startswith("Top"):
                assert g.total == w.total
    assert not tm.training


def test_validation_methods_fold_as_jax():
    rs = np.random.RandomState(0)
    out = rs.randn(12, 7).astype(np.float32)
    out[3, :] = 0.5                   # a row of ties
    tgt = (rs.randint(0, 7, 12) + 1).astype(np.float32)
    for jm_, tm_ in ((JO.Top1Accuracy(), TO.Top1Accuracy()),
                     (JO.Top5Accuracy(), TO.Top5Accuracy())):
        w, g = jm_.batch_result(out, tgt), tm_.batch_result(out, tgt)
        assert (g.total, g.count) == (w.total, w.count)
    r = TO.Top1Accuracy().batch_result(out, tgt) + \
        TO.Top1Accuracy().batch_result(out[:2], tgt[:2])
    assert r.count == 14 and r.name == "Top1Accuracy"


def test_predict_and_predict_class_match_jax():
    jm, tm = _models(8)
    x, _ = _data(45, seed=10)
    want = JE.predict(jm, x, batch_size=16, mesh=None)
    got = TE.predict(tm, x, batch_size=16, device="cpu")
    assert got.shape == (45, 10)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(
        TE.Predictor(tm, 16, device="cpu").predict_class(x),
        JE.predict_class(jm, x, batch_size=16, mesh=None))
    res = TE.Validator(tm, (x, np.ones(45, np.float32)), 16,
                       device="cpu").test([TO.Top1Accuracy()])
    assert res[0].count == 45


@pytest.mark.parametrize("which", ["several_iteration", "every_epoch"])
def test_set_validation_matches_jax(which):
    def trig(O):
        return (O.Trigger.several_iteration(4) if which == "several_iteration"
                else O.Trigger.every_epoch())

    _, jo, _, jv = _run("jax", JLocal, epochs=2, val=trig)
    tm, to, _, tv = _run("torch", TO.LocalOptimizer, epochs=2, val=trig)
    # 6 steps an epoch: several_iteration(4) fires after steps 4, 8 and 12
    # and again at the end of epoch 2 (neval 13 still reads 12 done)
    steps = {"several_iteration": [5, 9, 13, 13],
             "every_epoch": [7, 13]}[which]
    for tag in ("Top1Accuracy", "Loss"):
        jrows = [(s, v) for t, s, v in jv.rows if t == tag]
        trows = [(s, v) for t, s, v in tv.rows if t == tag]
        assert [s for s, _ in trows] == [s for s, _ in jrows] == steps
        np.testing.assert_allclose([v for _, v in trows],
                                   [v for _, v in jrows], atol=1e-5,
                                   err_msg=tag)
    np.testing.assert_allclose(to.state["score"], jo.state["score"],
                               atol=1e-6)
    assert to.state["score"] == tv.rows[-2][2]
    assert not tm.training          # optimize() ends in eval mode


def test_plateau_lowers_lr_scale_as_jax():
    """A Plateau watching the validation Loss for a rise (mode "max",
    patience 1) halves the rate at each validation where the Loss did
    not rise; the steps after it train at the lowered rate."""
    def sched(O):
        return O.Plateau(factor=0.5, patience=1, mode="max")

    def trig(O):
        return O.Trigger.several_iteration(2)

    _, jo, jsum, _ = _run("jax", JLocal, iters=7, val=trig, sched=sched)
    _, to, tsum, _ = _run("torch", TO.LocalOptimizer, iters=7, val=trig,
                          sched=sched)
    jl, tl = jsum.of("Loss"), tsum.of("Loss")
    assert sorted(tl) == sorted(jl) == list(range(1, 8))
    for n in jl:
        np.testing.assert_allclose(tl[n], jl[n], atol=1e-5, err_msg=f"{n}")
    js = jo.optim_method.learningrate_schedule.scale
    ts = to.optim_method.learningrate_schedule.scale
    assert ts == js < 1.0
    assert float(to.optim_method.state["lr_scale"]) == ts


def test_a_loss_trigger_sees_its_steps_loss():
    seen = {}

    def stop_after_3(state):      # no needs_loss: taken to read the loss
        seen[state["neval"] - 1] = state["loss"]
        return state["neval"] > 3

    x, y = _data(64)
    TRandom.RNG.set_seed(3)
    m = TL.build_lenet5(device="cpu")
    summ = _Summary()
    o = TO.LocalOptimizer(m, (x, y), TN.ClassNLLCriterion(), batch_size=16,
                          device="cpu")
    o.set_optim_method(TO.SGD(learningrate=0.1)).set_train_summary(summ)
    o.set_end_when(stop_after_3).optimize()
    assert seen == summ.of("Loss") and sorted(seen) == [1, 2, 3]


def test_min_loss_stops_where_jax_stops():
    """``min_loss`` reads each step's own loss: both packages stop at the
    first step whose loss is under the limit."""
    _, _, jsum, _ = _run("jax", JLocal, iters=3)
    losses = jsum.of("Loss")
    limit = min(losses.values()) + 1e-3
    first = min(n for n, v in losses.items() if v < limit)
    for pkg, opt in (("jax", JLocal), ("torch", TO.LocalOptimizer)):
        _, o, _, _ = _run(pkg, opt,
                          end=lambda O: O.Trigger.min_loss(limit))
        assert o.state["neval"] - 1 == first, pkg


def test_the_optimizer_factory_and_what_is_not_ported(tmp_path):
    x, y = _data(32)
    TRandom.RNG.set_seed(3)
    m = TL.build_lenet5(device="cpu")
    o = TO.Optimizer(model=m, training_set=(x, y),
                     criterion=TN.ClassNLLCriterion(), batch_size=16,
                     end_trigger=TO.Trigger.max_iteration(1),
                     optim_method=TO.SGD(learningrate=0.1), device="cpu")
    assert isinstance(o, TO.LocalOptimizer)
    o.setValidation(TO.Trigger.every_epoch(), (x, y), [TO.Top1Accuracy()])
    o.optimize()
    assert o.state["neval"] == 2
    # distributed=True and checkpoints are ported now (the CPU runs of
    # both through train_lenet are in test_torch_port_imagenet_path.py);
    # so are the compressed wires (test_torch_port_distri.py); an
    # unknown wire still raises
    from bigdl_tpu_torch.engine import Engine

    Engine.reset()
    try:
        d = TO.Optimizer(model=m, training_set=(x, y),
                         criterion=TN.ClassNLLCriterion(), distributed=True,
                         device="cpu")
        assert isinstance(d, TO.DistriOptimizer)
        q = TO.DistriOptimizer(m, (x, y), TN.ClassNLLCriterion(),
                               wire_dtype="int8", device="cpu")
        assert q.wire.scaled and q._staged_ring
        with pytest.raises(ValueError, match="not supported"):
            TO.DistriOptimizer(m, (x, y), TN.ClassNLLCriterion(),
                               wire_dtype="fp16", device="cpu")
    finally:
        Engine.reset()
    # background checkpoint writes are ported now
    o.set_checkpoint(str(tmp_path / "ckpt"), background=True)
    assert o.checkpoint_background


def test_new_entry_points_raise_without_cuda(monkeypatch):
    x, y = _data(16)
    TRandom.RNG.set_seed(3)
    m = TL.build_lenet5(device="cpu")
    ds = TArray(x, y, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: TL.build_lenet5(),
             lambda: TL.train_lenet(),
             lambda: TRNN.build_ptb_lm(20),
             lambda: TRNN.train_ptb(),
             lambda: TRNN.perplexity(m, x, y),
             lambda: TE.evaluate_dataset(m, ds, [TO.Top1Accuracy()]),
             lambda: TE.predict(m, x),
             lambda: TE.Evaluator(m).test(ds, [TO.Top1Accuracy()]),
             lambda: TO.Optimizer(model=m, training_set=ds,
                                  criterion=TN.ClassNLLCriterion())]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_mnist_loader_matches_jax(tmp_path):
    for kw in (dict(n=20), dict(n=7, seed=43)):
        for got, want in zip(TM.synthetic_mnist(**kw),
                             JM.synthetic_mnist(**kw)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TM.load_mnist(None, "test")[1],
                                  JM.load_mnist(None, "test")[1])
    imgs = np.random.RandomState(0).randint(0, 256, (3, 28, 28)).astype(
        np.uint8)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28) + imgs.tobytes())
    with open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(gzip.compress(struct.pack(">II", 2049, 3)
                              + bytes([4, 0, 9])))
    for got, want in zip(TM.load_mnist(str(tmp_path), "train"),
                         JM.load_mnist(str(tmp_path), "train")):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TM.load_mnist(str(tmp_path))[1],
                                  [5.0, 1.0, 10.0])
    np.testing.assert_allclose(TM.normalize(imgs.astype(np.float32)),
                               JM.normalize(imgs.astype(np.float32)))
    with open(tmp_path / "bad", "wb") as f:
        f.write(struct.pack(">II", 7, 0))
    with pytest.raises(ValueError, match="bad magic"):
        TM._read_idx_labels(str(tmp_path / "bad"))
