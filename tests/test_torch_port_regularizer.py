"""Regularizers, freezing, the combined triggers, the ranking metrics
and the phase timers of the port against the JAX package, on the CPU.

- ``L1L2Regularizer``/``L1Regularizer``/``L2Regularizer``: the penalty
  and its gradient against ``jax.grad`` (1e-6 relative).
- A model of ``LookupTable``, ``LSTM`` or ``GRU`` in ``Recurrent``,
  ``SpatialConvolution`` and ``Linear``, each with a regularizer, on
  JAX's carried weights: ``regularization_loss`` and its gradient
  against ``jax.grad``, and 3 steps through ``LocalOptimizer`` and
  ``DistriOptimizer`` at world 1 (1e-5 relative: losses with the
  penalty, and parameters).  Specs carry the regularizers; a layer
  without one keeps the JAX package's spec.
- ``freeze``: the module API against JAX's on a ``Sequential``, and 3
  steps of SGD with weight decay and an L2-norm clip with a frozen
  layer through both trainers: JAX's trajectory within 1e-5, the frozen
  parameters bit-equal to their start.  The JAX package's
  ``_Composite`` hides a frozen child (pinned; ``ROADMAP.md`` queue 3).
- ``Trigger.and_``/``or_``, ``TreeNNAccuracy``/``HitRatio``/``NDCG``
  and the ``Metrics`` phase names against JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.models.transformer import TransformerLM as JLM
from bigdl_tpu.obs import names as JNames
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.models.transformer import TransformerLM as TLM
from bigdl_tpu_torch.obs import names as TNames
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params

TOL = 1e-5
V, E, H, S, C = 12, 6, 5, 4, 3


@pytest.fixture(autouse=True)
def _port_world():
    Engine.reset()
    yield
    Engine.reset()


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))) \
        if got.size else 0.0
    assert err <= tol, f"{what}: max scaled err {err:.3e} > {tol:g}"


@pytest.mark.parametrize("make", [
    lambda M: M.L1L2Regularizer(0.1, 0.2), lambda M: M.L1Regularizer(0.3),
    lambda M: M.L2Regularizer(0.4)], ids=["l1l2", "l1", "l2"])
def test_penalty_and_gradient_match_jax(make):
    w = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    jr, tr = make(JO), make(TO)
    jv, jg = jax.value_and_grad(lambda a: jr(a))(jnp.asarray(w))
    t = torch.from_numpy(w.copy()).requires_grad_()
    tv = tr(t)
    (tg,) = torch.autograd.grad(tv, t)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-6)


def reg_model(N, O, cell="lstm"):
    """Token ids (B, S) → LookupTable → Recurrent(cell) → a 3x3 conv
    over the (S, H) sequence → Linear → LogSoftMax, every trained layer
    with an ``L1L2Regularizer``."""
    reg = lambda: O.L1L2Regularizer(1e-3, 2e-2)  # noqa: E731
    rnn = N.LSTM(E, H, w_regularizer=reg(), u_regularizer=reg(),
                 b_regularizer=reg()) if cell == "lstm" else \
        N.GRU(E, H, w_regularizer=reg(), u_regularizer=reg(),
              b_regularizer=reg())
    return N.Sequential() \
        .add(N.LookupTable(V, E, w_regularizer=reg())) \
        .add(N.Recurrent().add(rnn)) \
        .add(N.Reshape([1, S, H])) \
        .add(N.SpatialConvolution(1, 2, 3, 3, 1, 1, 1, 1,
                                  w_regularizer=reg(), b_regularizer=reg())) \
        .add(N.Reshape([2 * S * H])) \
        .add(N.Linear(2 * S * H, C, w_regularizer=reg(),
                      b_regularizer=reg())) \
        .add(N.LogSoftMax())


def _reg_data(n=12):
    rs = np.random.RandomState(5)
    return ((rs.randint(0, V, (n, S)) + 1).astype(np.float32),
            (rs.randint(0, C, n) + 1).astype(np.float32))


def _pair(make):
    JRandom.RNG.set_seed(3)
    jm = make(JN, JO)
    tm = make(TN, TO)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    return jm, tm


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_regularization_loss_and_gradient_match_jax(cell):
    jm, tm = _pair(lambda N, O: reg_model(N, O, cell))
    jp = jm.params()
    jv, jg = jax.value_and_grad(jm.regularization_loss)(jp)
    tv = tm.regularization_loss()
    params = [p for _, p in T.leaves_with_paths(tm.params())]
    tg = torch.autograd.grad(tv, params)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-6)
    for i, (a, b) in enumerate(zip(tg, jax.tree.leaves(jg))):
        _close(_np(a), b, f"grad {i}", 1e-6)
    assert len(tg) == len(jax.tree.leaves(jg)) == 8 + (3 if cell == "gru"
                                                       else 0)
    # the forward agrees too, so the trained runs below start equal
    x, _ = _reg_data()
    jo, _ = jm.apply(jp, jm.state(), jnp.asarray(x))
    with torch.no_grad():
        _close(_np(tm(torch.from_numpy(x))), jo, "forward")


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def _fixed(base, x, y, bs=4):
    class Fixed(base):
        def size(self):
            return len(x)

        def data(self, train=True):
            for b in range(0, len(x), bs):
                yield x[b:b + bs], y[b:b + bs]

    return Fixed()


def _train(pkg, model, layout, method, steps=3, clip=None, data=None):
    x, y = data if data is not None else _reg_data()
    O = JO if pkg == "jax" else TO
    crit = (JN if pkg == "jax" else TN).ClassNLLCriterion()
    ds = _fixed(JDataSet if pkg == "jax" else TDataSet, x, y)
    if layout == "tree":
        opt = JLocal(model, ds, crit, 4) if pkg == "jax" else \
            TO.LocalOptimizer(model, ds, crit, 4, device="cpu")
    elif pkg == "jax":
        opt = JDistri(model, ds, crit, 4, wire_dtype="float32",
                      mesh=JEngine.build_mesh({"data": 1},
                                              devices=jax.devices()[:1]))
    else:
        opt = TO.DistriOptimizer(model, ds, crit, 4, wire_dtype="float32",
                                 device="cpu")
    opt.set_optim_method(method(O))
    if clip:
        opt.set_gradient_clipping_by_l2_norm(clip)
    opt.set_end_when(O.Trigger.max_iteration(steps))
    losses = _Losses()
    opt.set_train_summary(losses)
    opt.optimize()
    return opt, losses.loss


@pytest.mark.parametrize("layout", ["tree", "zero1_flat"])
def test_trainers_add_the_penalty_as_jax_does(layout):
    jm, tm = _pair(reg_model)
    adam = lambda O: O.Adam(learningrate=0.02)  # noqa: E731
    _, jl = _train("jax", jm, layout, adam)
    _, tl = _train("torch", tm, layout, adam)
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    for n in tl:
        assert abs(tl[n] - jl[n]) <= TOL * max(1.0, abs(jl[n])), (tl, jl)
    for i, (a, b) in enumerate(zip(T.leaves(tm.params()),
                                   jax.tree.leaves(jm.params()))):
        _close(_np(a), b, f"{layout} param {i}")


def test_specs_carry_regularizers():
    m = reg_model(TN, TO)
    back = TS.spec_to_module(TS.module_to_spec(m))
    assert back.regularization_loss() is not None
    got = {(type(a).__name__, n): (type(r).__name__, r.l1, r.l2)
           for a in back.modules() for n, r in a._regularizers}
    want = {(type(a).__name__, n): (type(r).__name__, r.l1, r.l2)
            for a in m.modules() for n, r in a._regularizers}
    assert got == want and len(got) == 8
    only = TO.L2Regularizer(0.5)
    lin = TS.spec_to_module(TS.module_to_spec(TN.Linear(3, 2, b_regularizer=only)))
    assert lin.b_regularizer.l2 == 0.5 and lin.w_regularizer is None
    assert type(lin.b_regularizer) is TO.L2Regularizer
    # without regularizers the spec is the JAX package's
    plain = lambda N: N.Sequential().add(N.Linear(3, 4)).add(  # noqa: E731
        N.Recurrent().add(N.GRU(4, 2))).add(N.LookupTable(5, 3))
    assert TS.module_to_spec(plain(TN)) == JS.module_to_spec(plain(JN))


# ---------------------------------------------------------------- freeze


def _frozen_model(N):
    m = N.Sequential().add(N.Linear(6, 8).set_name("fc1")).add(N.Tanh()) \
        .add(N.Sequential().add(N.Linear(8, 8).set_name("fc2"))
             .add(N.Tanh()).set_name("block")) \
        .add(N.Linear(8, 3).set_name("fc3")).add(N.LogSoftMax())
    return m


def test_freeze_api_matches_jax():
    jm, tm = _pair(lambda N, O: _frozen_model(N))
    for args in ((), ("fc1",), ("block",), ("fc1", "fc3")):
        jm.freeze(*args)
        tm.freeze(*args)
        assert tm.has_frozen() == jm.has_frozen() is True
        frozen = tm.frozen_parameters()
        assert [0.0 if id(p) in frozen else 1.0 for p in
                T.leaves(tm.params())] == jax.tree.leaves(jm.grad_mask())
        jm.unfreeze()
        tm.unfreeze()
        assert tm.has_frozen() == jm.has_frozen() is False
    tm.freeze("block")
    assert tm.modules[2].modules[0].is_frozen()
    tm.unfreeze("fc2")
    assert not tm.modules[2].modules[0].is_frozen()
    assert tm.modules[2].is_frozen()
    with pytest.raises(ValueError, match="no module named"):
        tm.freeze("nope")
    reg = TN.Linear(3, 2, w_regularizer=TO.L2Regularizer(1.0))
    assert float(reg.regularization_loss().detach()) > 0
    assert reg.freeze().regularization_loss() == 0.0


@pytest.mark.parametrize("layout", ["tree", "zero1_flat"])
def test_frozen_parameters_stay_bit_equal(layout):
    """SGD with weight decay and an L2-norm clip: the frozen layers'
    gradients are zeroed before the clipper (so they do not shrink the
    live ones) and their weights do not move at all."""
    rs = np.random.RandomState(7)
    data = (rs.randn(12, 6).astype(np.float32),
            (rs.randint(0, 3, 12) + 1).astype(np.float32))
    jm, tm = _pair(lambda N, O: _frozen_model(N))
    jm.freeze("fc1", "fc2")
    tm.freeze("fc1", "fc2")
    start = [p.detach().clone() for p in T.leaves(tm.params())]
    sgd = lambda O: O.SGD(learningrate=0.5, momentum=0.9,  # noqa: E731
                          weightdecay=0.1)
    _, jl = _train("jax", jm, layout, sgd, clip=0.05, data=data)
    _, tl = _train("torch", tm, layout, sgd, clip=0.05, data=data)
    for n in tl:
        assert abs(tl[n] - jl[n]) <= TOL, (tl, jl)
    frozen = tm.frozen_parameters()
    moved = 0
    for i, (p, p0, b) in enumerate(zip(T.leaves(tm.params()), start,
                                       jax.tree.leaves(jm.params()))):
        _close(_np(p), b, f"{layout} param {i}")
        if id(p) in frozen:
            assert torch.equal(p, p0), i
        else:
            moved += not torch.equal(p, p0)
    assert len(frozen) == 4 and moved == 2


def test_jax_composite_hides_a_frozen_child():
    """Reference fault: the JAX ``_Composite`` has no ``modules`` list,
    so a frozen child of ``TransformerLM`` is not seen and trains.  The
    port sees it, and the child's weights stay bit-equal."""
    JRandom.RNG.set_seed(1)
    jlm = JLM(16, dim=8, n_head=2, n_layer=1, max_len=8)
    jlm._children["wte"].freeze()
    assert not jlm.has_frozen()
    tlm = TLM(16, dim=8, n_head=2, n_layer=1, max_len=8, device="cpu")
    tlm.child("wte").freeze()
    assert tlm.has_frozen()
    before = tlm.child("wte").weight.detach().clone()
    rs = np.random.RandomState(0)
    x = (rs.randint(0, 16, (4, 8))).astype(np.int64)
    head = tlm.child("head").weight.detach().clone()
    opt = TO.LocalOptimizer(tlm, (x, (x + 1) % 16),
                            TN.CrossEntropyCriterion(), batch_size=2,
                            device="cpu")
    opt.set_optim_method(TO.Adam(learningrate=0.1))
    opt.set_end_when(TO.Trigger.max_iteration(2)).optimize()
    assert torch.equal(tlm.child("wte").weight, before)
    assert not torch.equal(tlm.child("head").weight, head)


# ------------------------------------------- triggers, metrics, timers


def test_combined_triggers_match_jax():
    states = [dict(epoch=e, neval=n, epoch_finished=f, loss=l)
              for e, n, f, l in ((1, 1, 0, None), (1, 3, 0, 2.0),
                                 (2, 5, 1, 0.5), (2, 6, 1, 0.1),
                                 (3, 9, 2, 0.05))]

    def make(O):
        Tr = O.Trigger
        return [Tr.or_(Tr.max_epoch(1), Tr.max_iteration(4)),
                Tr.and_(Tr.every_epoch(), Tr.several_iteration(4)),
                Tr.and_(Tr.min_loss(0.2), Tr.max_epoch(1)),
                Tr.or_(Tr.and_(Tr.max_iteration(3), Tr.min_loss(1.0)),
                       Tr.max_epoch(2))]

    for jt, tt in zip(make(JO), make(TO)):
        assert tt.needs_loss == jt.needs_loss
        assert [tt(s) for s in states] == [jt(s) for s in states]
    assert not TO.Trigger.or_(TO.Trigger.max_epoch(1),
                              TO.Trigger.max_iteration(2)).needs_loss


def test_validation_methods_match_jax():
    rs = np.random.RandomState(4)
    tree_out = rs.randn(6, 5, 4).astype(np.float32)
    tree_tgt = (rs.randint(0, 4, (6, 5)) + 1).astype(np.float32)
    scores = rs.randn(7 * 100).astype(np.float32)
    scores[::100] += 1.5
    scores[200] = scores[201]  # a tie with the positive
    cases = [(lambda O: O.TreeNNAccuracy(), tree_out, tree_tgt),
             (lambda O: O.TreeNNAccuracy(), tree_out[:, 0], tree_tgt[:, 0]),
             (lambda O: O.HitRatio(k=10, neg_num=99), scores, None),
             (lambda O: O.NDCG(k=10, neg_num=99), scores, None),
             (lambda O: O.HitRatio(k=3, neg_num=4), scores[:50], None),
             (lambda O: O.NDCG(k=3, neg_num=4), scores[:50], None)]
    for make, out, tgt in cases:
        j = make(JO).batch_result(out, tgt)
        t = make(TO).batch_result(out, tgt)
        assert (t.total, t.count, t.name) == (j.total, j.count, j.name)
        assert t.result() == j.result()


def test_metrics_time_the_reference_phases():
    assert TNames.PHASE_SECONDS == JNames.PHASE_SECONDS
    rs = np.random.RandomState(1)
    opt = TO.LocalOptimizer(_frozen_model(TN),
                            (rs.randn(8, 6).astype(np.float32),
                             np.ones(8, np.float32)),
                            TN.ClassNLLCriterion(), 4, device="cpu")
    opt.set_end_when(TO.Trigger.max_iteration(2)).optimize()
    snap = opt.metrics.snapshot()
    assert set(snap) == {"computing time", "data wait time",
                         "put batch time"}
    assert all(v["count"] == 2 and v["total"] >= 0 for v in snap.values())
    assert "computing time average:" in opt.metrics.summary()
    jm = JO.Metrics()
    for name in snap:
        jm.add(name, 0.01)
    assert set(jm.snapshot()) == set(snap)
    opt.metrics.reset()
    assert opt.metrics.snapshot() == {}
