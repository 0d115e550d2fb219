"""The port's control ops and ``DynamicGraph`` against the JAX package's,
on the CPU, on the same weights (``utils/convert``) and inputs, within
1e-5 of the largest |JAX value|.

- ``SwitchOps``/``MergeOps``: forward and input gradient, both ways of
  the predicate, and a predicate broadcast over rows.
- ``IfElse``: forward and the gradients of both branches' parameters;
  a BN branch in training mode leaves the running statistics as JAX
  leaves them (unchanged).
- ``WhileLoop``: forward, and both packages refuse the backward.
- ``DynamicGraph``: forward and the gradients of the input and of the
  body's parameters at trip counts 1, 3 and above ``max_iterations``;
  the state it leaves is iteration 0's, as JAX returns; an acyclic one
  runs as ``Graph``.
- Specs, ``.npz`` and ``.bigdl`` files of a ``DynamicGraph``, an
  ``IfElse`` and a ``WhileLoop`` load in the other package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

TOL = 1e-5


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1.0) if want.size else 1.0
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _tree_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _tree_close(got[k], want[k])
    else:
        _close(got, want)


def _carry(jm, tm):
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    load_jax_state(tm, jax.tree.map(np.asarray, jm.state()))


def _grads(m):
    """The port model's parameter gradients as its ``params()`` tree."""
    def g(t):
        if isinstance(t, dict):
            return {k: g(v) for k, v in t.items()}
        return t.grad
    return g(m.params())


# ---- switch and merge --------------------------------------------------------
def _switch_merge(N):
    inp, pred = N.Input(), N.Input()
    sw = N.SwitchOps()(inp, pred)
    f_br = N.MulConstant(2.0)(N.SelectTable(1)(sw))
    t_br = N.Tanh()(N.SelectTable(2)(sw))
    return N.Graph([inp, pred], N.MergeOps()(f_br, t_br, pred))


@pytest.mark.parametrize("pred", [True, False, "rows"])
def test_switch_merge_forward_and_gradient(pred):
    jg, tg = _switch_merge(JN), _switch_merge(TN)
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    p = np.asarray([[True], [False]]) if pred == "rows" else np.asarray(pred)

    def f(xx):
        y, _ = jg.apply(jg.params(), jg.state(), (xx, jnp.asarray(p)))
        return jnp.sum(y * y), y

    (_, want), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tg((xt, torch.from_numpy(p)))
    torch.sum(y * y).backward()
    _close(y, want)
    _close(xt.grad, gx)


# ---- IfElse ----------------------------------------------------------------------
def _ifelse(N):
    return N.IfElse(N.Sequential().add(N.Linear(4, 3)).add(N.Tanh()),
                    N.Linear(4, 3))


@pytest.mark.parametrize("pred", [True, False])
def test_ifelse_forward_and_branch_gradients(pred):
    JRandom.RNG.set_seed(3)
    jm = _ifelse(JN)
    TRandom.RNG.set_seed(3)
    tm = _ifelse(TN)
    _carry(jm, tm)
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)

    def f(params):
        y, _ = jm.apply(params, jm.state(), (jnp.asarray(pred),
                                             jnp.asarray(x)))
        return jnp.sum(y * y), y

    (_, want), g = jax.value_and_grad(f, has_aux=True)(jm.params())
    y = tm((torch.tensor(pred), torch.from_numpy(x)))
    torch.sum(y * y).backward()
    _close(y, want)
    # the branch not taken has no gradient (JAX: zeros)
    taken, idle = ("0", "1") if pred else ("1", "0")
    _tree_close(_grads(tm)[taken], g[taken])
    assert all(v is None for v in T.leaves(_grads(tm)[idle]))
    assert all(float(jnp.max(jnp.abs(v))) == 0.0
               for v in jax.tree.leaves(g[idle]))


def test_ifelse_leaves_branch_state_as_jax_does():
    JRandom.RNG.set_seed(4)
    jm = JN.IfElse(JN.SpatialBatchNormalization(3), JN.Identity())
    TRandom.RNG.set_seed(4)
    tm = TN.IfElse(TN.SpatialBatchNormalization(3), TN.Identity())
    _carry(jm, tm)
    jm.training()
    tm.train()
    x = np.random.RandomState(2).randn(4, 3, 2, 2).astype(np.float32) + 1.0
    want, jstate = jm.apply(jm.params(), jm.state(),
                            (jnp.asarray(True), jnp.asarray(x)),
                            training=True)
    before = jax.tree.map(np.asarray, jm.state())
    y = tm((torch.tensor(True), torch.from_numpy(x)))
    _close(y, want)
    _tree_close(tm.state(), jax.tree.map(np.asarray, jstate))
    _tree_close(tm.state(), before)        # JAX: state passes through


# ---- WhileLoop -------------------------------------------------------------------
class _JCond(JN.AbstractModule):
    def update_output_pure(self, params, input, **kw):
        i, acc = input
        return i < 5


class _JBody(JN.AbstractModule):
    def update_output_pure(self, params, input, **kw):
        i, acc = input
        return (i + 1, jnp.tanh(acc) * 2.0)


class _TCond(TN.AbstractModule):
    def forward(self, input):
        i, acc = input
        return i < 5


class _TBody(TN.AbstractModule):
    def forward(self, input):
        i, acc = input
        return (i + 1, torch.tanh(acc) * 2.0)


def test_while_loop_forward_equals_jax():
    jm, tm = JN.WhileLoop(_JCond(), _JBody()), TN.WhileLoop(_TCond(),
                                                           _TBody())
    acc = np.random.RandomState(3).randn(3).astype(np.float32)
    for start in (0, 3, 9):
        ji, ja = jm.forward((jnp.asarray(start), jnp.asarray(acc)))
        ti, ta = tm((torch.tensor(start), torch.from_numpy(acc)))
        assert int(ti) == int(ji) == max(start, 5)
        _close(ta, ja)


def test_while_loop_refuses_the_backward_in_both_packages():
    jm, tm = JN.WhileLoop(_JCond(), _JBody()), TN.WhileLoop(_TCond(),
                                                           _TBody())
    acc = np.ones(3, np.float32)

    def f(a):
        _, out = jm.forward((jnp.asarray(0), a))
        return jnp.sum(out)

    with pytest.raises(ValueError, match="[Rr]everse-mode"):
        jax.grad(f)(jnp.asarray(acc))
    at = torch.from_numpy(acc).requires_grad_(True)
    _, out = tm((torch.tensor(0), at))
    with pytest.raises(RuntimeError, match="forward only"):
        out.sum().backward()
    with torch.no_grad():                       # forward only is fine
        _, out = tm((torch.tensor(0), at))
    assert not out.requires_grad


# ---- DynamicGraph ----------------------------------------------------------------
def _counter_graph(N, max_iterations=8):
    """x <- tanh(W x + b) + x while the count (from the second input)
    stays below 4; the count is carried on its own cycle."""
    x_in, cnt_in = N.Input(), N.Input()
    x_feed = N.NextIteration()(x_in)
    cnt_feed = N.NextIteration()(cnt_in)
    body = N.Tanh()(N.Linear(3, 3)(x_feed))
    new_x = N.CAddTable()(body, x_feed)
    cnt_next = N.AddConstant(1.0)(cnt_feed)
    less = N.Sequential().add(N.MulConstant(-1.0)).add(N.AddConstant(4.0)) \
        .add(N.Sign()).add(N.ReLU())            # 1.0 while cnt_next < 4
    cond = N.LoopCondition()(less(cnt_next))
    x_feed.feedback_from(new_x)
    cnt_feed.feedback_from(cnt_next)
    return N.DynamicGraph([x_in, cnt_in], new_x,
                          max_iterations=max_iterations, condition=cond)


def _pair(max_iterations=8):
    JRandom.RNG.set_seed(7)
    jg = _counter_graph(JN, max_iterations)
    TRandom.RNG.set_seed(7)
    tg = _counter_graph(TN, max_iterations)
    _carry(jg, tg)
    return jg, tg


# the count's start for 1 and 3 trips, and one that never stops (8 > cap)
@pytest.mark.parametrize("start,trips", [(3.0, 1), (1.0, 3), (-100.0, 8)])
def test_dynamic_graph_forward_and_gradients(start, trips):
    jg, tg = _pair()
    x = np.random.RandomState(5).randn(2, 3).astype(np.float32)

    def f(params, xx):
        y, _ = jg.apply(params, jg.state(), (xx, jnp.asarray(start)))
        return jnp.sum(y * y), y

    (_, want), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jg.params(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tg((xt, torch.tensor(start)))
    torch.sum(y * y).backward()
    _close(y, want)
    _close(xt.grad, gx)
    _tree_close(_grads(tg), gp)
    # the trip count: the same result as that many explicit iterations
    ref = torch.from_numpy(x)
    lin = [m for m in tg.modules if isinstance(m, TN.Linear)][0]
    with torch.no_grad():
        for _ in range(trips):
            ref = torch.tanh(lin(ref)) + ref
    _close(y.detach(), _np(ref))


def test_dynamic_graph_returns_iteration_zeros_state():
    def graph(N):
        x_in = N.Input()
        feed = N.NextIteration()(x_in)
        bn = N.BatchNormalization(3)
        out = N.AddConstant(1.0)(bn(feed))
        feed.feedback_from(out)
        return N.DynamicGraph(x_in, out, max_iterations=3)

    JRandom.RNG.set_seed(8)
    jg = graph(JN)
    TRandom.RNG.set_seed(8)
    tg = graph(TN)
    _carry(jg, tg)
    tg.train()
    x = np.random.RandomState(6).randn(4, 3).astype(np.float32) * 2 + 1
    want, jstate = jg.apply(jg.params(), jg.state(), jnp.asarray(x),
                            training=True)
    y = tg(torch.from_numpy(x))
    _close(y, want)
    _tree_close(tg.state(), jax.tree.map(np.asarray, jstate))


def test_acyclic_dynamic_graph_runs_as_graph():
    def graph(N, cls):
        inp = N.Input()
        return cls(inp, N.MulConstant(2.0)(N.Tanh()(inp)))

    x = torch.randn(2, 3)
    assert torch.equal(graph(TN, TN.DynamicGraph)(x), graph(TN, TN.Graph)(x))


def test_within_iteration_cycle_raises_in_both_packages():
    for N in (JN, TN):
        a = N.Input()
        b = N.ReLU()(a)
        c = N.Tanh()(b)
        b.prev_nodes.append(c)
        with pytest.raises(ValueError, match="within-iteration cycle"):
            N.DynamicGraph(a, c)


# ---- specs and files -----------------------------------------------------------------
def _modules(N):
    return {"dynamic": _counter_graph(N, 6),
            "ifelse": _ifelse(N)}


@pytest.mark.parametrize("kind", ["dynamic", "ifelse"])
@pytest.mark.parametrize("fmt", ["npz", "bigdl"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_load_in_the_other_package(kind, fmt, writer, tmp_path):
    JRandom.RNG.set_seed(9)
    jm = _modules(JN)[kind]
    TRandom.RNG.set_seed(9)
    tm = _modules(TN)[kind]
    _carry(jm, tm)
    if fmt == "npz":
        assert TS.module_to_spec(tm) == JS.module_to_spec(jm)
    path = str(tmp_path / f"m.{fmt}")
    if writer == "jax":
        got = TS.load_module(JS.save_module(jm, path))
    else:
        got = JS.load_module(TS.save_module(tm, path))
    assert type(got).__name__ == type(jm).__name__
    x = np.random.RandomState(10).randn(2, 4 if kind == "ifelse" else 3) \
        .astype(np.float32)
    second = (True,) if kind == "ifelse" else (1.0,)
    args = (jnp.asarray(second[0]), jnp.asarray(x)) if kind == "ifelse" \
        else (jnp.asarray(x), jnp.asarray(second[0]))
    want = jm.forward(args)
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    with torch.no_grad():
        y = got(targs) if writer == "jax" else got.forward(args)
    _close(y, want)


def test_while_loop_specs_round_trip(tmp_path):
    from bigdl_tpu_torch.utils.serializer import register_module

    for cls in (_TCond, _TBody):
        register_module(cls)
    tm = TN.WhileLoop(_TCond(), _TBody())
    spec = TS.module_to_spec(tm)
    assert spec == {"class": "WhileLoop", "config": {},
                    "children": [{"class": "_TCond", "config": {}},
                                 {"class": "_TBody", "config": {}}]}
    got = TS.load_module(TS.save_module(tm, str(tmp_path / "w")))
    i, acc = got((torch.tensor(0), torch.ones(2)))
    assert int(i) == 5
