"""The port's Graph container and the layers of Inception, VGG and the
Caffe loader against the JAX package, on the CPU.

- Every new layer (LRN at odd and even sizes, pooling in ceil mode at
  odd sizes, the transposed and dilated convolutions, ``Scale``,
  ``PReLU``, the activations, the table ops and ``Concat``): forward
  and input gradient within 1e-5 of the largest |JAX value|, on the
  JAX layer's weights carried over with ``utils/convert``.
- ``Graph`` built by hand (fan-out, fan-in through ``JoinTable`` and
  ``CAddTable``, two inputs) and by ``Sequential.to_graph`` from a tiny
  Inception: forward, ``params()`` leaf paths and the gradients of
  every parameter and input against ``jax.grad``, within 1e-5.
- A module called on nodes makes a node, on tensors runs forward; the
  forward drops each value after its last consumer.
- Graph specs and checkpoints load across the packages.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.models.inception import inception_layer_v1 as j_inc_v1
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.models.inception import inception_layer_v1 as t_inc_v1
from bigdl_tpu_torch.nn.graph import Node
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

TOL = 1e-5


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _carry(jm, tm):
    """The JAX module's parameters and state into the port's."""
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    load_jax_state(tm, jax.tree.map(np.asarray, jm.state()))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _check_module(jm, tm, xs, seed=0, training=False):
    """Forward and input gradients (and parameter gradients) of one
    module, JAX against port, on ``xs`` (one array or a tuple of them,
    a tuple being the module's table input)."""
    table = isinstance(xs, tuple)
    jxs = tuple(jnp.asarray(x) for x in _as_tuple(xs))
    params, state = jm.params(), jm.state()

    def f(p, *x):
        return jm.apply(p, state, x if table else x[0],
                        training=training)[0]

    y = f(params, *jxs)
    cot = np.random.RandomState(seed + 100).randn(
        *y.shape).astype(np.float32)
    _, vjp = jax.vjp(f, params, *jxs)
    gp, *gx = vjp(jnp.asarray(cot))

    txs = [torch.tensor(x, requires_grad=True) for x in _as_tuple(xs)]
    ty = tm(tuple(txs) if table else txs[0])
    assert _rel(ty, y) <= TOL, "forward"
    ty.backward(torch.from_numpy(cot))
    for a, b in zip(txs, gx):
        assert _rel(a.grad, b) <= TOL, "input gradient"
    tg = {n: p.grad for n, p in tm.named_parameters()}
    pairs = T.leaves_with_paths(tm.params())
    jleaves = jax.tree.leaves(gp)
    assert len(pairs) == len(jleaves)
    by_id = {id(p): n for n, p in tm.named_parameters()}
    for (path, p), b in zip(pairs, jleaves):
        assert _rel(tg[by_id[id(p)]], b) <= TOL, f"gradient of {path}"


def _x(*shape, seed=0, positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


# (name, constructor arguments, input shapes, positive inputs)
LAYER_CASES = [
    ("SpatialCrossMapLRN", (5, 0.0001, 0.75), [(2, 7, 5, 5)], False),
    ("SpatialCrossMapLRN", (4, 0.5, 0.75, 2.0), [(2, 7, 5, 5)], False),
    ("SpatialCrossMapLRN", (3, 1.0, 0.5), [(7, 4, 4)], False),
    ("SpatialCrossMapLRN", (2, 0.3, 0.9, 1.5), [(1, 3, 3, 3)], False),
    ("SpatialMaxPooling", "ceil", [(2, 3, 11, 9)], False),
    ("SpatialMaxPooling", "ceil_pad", [(2, 3, 13, 13)], False),
    ("SpatialMaxPooling", "floor", [(2, 3, 11, 9)], False),
    ("SpatialAveragePooling", "ceil", [(2, 3, 11, 9)], False),
    ("SpatialAveragePooling", "ceil_pad", [(2, 3, 13, 7)], False),
    ("SpatialAveragePooling", "ceil_nopadcount", [(2, 3, 13, 7)], False),
    ("SpatialFullConvolution", (4, 6, 3, 3, 2, 2, 1, 1, 1, 1),
     [(2, 4, 5, 6)], False),
    ("SpatialFullConvolution", (4, 6, 4, 3, 2, 1, 1, 0, 0, 0, 2),
     [(2, 4, 5, 6)], False),
    ("SpatialFullConvolution", (3, 5, 3, 3, 1, 1, 0, 1, 1, 2),
     [(2, 3, 4, 5)], False),
    ("SpatialDilatedConvolution", (3, 5, 3, 3, 1, 2, 2, 1, 2, 1),
     [(2, 3, 9, 8)], False),
    ("Scale", ((5, 1, 1),), [(2, 5, 3, 4)], False),
    ("PReLU", (0,), [(2, 5, 3, 4)], False),
    ("PReLU", (5,), [(2, 5, 3, 4)], False),
    ("SoftMax", (), [(4, 7)], False),
    ("SoftPlus", (2.0,), [(4, 7)], False),
    ("ELU", (0.5,), [(4, 7)], False),
    ("LeakyReLU", (0.1,), [(4, 7)], False),
    ("Abs", (), [(4, 7)], False),
    ("Power", (2.0, 0.5, 1.5), [(4, 7)], True),
    ("Power", (0.5,), [(4, 7)], True),
    ("Exp", (), [(4, 7)], False),
    ("Log", (), [(4, 7)], True),
    ("Dropout", (0.3,), [(4, 7)], False),
    ("JoinTable", (2,), [(2, 3, 4), (2, 5, 4)], False),
    ("JoinTable", (1, 2), [(2, 3, 4), (2, 5, 4)], False),
    ("CMulTable", (), [(3, 4), (3, 4), (3, 4)], False),
    ("CMaxTable", (), [(3, 4), (3, 4)], False),
]

POOL_ARGS = {"ceil": ((3, 3, 2, 2), {}),
             "ceil_pad": ((3, 3, 2, 2, 1, 1), {}),
             "floor": ((3, 3, 2, 2), {}),
             "ceil_nopadcount": ((3, 3, 2, 2, 1, 1),
                                 {"count_include_pad": False})}


def _pair(name, args):
    """(JAX module, port module) of layer ``name``, the port's with the
    JAX one's weights."""
    kw = {}
    mode = None
    if isinstance(args, str):
        mode = args
        args, kw = POOL_ARGS[mode]
    JRandom.RNG.set_seed(7)
    jm = getattr(JN, name)(*args, **kw)
    tm = getattr(TN, name)(*args, **kw)
    if mode:
        if mode == "floor":
            jm.ceil().floor()
            assert tm.ceil().floor() is tm
        else:
            jm.ceil()
            tm.ceil()
        assert tm.get_config() == jm.get_config()
    _carry(jm, tm)
    if name in ("PReLU", "Scale"):
        # off their constant initial values, so the slope and the
        # scale carry a signal of their own
        rs = np.random.RandomState(5)
        tree = {k: rs.uniform(0.1, 0.9, np.shape(v)).astype(np.float32)
                for k, v in jm.params().items()}
        jm.set_params({k: jnp.asarray(v) for k, v in tree.items()})
        load_jax_params(tm, tree)
    jm.evaluate()
    tm.evaluate()
    return jm, tm


@pytest.mark.parametrize("name,args,shapes,positive", LAYER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LAYER_CASES)])
def test_layer_matches_jax(name, args, shapes, positive):
    jm, tm = _pair(name, args)
    xs = tuple(_x(*s, seed=i, positive=positive)
               for i, s in enumerate(shapes))
    _check_module(jm, tm, xs if len(xs) > 1 else xs[0])
    if name not in ("JoinTable", "CMulTable", "CMaxTable"):
        assert tm.get_config() == jm.get_config()


def test_transposed_weight_layout_is_pinned():
    """JAX's (out, in/group, kh, kw) weight onto ``conv_transpose2d``'s
    (in, out/group, kh, kw): group g's rows go to rows g·in/group + i."""
    m = TN.SpatialFullConvolution(4, 6, 3, 2, n_group=2)
    w = m.weight.detach()
    wt = m._transposed_weight().detach()
    assert tuple(wt.shape) == (4, 3, 2, 3)
    for g in range(2):
        for o in range(3):
            for i in range(2):
                assert torch.equal(wt[g * 2 + i, o], w[g * 3 + o, i])


def test_dropout_mask_and_seeds():
    x = torch.ones(4000)
    d = TN.Dropout(0.25).train()
    y = d(x, rng_seed=11)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(d(x, rng_seed=11), y)
    assert not torch.equal(d(x, rng_seed=12), y)
    assert torch.equal(d(x), x)                   # no seed: identity
    assert torch.equal(d.evaluate()(x, rng_seed=11), x)
    unscaled = TN.Dropout(0.25, scale=False).train()(x, rng_seed=11)
    assert torch.equal(unscaled, kept.float())
    # a container hands child i fold_in(seed, i), as Sequential does
    seq = TN.Sequential().add(TN.ReLU()).add(TN.Dropout(0.25))
    g = seq.to_graph()
    assert g.takes_rng_seed and seq.takes_rng_seed
    from bigdl_tpu_torch.common import fold_in
    assert torch.equal(seq(x, rng_seed=3), d.train()(x, fold_in(3, 1)))
    assert torch.equal(g(x, rng_seed=3), d(x, fold_in(3, 2)))


@pytest.mark.parametrize("table", ["Concat", "ConcatTable"])
def test_branch_containers_hand_child_i_its_seed(table):
    """Concat and ConcatTable hand child i ``fold_in(seed, i)``, as JAX's
    do (table_ops.py:31, :269)."""
    from bigdl_tpu_torch.common import fold_in
    x = torch.ones(1, 4000)
    d = TN.Dropout(0.25).train()
    m = TN.Concat(2) if table == "Concat" else TN.ConcatTable()
    assert not m.add(TN.ReLU()).takes_rng_seed
    m.add(d).train()
    assert m.takes_rng_seed
    y = m(x, rng_seed=3)
    if table == "Concat":
        y = (y[:, :4000], y[:, 4000:])
    assert torch.equal(y[0], x)
    assert torch.equal(y[1], d(x, fold_in(3, 1)))
    assert not torch.equal(y[1], d(x, 3))


def test_module_call_builds_nodes_or_runs_forward():
    conv = TN.SpatialConvolution(3, 4, 1, 1)
    x = torch.randn(2, 3, 4, 4)
    assert isinstance(conv(x), torch.Tensor)
    inp = TN.Input("data")
    node = conv(inp)
    assert isinstance(node, Node) and node.prev_nodes == [inp]
    assert node.module is conv
    src = TN.ReLU()()
    assert isinstance(src, Node) and src.prev_nodes == []
    add = TN.CAddTable()
    assert torch.equal(add((x, x)), 2 * x)        # a table is a forward
    join = add(node, [node, src])
    assert join.prev_nodes == [node, node, src]
    assert TN.Dropout(0.5).train()(x, rng_seed=1).shape == x.shape
    # an acyclic DynamicGraph of these nodes runs as the Graph does
    assert torch.equal(TN.DynamicGraph(inp, node)(x), TN.Graph(inp, node)(x))


def _hand_graph(N):
    """Two inputs, a fan-out of ``a`` into two convs, a three-way
    ``JoinTable`` fan-in, a ``CAddTable`` and a ``Linear`` head."""
    x1, x2 = N.Input("x1"), N.Input("x2")
    a = N.ReLU()(N.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)
                 .set_name("a")(x1))
    b = N.SpatialConvolution(4, 5, 1, 1).set_name("b")(a)
    c = N.SpatialConvolution(4, 3, 3, 3, 1, 1, 1, 1).set_name("c")(a)
    j = N.JoinTable(2)(b, c, x2)
    s = N.CAddTable()(N.SpatialConvolution(11, 6, 1, 1)(j),
                      N.Tanh()(N.SpatialConvolution(11, 6, 3, 3, 1, 1, 1,
                                                    1)(j)))
    p = N.SpatialMaxPooling(3, 3, 2, 2).ceil()(s)
    out = N.Linear(6 * 3 * 3, 5)(N.Reshape([6 * 3 * 3])(p))
    return N.Graph([x1, x2], out)


def _tiny_inception(N, inc_v1, dropout=False):
    """tests/test_caffe_training.py's tiny Inception-v1 (stem conv, LRN,
    two Inception blocks, the average-pool head)."""
    m = N.Sequential() \
        .add(N.SpatialConvolution(3, 16, 3, 3, 1, 1, 1, 1).set_name("conv1")) \
        .add(N.ReLU()) \
        .add(N.SpatialMaxPooling(2, 2, 2, 2).ceil().set_name("pool1")) \
        .add(N.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1")) \
        .add(inc_v1(16, [[8], [8, 12], [4, 6], [6]], "inc_a/")) \
        .add(inc_v1(32, [[12], [8, 16], [4, 8], [8]], "inc_b/")) \
        .add(N.SpatialAveragePooling(8, 8, 1, 1).set_name("pool5"))
    if dropout:
        m.add(N.Dropout(0.05))
    return m.add(N.Reshape([44])).add(N.Linear(44, 5).set_name("fc"))


def _paths(tree):
    return ["/".join(p) for p, _ in T.leaves_with_paths(tree)]


@pytest.mark.parametrize("case", ["hand", "to_graph"])
def test_graph_matches_jax(case):
    JRandom.RNG.set_seed(21)
    TRandom.RNG.set_seed(21)
    if case == "hand":
        jg, tg = _hand_graph(JN), _hand_graph(TN)
        xs = (_x(2, 3, 6, 6, seed=1), _x(2, 3, 6, 6, seed=2))
    else:
        jg = _tiny_inception(JN, j_inc_v1, dropout=True).to_graph()
        tg = _tiny_inception(TN, t_inc_v1, dropout=True).to_graph()
        assert isinstance(tg, TN.Graph)
        assert len(tg.topo_order()) == len(jg.topo_order())
        xs = _x(2, 3, 16, 16, seed=3)
    # built from one seed, both packages draw the same weights
    for a, b in zip(T.leaves(tg.params()), jax.tree.leaves(jg.params())):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert _paths(tg.params()) == _paths(jax.tree.map(np.asarray,
                                                      jg.params()))
    _carry(jg, tg)
    jg.evaluate()
    tg.evaluate()
    _check_module(jg, tg, xs, seed=4)


def test_to_graph_shares_the_sequential_modules():
    seq = _tiny_inception(TN, t_inc_v1)
    g = seq.to_graph()
    names = [n.module._name for n in g.topo_order()]
    assert names[0] == "data" and "inc_a/" not in names
    joins = [n.module for n in g.topo_order()
             if isinstance(n.module, TN.JoinTable)]
    assert [j.dimension for j in joins] == [2, 2]
    with torch.no_grad():
        seq.modules[0].weight.mul_(2.0)
    x = torch.randn(2, 3, 16, 16)
    assert torch.equal(g.evaluate()(x), seq.evaluate()(x))


def test_forward_drops_values_after_their_last_consumer():
    inp = TN.Input("x")
    mods = [TN.Tanh() for _ in range(4)]
    a = mods[0](inp)
    b = mods[1](a)
    c = mods[2](b)
    d = TN.CAddTable()(mods[3](c), a)       # a is read again at the end
    g = TN.Graph(inp, d)
    refs = {}
    alive_at_last = {}

    def keep(i):
        def hook(mod, args, out):
            refs[i] = weakref.ref(out)
        return hook

    for i, m in enumerate(mods):
        m.register_forward_hook(keep(i))

    def probe(mod, args):
        gc.collect()
        alive_at_last.update({i: r() is not None for i, r in refs.items()})

    mods[3].register_forward_pre_hook(probe)
    with torch.no_grad():
        g(torch.randn(3, 4))
    # b was read by c only; a waits for the CAddTable; c feeds mods[3]
    assert alive_at_last == {0: True, 1: False, 2: True}


def _small_graph(N):
    inp = N.Input("data")
    c = N.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1).set_name("conv")(inp)
    bn = N.SpatialBatchNormalization(4).set_name("bn")(c)
    r = N.ReLU()(bn)
    j = N.JoinTable(2)(r, N.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()(c))
    out = N.Linear(8 * 4 * 4, 3)(N.Reshape([8 * 4 * 4])(j))
    return N.Graph(inp, N.LogSoftMax()(out))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_graph_module_files_load_across_packages(tmp_path, writer):
    JRandom.RNG.set_seed(5)
    jg = _small_graph(JN)
    TRandom.RNG.set_seed(6)
    tg = _small_graph(TN)
    x = _x(2, 3, 4, 4)
    if writer == "jax":
        path = JS.save_module(jg, str(tmp_path / "g"))
        got, ref = TS.load_module(path), jg
    else:
        path = TS.save_module(tg, str(tmp_path / "g"))
        got, ref = JS.load_module(path), tg
    assert type(got).__name__ == "Graph"
    assert TS.module_to_spec(tg)["graph"] == JS.module_to_spec(jg)["graph"]
    got.evaluate()
    ref.evaluate()
    y = ref.forward(torch.from_numpy(x)) if writer == "torch" \
        else ref.forward(jnp.asarray(x))
    z = got.forward(jnp.asarray(x)) if writer == "torch" \
        else got(torch.from_numpy(x))
    assert _rel(z, _np(y)) <= TOL
    for a, b in zip(T.leaves(got.params()), T.leaves(ref.params())):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_dynamic_graph_specs_raise():
    """A ``DynamicGraph`` spec loads now; one whose node lists a later
    node as its predecessor (a cycle outside the feedback edges; specs
    list nodes in topological order) raises, in both packages."""
    spec = TS.module_to_spec(_small_graph(TN))
    spec["class"] = "DynamicGraph"
    spec["config"] = {"max_iterations": 4}
    g = TS.spec_to_module(spec)
    assert type(g).__name__ == "DynamicGraph" and g.max_iterations == 4
    nodes = spec["graph"]["nodes"]
    nodes[1]["prev"] = nodes[1]["prev"] + [len(nodes) - 1]
    for S in (TS, JS):
        with pytest.raises(IndexError):
            S.spec_to_module(spec)


def _trained_graph(N, O, Local, Array, seed, ck=None):
    """A LocalOptimizer run of 4 steps on ``_small_graph`` with SGD
    momentum, a checkpoint after step 2 when ``ck`` is given."""
    rs = np.random.RandomState(9)
    x = rs.randn(16, 3, 4, 4).astype(np.float32)
    y = (rs.randint(0, 3, 16) + 1).astype(np.float32)
    N_RNG = JRandom if N is JN else TRandom
    N_RNG.RNG.set_seed(seed)
    g = _small_graph(N)
    kw = {} if N is JN else {"device": "cpu"}
    opt = Local(g, Array(x, y, 4, shuffle=False), N.ClassNLLCriterion(), 4,
                **kw)
    opt.set_optim_method(O.SGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(O.Trigger.max_iteration(2))
    if ck:
        opt.set_checkpoint(str(ck), O.Trigger.several_iteration(2))
    opt.optimize()
    return g, opt


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_graph_checkpoint_loads_in_the_other_package(tmp_path, writer):
    if writer == "jax":
        wg, wopt = _trained_graph(JN, JO, JLocal, JArray, 1, tmp_path)
        TRandom.RNG.set_seed(2)
        rg = _small_graph(TN)
        ro = TO.SGD(learningrate=0.1, momentum=0.9)
        TS.load_latest_checkpoint(str(tmp_path), rg, ro)
    else:
        wg, wopt = _trained_graph(TN, TO, TO.LocalOptimizer, TArray, 1,
                                  tmp_path)
        JRandom.RNG.set_seed(2)
        rg = _small_graph(JN)
        ro = JO.SGD(learningrate=0.1, momentum=0.9)
        JS.load_latest_checkpoint(str(tmp_path), rg, ro)
    for tree in ("params", "state"):
        w = T.leaves(getattr(wg, tree)())
        r = T.leaves(getattr(rg, tree)())
        assert len(w) == len(r) > 0
        for a, b in zip(w, r):
            np.testing.assert_array_equal(_np(a), _np(b))
    assert ro.state is not None
