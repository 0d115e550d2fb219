"""The rest of the JAX package's table ops in the port, on the CPU.

Every class of ``bigdl_tpu/nn/table_ops.py`` the port lacked before this
slice: forward (tables, nested ones too), input gradients and the
children's parameter gradients against ``jax.vjp`` within 1e-5, on the
same parameters; ``InTopK``'s {0, 1} outputs exactly, with TF's rules
pinned (ties count in, a non-finite target score is out, a target out
of range is out); ``MapTable`` over a BN child in training mode
threads the running statistics through the entries in order, as JAX.
"""

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.utils import tree as T

from torch_port_parity import (carry, check_module, randomize_params, rel,
                               to_np)


def _n(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(*shapes, seed=0):
    return tuple(_n(*s, seed=seed + i) for i, s in enumerate(shapes))


# (id, build function over a package's nn, input maker, exact outputs)
CASES = [
    ("parallel", lambda N: N.ParallelTable().add(N.Linear(4, 3))
     .add(N.Tanh()), lambda: _t((2, 4), (2, 5)), 0),
    ("map", lambda N: N.MapTable(N.Linear(4, 3)),
     lambda: _t((2, 4), (2, 4), (2, 4)), 0),
    ("bottle", lambda N: N.Bottle(N.Linear(4, 3), 2, 2),
     lambda: _n(2, 3, 4), 0),
    ("bottle-3d", lambda N: N.Bottle(N.Linear(4, 3)), lambda: _n(2, 5, 3, 4),
     0),
    ("selecttable", lambda N: N.SelectTable(2),
     lambda: _t((2, 3), (2, 4), (2, 5)), 0),
    ("selecttable-last", lambda N: N.SelectTable(-1),
     lambda: _t((2, 3), (2, 4), (2, 5)), 0),
    ("narrowtable", lambda N: N.NarrowTable(2, 2),
     lambda: _t((2, 3), (2, 4), (2, 5), (1, 2)), 0),
    ("narrowtable-rest", lambda N: N.NarrowTable(2, -1),
     lambda: _t((2, 3), (2, 4), (2, 5)), 0),
    ("flattentable", lambda N: N.FlattenTable(),
     lambda: ((_n(2, 3), (_n(2, 4, seed=1), _n(1, seed=2))), _n(3, seed=3)),
     0),
    ("splittable", lambda N: N.SplitTable(2), lambda: _n(2, 3, 4), 0),
    ("splittable-neg", lambda N: N.SplitTable(-1), lambda: _n(2, 3, 4), 0),
    ("splittable-batched", lambda N: N.SplitTable(1, 2),
     lambda: _n(2, 3, 4), 0),
    ("bifurcate", lambda N: N.BifurcateSplitTable(2), lambda: _n(2, 4, 3), 0),
    ("pack", lambda N: N.Pack(2), lambda: _t((2, 3), (2, 3), (2, 3)), 0),
    ("csub", lambda N: N.CSubTable(), lambda: _t((3, 4), (3, 4)), 0),
    ("cdiv", lambda N: N.CDivTable(),
     lambda: (_n(3, 4), np.abs(_n(3, 4, seed=1)) + 0.5), 0),
    ("cmin", lambda N: N.CMinTable(), lambda: _t((3, 4), (3, 4), (3, 4)), 0),
    ("cave", lambda N: N.CAveTable(), lambda: _t((3, 4), (3, 4), (3, 4)), 0),
    ("mm", lambda N: N.MM(), lambda: _t((2, 3, 4), (2, 4, 5)), 0),
    ("mm-ta", lambda N: N.MM(True, False), lambda: _t((2, 4, 3), (2, 4, 5)),
     0),
    ("mm-tb", lambda N: N.MM(False, True), lambda: _t((3, 4), (5, 4)), 0),
    ("mv", lambda N: N.MV(), lambda: _t((2, 3, 4), (2, 4)), 0),
    ("mv-t", lambda N: N.MV(True), lambda: _t((2, 4, 3), (2, 4)), 0),
    ("dotproduct", lambda N: N.DotProduct(), lambda: _t((3, 5), (3, 5)), 0),
    ("cosinedistance", lambda N: N.CosineDistance(),
     lambda: _t((3, 5), (3, 5)), 0),
    ("mixture-table", lambda N: N.MixtureTable(),
     lambda: (_n(3, 2), (_n(3, 4, seed=1), _n(3, 4, seed=2))), 0),
    ("mixture-tensor", lambda N: N.MixtureTable(),
     lambda: (_n(3, 2), _n(3, 2, 4, seed=1)), 0),
    ("intopk", lambda N: N.InTopK(2),
     lambda: (_n(6, 5), np.array([0, 4, 2, 1, 3, 0], np.float32)), 1),
    ("where", lambda N: N.WhereTable(),
     lambda: ((_n(3, 4) > 0).astype(np.float32), _n(3, 4, seed=1),
              _n(3, 4, seed=2)), 0),
    ("where-leading", lambda N: N.WhereTable(True),
     lambda: (np.array([1, 0, 1], np.float32), _n(3, 4, seed=1),
              _n(3, 4, seed=2)), 0),
    ("where-trailing", lambda N: N.WhereTable(False),
     lambda: (np.array([1, 0, 0, 1], np.float32), _n(3, 4, seed=1),
              _n(3, 4, seed=2)), 0),
]


def _build(build, seed=7):
    JRandom.RNG.set_seed(seed)
    jm = build(JN)
    TRandom.RNG.set_seed(seed)
    tm = build(TN)
    return jm, tm


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_table_op_matches_jax(case):
    _, build, make, exact = case
    jm, tm = _build(build)
    jleaves = jax.tree.leaves(jm.params())
    assert len(jleaves) == len(T.leaves(tm.params()))
    for a, b in zip(jleaves, T.leaves(tm.params())):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))
    carry(jm, tm)
    if jax.tree.leaves(jm.params()):
        randomize_params(jm, tm)
    check_module(jm.evaluate(), tm.evaluate(), make(), exact=bool(exact))


def test_in_top_k_follows_tf():
    preds = np.array([[1.0, 2.0, 2.0, 0.0],      # target 1 ties 2: in
                      [1.0, 2.0, 3.0, 0.0],      # target 1, 3 higher: out
                      [np.nan, 0.0, 1.0, 0.0],   # non-finite target: out
                      [1.0, np.inf, 0.0, 0.0],   # +inf target: out
                      [1.0, 2.0, 3.0, 4.0],      # target 4: out of range
                      [1.0, 2.0, 3.0, 4.0]],     # target -1: out of range
                     np.float32)
    tgt = np.array([1, 1, 0, 1, 4, -1], np.float32)
    want = np.asarray(JN.InTopK(1).apply({}, {}, (preds, tgt))[0])
    np.testing.assert_array_equal(want, [1, 0, 0, 0, 0, 0])
    got = TN.InTopK(1)((torch.from_numpy(preds), torch.from_numpy(tgt)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    two = TN.InTopK(2)((torch.from_numpy(preds), torch.from_numpy(tgt)))
    np.testing.assert_array_equal(
        two.numpy(), np.asarray(JN.InTopK(2).apply({}, {}, (preds, tgt))[0]))
    assert two[1] == 1.0


def test_map_table_threads_bn_state_through_the_entries():
    jm, tm = _build(lambda N: N.MapTable(N.BatchNormalization(4)))
    carry(jm, tm)
    randomize_params(jm, tm)
    xs = tuple(_n(5, 4, seed=i) + i for i in range(3))
    new_state = check_module(jm, tm.train(), xs, training=True)
    got = tm.state()["0"]
    for k in ("running_mean", "running_var"):
        assert rel(got[k], new_state["0"][k]) <= 1e-6
    # in order: three EMA updates, the last entry's the latest
    rm = np.zeros(4, np.float32)
    for x in xs:
        rm = 0.9 * rm + 0.1 * x.mean(0)
    assert rel(got["running_mean"], rm) <= 1e-6


def test_single_child_containers_refuse_a_second():
    for cls in (TN.MapTable, TN.Bottle):
        m = cls(TN.Linear(2, 2))
        with pytest.raises(ValueError, match="exactly one"):
            m.add(TN.Linear(2, 2))
    with pytest.raises(ValueError, match="rank-3"):
        TN.Bottle(TN.Linear(4, 3), 3, 2)(torch.zeros(2, 3, 4))
