"""Every criterion of the JAX package in the port, on the CPU.

Each criterion's loss and its input gradient against
``jax.value_and_grad`` of the JAX criterion within 1e-5 of the largest
|JAX value|, on inputs and targets from a numpy seed, tables as
tuples.  The hazards the port copies are pinned both ways: ``BCE``'s
``log(p + 1e-12)`` at p = 0 and p = 1 (torch's BCE clamps the log at
-100), ``ClassSimplexCriterion``'s own approximate simplex, and
``MultiLabelMarginCriterion``'s target list that ends at its first 0.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.nn.criterion import ClassSimplexCriterion as JSimplex
from bigdl_tpu_torch import nn as TN

from torch_port_parity import check_loss, rel


def _n(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _u(*shape, seed=0, lo=0.05, hi=0.95):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _pm1(*shape, seed=1):
    return np.where(np.random.RandomState(seed).rand(*shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _cls(n, c, seed=1, shape=None):
    return (np.random.RandomState(seed).randint(0, c, shape or (n,))
            + 1).astype(np.float32)


def _logp(*shape, seed=0):
    x = _n(*shape, seed=seed)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _binary(*shape, seed=1):
    return (np.random.RandomState(seed).rand(*shape) < 0.5).astype(
        np.float32)


def _multilabel_targets():
    # row 0: classes 3 and 1; row 1: class 2 only, the 4 after the 0 is
    # not a target; row 2: no target at all
    return np.array([[3, 1, 0, 0], [2, 0, 4, 0], [0, 2, 1, 3]], np.float32)


# (id, build function over a package's nn, input maker, target maker)
CASES = [
    ("abs", lambda N: N.AbsCriterion(), lambda: _n(4, 5),
     lambda: _n(4, 5, seed=1)),
    ("abs-sum", lambda N: N.AbsCriterion(False), lambda: _n(4, 5),
     lambda: _n(4, 5, seed=1)),
    ("smoothl1", lambda N: N.SmoothL1Criterion(), lambda: _n(4, 5, scale=2),
     lambda: _n(4, 5, seed=1)),
    ("bce", lambda N: N.BCECriterion(), lambda: _u(4, 5), lambda: _binary(
        4, 5)),
    ("bce-weighted", lambda N: N.BCECriterion(
        np.linspace(0.5, 1.5, 5), False), lambda: _u(4, 5),
     lambda: _u(4, 5, seed=2, lo=0.0, hi=1.0)),
    ("bce-logits", lambda N: N.BCECriterionWithLogits(),
     lambda: _n(4, 5, scale=3), lambda: _binary(4, 5)),
    ("multilabel-softmargin", lambda N: N.MultiLabelSoftMarginCriterion(
        np.linspace(0.5, 1.5, 5)), lambda: _n(4, 5), lambda: _binary(4, 5)),
    ("margin", lambda N: N.MarginCriterion(), lambda: _n(6, 3),
     lambda: _pm1(6, 3)),
    ("margin-squared", lambda N: N.MarginCriterion(0.5, False, True),
     lambda: _n(6, 3), lambda: _pm1(6, 3)),
    ("hinge-embedding", lambda N: N.HingeEmbeddingCriterion(1.5),
     lambda: _u(6, 3, hi=2.0), lambda: _pm1(6, 3)),
    ("distkldiv", lambda N: N.DistKLDivCriterion(), lambda: _logp(4, 5),
     lambda: np.where(_binary(4, 5, seed=3) > 0, _u(4, 5, seed=2), 0.0)
     .astype(np.float32)),
    ("cosine-embedding", lambda N: N.CosineEmbeddingCriterion(0.1),
     lambda: (_n(6, 4), _n(6, 4, seed=2)), lambda: _pm1(6)),
    ("softmaxwith-valid", lambda N: N.SoftmaxWithCriterion(),
     lambda: _n(2, 4, 3, 3), lambda: _cls(0, 4, shape=(2, 3, 3))),
    ("softmaxwith-ignore", lambda N: N.SoftmaxWithCriterion(2),
     lambda: _n(2, 4, 3, 3), lambda: _cls(0, 4, shape=(2, 3, 3))),
    ("softmaxwith-full", lambda N: N.SoftmaxWithCriterion(3, "FULL"),
     lambda: _n(2, 4, 3, 3), lambda: _cls(0, 4, shape=(2, 3, 3))),
    ("softmaxwith-batch", lambda N: N.SoftmaxWithCriterion(
        None, "BATCH_SIZE"), lambda: _n(2, 4, 3), lambda: _cls(0, 4,
                                                               shape=(2, 3))),
    ("softmaxwith-none", lambda N: N.SoftmaxWithCriterion(1, "NONE"),
     lambda: _n(2, 4, 3), lambda: _cls(0, 4, shape=(2, 3))),
    ("multi", lambda N: N.MultiCriterion().add(N.MSECriterion(), 0.5)
     .add(N.AbsCriterion()), lambda: _n(4, 5), lambda: _n(4, 5, seed=1)),
    ("parallel", lambda N: N.ParallelCriterion().add(N.MSECriterion(), 0.3)
     .add(N.ClassNLLCriterion()), lambda: (_n(4, 5), _logp(4, 3)),
     lambda: (_n(4, 5, seed=1), _cls(4, 3))),
    ("parallel-repeat", lambda N: N.ParallelCriterion(True)
     .add(N.MSECriterion()).add(N.AbsCriterion(), 2.0),
     lambda: (_n(4, 5), _n(4, 5, seed=2)), lambda: _n(4, 5, seed=1)),
    ("classsimplex", lambda N: N.ClassSimplexCriterion(5),
     lambda: _n(6, 5), lambda: _cls(6, 5)),
    ("l1cost", lambda N: N.L1Cost(), lambda: _n(4, 5), lambda: _n(4, 5)),
    ("marginranking", lambda N: N.MarginRankingCriterion(0.5),
     lambda: (_n(6), _n(6, seed=2)), lambda: _pm1(6)),
    ("multimargin", lambda N: N.MultiMarginCriterion(), lambda: _n(6, 4),
     lambda: _cls(6, 4)),
    ("multimargin-p2-weights", lambda N: N.MultiMarginCriterion(
        2, np.linspace(0.5, 2.0, 4), 0.7, False), lambda: _n(6, 4),
     lambda: _cls(6, 4)),
    ("cosinedistance", lambda N: N.CosineDistanceCriterion(),
     lambda: _n(6, 4), lambda: _n(6, 4, seed=2)),
    ("dice", lambda N: N.DiceCoefficientCriterion(epsilon=0.5),
     lambda: _u(3, 2, 4), lambda: _binary(3, 2, 4)),
    ("softmargin", lambda N: N.SoftMarginCriterion(),
     lambda: _n(6, 3, scale=3), lambda: _pm1(6, 3)),
    ("multilabelmargin", lambda N: N.MultiLabelMarginCriterion(),
     lambda: _n(3, 4), _multilabel_targets),
    ("multilabelmargin-1d", lambda N: N.MultiLabelMarginCriterion(False),
     lambda: _n(4), lambda: np.array([2, 4, 0, 1], np.float32)),
    ("gaussian", lambda N: N.GaussianCriterion(),
     lambda: (_n(4, 3), _n(4, 3, seed=2, scale=0.5)),
     lambda: _n(4, 3, seed=3)),
    ("kld", lambda N: N.KLDCriterion(),
     lambda: (_n(4, 3), _n(4, 3, seed=2, scale=0.5)), lambda: _n(4, 3)),
    ("l1hinge", lambda N: N.L1HingeEmbeddingCriterion(2.0),
     lambda: (_n(6, 3), _n(6, 3, seed=2)), lambda: _pm1(6)),
    ("poisson", lambda N: N.PoissonCriterion(), lambda: _u(4, 5, hi=3.0),
     lambda: _u(4, 5, seed=2, hi=3.0)),
    ("cosineproximity", lambda N: N.CosineProximityCriterion(),
     lambda: _n(4, 5), lambda: _n(4, 5, seed=2)),
    ("mape", lambda N: N.MeanAbsolutePercentageCriterion(),
     lambda: _n(4, 5), lambda: _n(4, 5, seed=2)),
    ("msle", lambda N: N.MeanSquaredLogarithmicCriterion(),
     lambda: _u(4, 5, hi=3.0), lambda: _u(4, 5, seed=2, hi=3.0)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_criterion_matches_jax(case):
    _, build, make_input, make_target = case
    check_loss(build(JN), build(TN), make_input(), make_target())


def test_bce_takes_the_log_of_p_plus_eps_at_0_and_1():
    p = np.array([[0.0, 1.0, 0.3], [1.0, 0.0, 0.999]], np.float32)
    t = np.array([[1.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    for name in ("BCECriterion", "MultiLabelSoftMarginCriterion"):
        x = p if name == "BCECriterion" else (p - 0.5) * 60
        got = check_loss(getattr(JN, name)(), getattr(TN, name)(), x, t)
        assert np.isfinite(got)
    # -log(1e-12) at the wrong-side 0, where torch's clamp gives 100
    wrong = np.array([0.0], np.float32)
    got = TN.BCECriterion().loss(torch.from_numpy(wrong), torch.ones(1))
    assert abs(float(got) + np.log(1e-12)) < 1e-3
    clamped = F.binary_cross_entropy(torch.from_numpy(wrong), torch.ones(1))
    assert abs(float(clamped) - 100.0) < 1e-3


def test_class_simplex_is_the_jax_table():
    for n in (2, 3, 5, 10):
        got = TN.ClassSimplexCriterion(n)._simplex
        np.testing.assert_array_equal(got, JSimplex._build_simplex(n))
    a = TN.ClassSimplexCriterion(4)._simplex
    np.testing.assert_allclose(np.linalg.norm(a[1:], axis=1), 1.0,
                               rtol=1e-6)
    # not a regular simplex: its pairwise distances differ
    d = [np.linalg.norm(a[i] - a[j]) for i in range(4) for j in range(i)]
    assert max(d) - min(d) > 0.1


def test_multilabel_margin_targets_end_at_the_first_zero():
    x = _n(3, 4, seed=4)
    t = _multilabel_targets()
    got = check_loss(JN.MultiLabelMarginCriterion(),
                     TN.MultiLabelMarginCriterion(), x, t)
    # were the 4 after row 1's 0 a target, the loss would differ
    t_all = t.copy()
    t_all[1] = [2, 4, 0, 0]
    other = float(TN.MultiLabelMarginCriterion().loss(
        torch.from_numpy(x), torch.from_numpy(t_all)))
    assert abs(other - got) > 1e-3
    # row 2 has no target: it adds nothing
    only = float(TN.MultiLabelMarginCriterion(False).loss(
        torch.from_numpy(x[2:]), torch.from_numpy(t[2:])))
    assert only == 0.0


def test_port_criterions_take_numpy_targets():
    x = torch.tensor(_n(4, 5), requires_grad=True)
    t = _n(4, 5, seed=1)
    a = TN.SmoothL1Criterion().loss(x, t)
    b = TN.SmoothL1Criterion().loss(x, torch.from_numpy(t))
    assert torch.equal(a, b)
    want = JN.SmoothL1Criterion().loss(jnp.asarray(_n(4, 5)), jnp.asarray(t))
    assert rel(a, want) <= 1e-6
