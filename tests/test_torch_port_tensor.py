"""The ``Tensor`` facade (``bigdl_tpu/tensor.py``) in the port, on the
CPU.

Every method of JAX's facade, applied to both facades on the same
arrays: the results (scalars, facades, tuples and lists of them) equal
JAX's, dtypes too, within 1e-6 where a reduction's order may differ
and bit for bit elsewhere; the random fills draw the JAX numbers after
one seed.  A facade goes straight into a layer, a criterion, a torch
function and a ``LocalOptimizer``'s dataset.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu.tensor import Tensor as JT
from bigdl_tpu.tensor import rand as j_rand
from bigdl_tpu.tensor import randn as j_randn
from bigdl_tpu_torch import Tensor as TT
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.tensor import rand as t_rand
from bigdl_tpu_torch.tensor import randn as t_randn

from torch_port_parity import carry

rs = np.random.RandomState(0)
A = rs.randn(3, 4).astype(np.float32)
B = rs.randn(3, 4).astype(np.float32)
SQ = rs.randn(3, 3).astype(np.float32)
V4 = rs.randn(4).astype(np.float32)
V3 = rs.randn(3).astype(np.float32)
POS = (np.abs(A) + 0.5).astype(np.float32)
MASK = (rs.rand(3, 4) > 0.5).astype(np.float32)
IDX = np.array([[1, 2], [3, 1], [4, 4]], np.float32)


def _jnp_dtype_name(d):
    return str(np.dtype(d)) if not isinstance(d, torch.dtype) else \
        str(d).replace("torch.", "")


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, JT):
        assert isinstance(got, TT)
        g, w = got.to_ndarray(), want.to_ndarray()
        assert _jnp_dtype_name(got.dtype) == _jnp_dtype_name(want.dtype)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        return
    if isinstance(want, (float, np.floating)):
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
        return
    assert got == want


# (id, fn of (Tensor class, its module's randn/rand) -> result)
OPS = [
    ("sized", lambda T: T(2, 3)),
    ("wrap-list", lambda T: T([1.0, 2.0])),
    ("wrap-f64", lambda T: T(np.arange(4.0))),
    ("wrap-int64", lambda T: T(np.arange(4))),
    ("scalar", lambda T: T()),
    ("size", lambda T: (T(A).size(), T(A).size(2))),
    ("dim", lambda T: (T(A).dim(), T(A).n_dimension(), T(A).nDimension)),
    ("n_element", lambda T: (T(A).n_element(), T(A).nElement())),
    ("shape", lambda T: tuple(T(A).shape)),
    ("empty-scalar", lambda T: (T(A).is_empty(), T().is_scalar())),
    ("narrow", lambda T: T(A).narrow(2, 2, 2)),
    ("select", lambda T: T(A).select(1, 2)),
    ("index_select", lambda T: T(A).index_select(2, [4, 1])),
    ("view", lambda T: T(A).view(4, 3)),
    ("reshape-list", lambda T: T(A).reshape([2, 6])),
    ("squeeze", lambda T: T(A[:1]).squeeze()),
    ("squeeze-dim", lambda T: T(A[:1]).squeeze(1)),
    ("unsqueeze", lambda T: T(A).unsqueeze(2)),
    ("t", lambda T: T(A).t()),
    ("transpose", lambda T: T(A).transpose(1, 2)),
    ("clone", lambda T: T(A).clone()),
    ("contiguous", lambda T: T(A).contiguous()),
    ("set", lambda T: T(2).set(T(B))),
    ("copy", lambda T: T(3, 4).copy(T(B))),
    ("fill-zero", lambda T: (T(A).fill(2.5), T(A).zero())),
    ("resize-keep", lambda T: T(A).resize(2, 6)),
    ("resize-new", lambda T: T(A).resize([5])),
    ("resize_as", lambda T: T(A).resize_as(T(SQ))),
    ("set_value", lambda T: T(A).set_value(2, 3, 9.0).value_at(2, 3)),
    ("add-sub", lambda T: T(A).add(T(B)).sub(0.5)),
    ("mul-div", lambda T: T(A).mul(2.0).div(T(POS))),
    ("cmul-cdiv", lambda T: T(A).cmul(T(B)).cdiv(T(POS))),
    ("pow-sqrt", lambda T: T(POS).pow(3).sqrt()),
    ("exp-log-abs", lambda T: (T(A).exp(), T(POS).log(), T(A).abs())),
    ("addmm", lambda T: T(SQ).addmm(T(A), T(B).t())),
    ("mm", lambda T: T(3, 3).mm(T(A), T(B).t())),
    ("mv", lambda T: T(3).mv(T(A), T(V4))),
    ("dot", lambda T: T(A).dot(T(B))),
    ("sum", lambda T: (T(A).sum(), T(A).sum(2))),
    ("mean", lambda T: (T(A).mean(), T(A).mean(1))),
    ("max", lambda T: (T(A).max(), T(A).max(2))),
    ("min", lambda T: (T(A).min(), T(A).min(1))),
    ("norm", lambda T: (T(A).norm(), T(A).norm(1))),
    ("apply1", lambda T: T(A).apply1(lambda v: v * v + 1)),
    ("map", lambda T: T(A).map(T(B), lambda a, b: a - 2 * b)),
    ("gather", lambda T: T(A).gather(2, IDX)),
    ("scatter", lambda T: T(3, 4).scatter(2, IDX, T(B))),
    ("scatter-scalar", lambda T: T(3, 4).scatter(2, IDX, 7.0)),
    ("masked_fill", lambda T: T(A).masked_fill(MASK, -1.0)),
    ("masked_select", lambda T: T(A).masked_select(MASK)),
    ("masked_copy", lambda T: T(A).masked_copy(MASK, np.arange(
        12, dtype=np.float32))),
    ("index_fill", lambda T: T(A).index_fill(1, [1, 3], 7.0)),
    ("index_copy", lambda T: T(A).index_copy(2, [2, 4], B[:, :2])),
    ("index_add", lambda T: T(A).index_add(2, [1, 2], B[:, :2])),
    ("cmax-cmin", lambda T: (T(A).cmax(0.0), T(A).cmin(T(B)))),
    ("clamp", lambda T: T(A).clamp(-0.5, 0.5)),
    ("sign-floor-ceil", lambda T: (T(A).sign(), T(A * 3).floor(),
                                   T(A * 3).ceil())),
    ("addcmul", lambda T: T(A).addcmul(0.5, T(B), T(POS))),
    ("addcdiv", lambda T: T(A).addcdiv(0.5, T(B), T(POS))),
    ("addr", lambda T: T(3, 4).addr(V3, V4)),
    ("topk", lambda T: T(A).topk(2)),
    ("topk-increase-dim", lambda T: T(A).topk(2, 1, True)),
    ("sort", lambda T: (T(A).sort(), T(A).sort(1, True))),
    ("nonzero", lambda T: T(np.array([[0.0, 2.0], [3.0, 0.0]],
                                     np.float32)).nonzero()),
    ("expand", lambda T: T(A[:1]).expand(4, 4)),
    ("repeat_tensor", lambda T: (T(A).repeat_tensor(2, 1),
                                 T(V4).repeat_tensor(2, 2))),
    ("split-chunk", lambda T: (T(A).split(2, 2), T(A).chunk(2, 1))),
    ("camel", lambda T: (T(A).maskedFill(MASK, 0.0), T(A).indexSelect(
        1, [2]), T(A).repeatTensor(1, 2), T(A).resizeAs(T(SQ)))),
    ("operators", lambda T: (T(A) + T(B), 1.0 + T(A), T(A) - 2.0,
                             3.0 - T(A), T(A) * T(B), 2.0 * T(A),
                             T(A) / T(POS), -T(A))),
    ("getitem-len-eq", lambda T: (T(A)[1], T(A)[1, 2], len(T(A)),
                                  T(A) == T(A.copy()), T(A) == T(B))),
]


@pytest.mark.parametrize("op", OPS, ids=[o[0] for o in OPS])
def test_method_matches_jax(op):
    _same(op[1](TT), op[1](JT))


def test_random_fills_draw_the_jax_numbers():
    for seed in (1, 2):
        JRandom.RNG.set_seed(seed)
        TRandom.RNG.set_seed(seed)
        _same((TT(3, 4).uniform(2.0, 4.0), TT(5).normal(1.0, 0.5),
               TT(2, 6).bernoulli(0.3), t_randn(2, 3), t_rand(4)),
              (JT(3, 4).uniform(2.0, 4.0), JT(5).normal(1.0, 0.5),
               JT(2, 6).bernoulli(0.3), j_randn(2, 3), j_rand(4)))


def test_bridges():
    t = TT.from_ndarray(A)
    np.testing.assert_array_equal(np.asarray(t), A)
    np.testing.assert_array_equal(t.to_ndarray(), A)
    assert isinstance(t.data, torch.Tensor)
    # torch functions take a facade as they take its tensor
    bt = torch.from_numpy(B).t()
    np.testing.assert_array_equal(torch.matmul(t, bt).numpy(),
                                  torch.matmul(torch.from_numpy(A), bt)
                                  .numpy())
    assert torch.add(t, 1.0).dtype == torch.float32


def test_a_facade_feeds_a_layer_a_criterion_and_a_trainer():
    JRandom.RNG.set_seed(3)
    jm = JN.Linear(4, 3)
    TRandom.RNG.set_seed(3)
    tm = TN.Linear(4, 3)
    carry(jm, tm)
    x = TT(A)
    with torch.no_grad():
        out = tm(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.forward(JT(A)
                                                                  .data)),
                               rtol=1e-6, atol=1e-6)
    target = TT(np.array([1.0, 3.0, 2.0], np.float32))
    loss = TN.CrossEntropyCriterion().forward(out, target)
    want = JN.CrossEntropyCriterion().forward(
        jm.forward(JT(A).data), JT(np.array([1.0, 3.0, 2.0])).data)
    assert abs(float(loss) - float(want)) <= 1e-6
    # a facade pair as a LocalOptimizer's dataset
    xs = rs.randn(16, 4).astype(np.float32)
    ys = (rs.randint(0, 3, 16) + 1).astype(np.float32)
    losses = []
    for pkg, m, T_ in (("jax", jm, JT), ("torch", tm, TT)):
        if pkg == "jax":
            opt = JLocal(m, (T_(xs), T_(ys)), JN.CrossEntropyCriterion(), 8)
            O = JO
        else:
            opt = TO.LocalOptimizer(m, (T_(xs), T_(ys)),
                                    TN.CrossEntropyCriterion(), 8,
                                    device="cpu")
            O = TO
        opt.set_optim_method(O.SGD(learningrate=0.1))
        opt.set_end_when(O.Trigger.max_iteration(2))
        JRandom.RNG.set_seed(5)
        TRandom.RNG.set_seed(5)
        opt.optimize()
        losses.append(opt.state["loss"])
    assert abs(losses[0] - losses[1]) <= 1e-5
