"""NCF and the autoencoder of the port against the JAX package, on the
CPU.

- ``dataset/movielens.py``: ``latent_scores``, ``synthetic_movielens``
  and ``get_id_ratings`` (``ratings.dat`` and the zip) give the JAX
  package's arrays; a missing directory raises.
- The NCF example's data (``synthetic_interactions``,
  ``training_pairs``, the ranking candidates, the ml-1m grouping) equal
  ``examples/recommendation/ncf_train.py``'s.
- ``build_ncf`` (narrow: 30 users, 50 items) and ``build_autoencoder``
  on JAX's carried weights: the forward within 1e-5 and 3 steps
  (``Adam``, ``Adagrad``) through ``LocalOptimizer`` within 1e-5;
  HitRatio@10 and NDCG@10 of ``eval_ranking`` equal JAX's;
  ``train_autoencoder(device="cpu")`` trains the JAX package's epoch
  (1e-4, see its test);
  the example's ``main`` runs on ``--device cpu``.
"""

import importlib.util
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import movielens as JML
from bigdl_tpu.models import autoencoder as JA
from bigdl_tpu.models import ncf as JNCF
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset import movielens as TML
from bigdl_tpu_torch.examples import ncf_train as TX
from bigdl_tpu_torch.models import autoencoder as TA
from bigdl_tpu_torch.models import ncf as TNCF
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U, I = 30, 50


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_ncf_train", os.path.join(REPO, "examples", "recommendation",
                                      "ncf_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JX = _jax_example()


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:g}"


def test_movielens_arrays_match_jax(tmp_path):
    np.testing.assert_array_equal(TML.latent_scores(40, 60, 4, 3),
                                  JML.latent_scores(40, 60, 4, 3))
    t = TML.synthetic_movielens(20, 40, per_user=6, seed=2)
    np.testing.assert_array_equal(t, JML.synthetic_movielens(
        20, 40, per_user=6, seed=2))
    assert t.dtype == np.int32 and t.shape == (120, 3)
    with pytest.raises(FileNotFoundError, match="ratings.dat"):
        TML.get_id_ratings(str(tmp_path / "none"))
    rows = "1::10::5::978300760\n1::20::3::978302109\n2::10::4::978301968\n"
    (tmp_path / "a" / "ml-1m").mkdir(parents=True)
    (tmp_path / "a" / "ml-1m" / "ratings.dat").write_text(rows)
    got = TML.get_id_ratings(str(tmp_path / "a"))
    np.testing.assert_array_equal(got, JML.get_id_ratings(str(tmp_path / "a")))
    assert got.tolist() == [[1, 10, 5], [1, 20, 3], [2, 10, 4]]
    (tmp_path / "z").mkdir()
    with zipfile.ZipFile(tmp_path / "z" / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/ratings.dat", rows)
    np.testing.assert_array_equal(TML.get_id_ratings(str(tmp_path / "z")),
                                  got)


def test_example_data_matches_jax():
    pos = TX.synthetic_interactions(U, I)
    np.testing.assert_array_equal(pos, JX.synthetic_interactions(U, I))
    tx, ty = TX.training_pairs(pos, I)
    jx, jy = JX.training_pairs(pos, I)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert tx.dtype == np.float32 and tx.shape == (U * 19 * 5, 2)
    rows = JML.synthetic_movielens(U, I, per_user=25)
    for a, b in zip(TX._group_positives(rows), JX._group_positives(rows)):
        np.testing.assert_array_equal(a, b)


def _ncf_pair():
    JRandom.RNG.set_seed(5)
    jm = JNCF.build_ncf(U, I, class_num=2)
    tm = TNCF.build_ncf(U, I, class_num=2, device="cpu")
    assert [p for p, _ in T.leaves_with_paths(tm.params())] == \
        [tuple(str(k.key) for k in path) for path, _ in
         jax.tree_util.tree_leaves_with_path(jm.params())]
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    return jm, tm


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def _fixed(base, x, y, bs):
    class Fixed(base):
        def size(self):
            return len(x)

        def data(self, train=True):
            for b in range(0, len(x), bs):
                yield x[b:b + bs], y[b:b + bs]

    return Fixed()


def _three_steps(jm, tm, x, y, crit, method, bs):
    out = []
    for pkg, m in (("jax", jm), ("torch", tm)):
        N, O = (JN, JO) if pkg == "jax" else (TN, TO)
        ds = _fixed(JDataSet if pkg == "jax" else TDataSet, x, y, bs)
        opt = JLocal(m, ds, crit(N), bs) if pkg == "jax" else \
            TO.LocalOptimizer(m, ds, crit(N), bs, device="cpu")
        opt.set_optim_method(method(O))
        opt.set_end_when(O.Trigger.max_iteration(3))
        losses = _Losses()
        opt.set_train_summary(losses)
        opt.optimize()
        out.append(losses.loss)
    jl, tl = out
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    for n in tl:
        assert abs(tl[n] - jl[n]) <= TOL, (tl, jl)
    for i, (a, b) in enumerate(zip(T.leaves(tm.params()),
                                   jax.tree.leaves(jm.params()))):
        _close(a.detach().numpy(), b, f"param {i}")


def test_ncf_forward_and_adam_steps_match_jax():
    jm, tm = _ncf_pair()
    pos = TX.synthetic_interactions(U, I)
    x, y = TX.training_pairs(pos, I)
    jo, _ = jm.apply(jm.params(), jm.state(), jnp.asarray(x[:64]))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x[:64])).numpy(), jo, "forward")
    _three_steps(jm, tm, x[:96], y[:96],
                 lambda N: N.ClassNLLCriterion(),
                 lambda O: O.Adam(learningrate=1e-3), 32)


def test_eval_ranking_matches_jax():
    jm, tm = _ncf_pair()
    pos = TX.synthetic_interactions(U, I)
    got = TX.eval_ranking(tm, pos, I, device="cpu")
    want = JX.eval_ranking(jm, pos, I)
    np.testing.assert_allclose(got, want, atol=1e-6)
    x = TX.ranking_candidates(pos, I)
    assert x.shape == (U * 100, 2)
    np.testing.assert_array_equal(x[::100, 1], pos[:, 0] + 1.0)


def test_autoencoder_forward_and_adagrad_steps_match_jax():
    JRandom.RNG.set_seed(6)
    jm = JA.build_autoencoder()
    tm = TA.build_autoencoder(device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    from bigdl_tpu_torch.dataset.mnist import load_mnist

    x = (load_mnist(None, "train")[0][:384] / 255.0).astype(np.float32)
    jo, _ = jm.apply(jm.params(), jm.state(), jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), jo, "forward")
    # the published batch of 128
    _three_steps(jm, tm, x, x.reshape(len(x), -1),
                 lambda N: N.MSECriterion(),
                 lambda O: O.Adagrad(learningrate=0.01), 128)


def test_train_autoencoder_matches_jax():
    """The whole epoch (16 steps of 128): 1e-4 on the weights.  Adagrad's
    g / (|g| + 1e-10) magnifies the summation-order differences (a few
    percent) of gradient entries near 1e-9 into ~1e-5 a step; the 3-step
    test above holds 1e-5."""
    JRandom.RNG.set_seed(8)
    jm, jo = JA.train_autoencoder(max_epoch=1)
    TRandom.RNG.set_seed(8)
    tm, to = TA.train_autoencoder(max_epoch=1, device="cpu")
    assert to.state["neval"] == jo.state["neval"] == 17
    assert type(to.optim_method) is TO.Adagrad
    for i, (a, b) in enumerate(zip(T.leaves(tm.params()),
                                   jax.tree.leaves(jm.params()))):
        _close(a.detach().numpy(), b, f"param {i}", 1e-4)


def test_example_main_runs_on_the_cpu():
    hr, ndcg = TX.main(["--n-users", "20", "--n-items", "40", "-e", "1",
                        "--device", "cpu"])
    assert 0.0 <= ndcg <= hr <= 1.0
