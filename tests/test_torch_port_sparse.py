"""``bigdl_tpu/nn/sparse.py`` and Wide & Deep in the port, on the CPU.

- ``SparseTensor``'s ops (``from_dense``, ``narrow``, ``concat``, ``t``,
  ``mul``, ``add``, ``to_padded``, ``to_dense``) bit-equal to JAX's;
  ``to_torch`` (the stand-in for JAX's ``to_bcoo``) densifies to
  ``to_dense``.
- ``SparseTensorMath``'s five entry points, ``SparseLinear`` on sparse
  and dense input, ``SparseJoinTable``, and ``LookupTableSparse``'s
  padded and COO paths with every combiner, per-id weights and
  ``max_norm``: within 1e-5 of the largest |JAX value|, gradients too.
- ``pack_batch`` bit-equal to JAX's, and its refusal of ids >= 2**24.
- Wide & Deep at the example's widths: the forward on JAX's weights, 2
  SGD steps through ``LocalOptimizer`` and ``DistriOptimizer`` at world
  1 against JAX's trainers, and through ``DistriOptimizer`` at world 2
  over gloo (the distri worker's ``wide_deep`` case) against a
  two-device mesh; the example's ``main`` in both packages (loaded by
  file path).
"""

import importlib.util
import os
import subprocess
import sys

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
from bigdl_tpu.models import build_wide_and_deep as j_wide_deep
from bigdl_tpu.models import pack_batch as j_pack
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.examples import wide_and_deep_train as TX
from bigdl_tpu_torch.models import build_wide_and_deep as t_wide_deep
from bigdl_tpu_torch.models import pack_batch as t_pack
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_distri_worker as W  # noqa: E402
from torch_port_parity import (TOL, carry, check_module,  # noqa: E402
                               check_spec_and_files, rel, to_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_distri_worker.py")


@pytest.fixture(autouse=True)
def _worlds(monkeypatch):
    Engine.reset()
    monkeypatch.setattr(JEngine._state, "mesh", _mesh(1), raising=False)
    yield
    Engine.reset()


def _mesh(n):
    return JEngine.build_mesh({"data": n}, devices=jax.devices()[:n])


def _coo(seed=0, shape=(6, 9), nnz=14, dup=True):
    rs = np.random.RandomState(seed)
    idx = np.stack([rs.randint(0, shape[0], nnz),
                    rs.randint(0, shape[1], nnz)], 1)
    if dup:
        idx[1] = idx[0]                          # one duplicate entry
    vals = rs.randn(nnz).astype(np.float32)
    return idx, vals, shape


def _both(idx, vals, shape):
    return JN.SparseTensor(idx, vals, shape), TN.SparseTensor(idx, vals,
                                                              shape)


def _same(t, j):
    np.testing.assert_array_equal(t.indices, np.asarray(j.indices))
    np.testing.assert_array_equal(t.values, np.asarray(j.values))
    assert t.values.dtype == np.asarray(j.values).dtype
    assert t.shape == j.shape


# ---- SparseTensor -------------------------------------------------------------
def test_sparse_tensor_ops_bit_equal_jax():
    j, t = _both(*_coo())
    j2, t2 = _both(*_coo(1, nnz=9))
    _same(t, j)
    _same(t.narrow(1, 2, 5), j.narrow(1, 2, 5))
    _same(t.narrow(0, 1, 3), j.narrow(0, 1, 3))
    _same(TN.SparseTensor.concat(0, [t, t2]),
          JN.SparseTensor.concat(0, [j, j2]))
    _same(TN.SparseTensor.concat(1, [t, t2]),
          JN.SparseTensor.concat(1, [j, j2]))
    _same(t.t(), j.t())
    _same(t.mul(2.5), j.mul(2.5))
    _same(t.add(t2), j.add(j2))
    np.testing.assert_array_equal(to_np(t.to_dense()),
                                  np.asarray(j.to_dense()))
    np.testing.assert_array_equal(to_np(t.to_torch().to_dense()),
                                  to_np(t.to_dense()))
    dense = np.asarray(j.to_dense())
    _same(TN.SparseTensor.from_dense(dense), JN.SparseTensor.from_dense(dense))
    assert t.nnz == j.nnz and t.ndim == j.ndim == 2
    # 64-bit arrays are held as JAX holds them
    j64, t64 = _both(np.asarray([[0, 1]], np.int64),
                     np.asarray([1.5], np.float64), (2, 2))
    _same(t64, j64)


def test_to_padded_matches_jax_and_refuses_overflow():
    idx = np.array([[0, 3], [0, 7], [2, 1], [1, 0], [2, 5]])
    vals = np.array([1.0, 0.5, 2.0, 3.0, 1.5], np.float32)
    j, t = _both(idx, vals, (3, 8))
    for a, b in zip(t.to_padded(3), j.to_padded(3)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="more than 1"):
        t.to_padded(1)


def test_pack_batch_matches_jax_and_refuses_ids_past_2_24():
    sp, deep, _ = TX.synthetic_tabular(n=64)
    jsp = JN.SparseTensor(sp.indices, sp.values, sp.shape)
    got, want = t_pack(sp, deep, 8), j_pack(jsp, deep, 8)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    big = deep.copy()
    big[0, 0] = 1 << 24
    with pytest.raises(ValueError, match="2\\*\\*24"):
        t_pack(sp, big, 8)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        j_pack(jsp, big, 8)
    wide = TN.SparseTensor([[0, (1 << 24) - 1]], [1.0], (1, 1 << 24))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        t_pack(wide, np.ones((1, 1)), 2)


# ---- SparseTensorMath and the layers ------------------------------------------
def test_sparse_tensor_math_matches_jax():
    j, t = _both(*_coo(2))
    rs = np.random.RandomState(3)
    dense = rs.randn(9, 4).astype(np.float32)
    vec = rs.randn(9).astype(np.float32)
    mat = rs.randn(6, 4).astype(np.float32)
    vout = rs.randn(6).astype(np.float32)
    full = rs.randn(6, 9).astype(np.float32)
    M, JM = TN.SparseTensorMath, JN.SparseTensorMath
    tt = torch.from_numpy
    for got, want in [
            (M.mm(t, tt(dense)), JM.mm(j, jnp.asarray(dense))),
            (M.addmm(0.5, tt(mat), 2.0, t, tt(dense)),
             JM.addmm(0.5, jnp.asarray(mat), 2.0, j, jnp.asarray(dense))),
            (M.mv(t, tt(vec)), JM.mv(j, jnp.asarray(vec))),
            (M.addmv(0.3, tt(vout), 1.5, t, tt(vec)),
             JM.addmv(0.3, jnp.asarray(vout), 1.5, j, jnp.asarray(vec))),
            (M.vdot(t, tt(full)), JM.vdot(j, jnp.asarray(full)))]:
        assert rel(got, want) <= TOL


def _pair(name, *args, seed=5, **kw):
    JRandom.RNG.set_seed(seed)
    jm = getattr(JN, name)(*args, **kw)
    TRandom.RNG.set_seed(seed)
    tm = getattr(TN, name)(*args, **kw)
    np.testing.assert_array_equal(to_np(tm.weight), np.asarray(jm.weight))
    return jm, tm


@pytest.mark.parametrize("bias", [True, False])
def test_sparse_linear_on_sparse_and_dense_input(bias):
    jm, tm = _pair("SparseLinear", 9, 4, bias)
    j, t = _both(*_coo(4))
    rs = np.random.RandomState(6)
    cot = rs.randn(6, 4).astype(np.float32)

    def jf(p):
        return jm.update_output_pure(p, j)

    want, vjp = jax.vjp(jf, jm.params())
    got = tm(t)
    assert rel(got, want) <= TOL
    (gp,) = vjp(jnp.asarray(cot))
    (got * torch.from_numpy(cot)).sum().backward()
    for (name, p), b in zip(T.leaves_with_paths(tm.params()),
                            jax.tree.leaves(gp)):
        assert rel(p.grad, b) <= TOL, name
    tm.zero_grad(set_to_none=True)
    carry(jm, tm)
    check_module(jm, tm, np.asarray(j.to_dense()))


def test_sparse_join_table_matches_jax():
    for dim, shapes in ((1, [(4, 5)] * 3), (2, [(4, 3), (4, 4), (4, 5)])):
        parts = [_coo(s, shape=shp, nnz=5) for s, shp in enumerate(shapes)]
        js = [JN.SparseTensor(*p) for p in parts]
        ts = [TN.SparseTensor(*p) for p in parts]
        _same(TN.SparseJoinTable(dim)(ts),
              JN.SparseJoinTable(dim).update_output_pure({}, js))


def _padded(seed=7, b=5, s=4, vocab=10):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab + 1, (b, s)).astype(np.float32)
    ids[0] = 0.0                                 # an all-padding row
    ids[1, 0] = 1.0
    wts = rs.uniform(0.5, 1.5, (b, s)).astype(np.float32)
    return ids, wts


@pytest.mark.parametrize("max_norm", [-1.0, 0.8])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_table_sparse_padded_path(combiner, weighted, max_norm):
    jm, tm = _pair("LookupTableSparse", 10, 3, combiner, max_norm)
    ids, wts = _padded()
    # id 0 is padding, not the last row (unlike LookupTable)
    if weighted:
        check_module(jm, tm, (ids, wts))
    else:
        check_module(jm, tm, ids)


@pytest.mark.parametrize("max_norm", [-1.0, 0.8])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_table_sparse_coo_path(combiner, weighted, max_norm):
    jm, tm = _pair("LookupTableSparse", 10, 3, combiner, max_norm)
    rs = np.random.RandomState(8)
    rows = np.array([0, 0, 1, 2, 2, 2, 4])
    idx = np.stack([rows, np.arange(len(rows)) % 3], 1)
    ids = (rs.randint(0, 10, len(rows)) + 1).astype(np.float32)
    w = rs.uniform(0.5, 1.5, len(rows)).astype(np.float32)
    jids, tids = _both(idx, ids, (5, 3))
    jw = JN.SparseTensor(idx, w, (5, 3)) if weighted else None
    tw = TN.SparseTensor(idx, w, (5, 3)) if weighted else None
    cot = rs.randn(5, 3).astype(np.float32)

    def jf(p):
        return jm.update_output_pure(p, (jids, jw))

    want, vjp = jax.vjp(jf, jm.params())
    got = tm((tids, tw))
    assert rel(got, want) <= TOL
    (gp,) = vjp(jnp.asarray(cot))
    (got * torch.from_numpy(cot)).sum().backward()
    assert rel(tm.weight.grad, gp["weight"]) <= TOL


def test_sparse_specs_and_files_cross_the_packages(tmp_path):
    for name, args in (("SparseLinear", (9, 4)),
                       ("LookupTableSparse", (10, 3, "mean")),
                       ("SparseJoinTable", (1,))):
        JRandom.RNG.set_seed(2)
        jm = getattr(JN, name)(*args)
        TRandom.RNG.set_seed(2)
        tm = getattr(TN, name)(*args)
        d = tmp_path / name
        d.mkdir()
        check_spec_and_files(jm, tm, str(d))


# ---- Wide & Deep ----------------------------------------------------------------
def test_wide_and_deep_forward_matches_jax():
    JRandom.RNG.set_seed(21)
    jm = j_wide_deep(200, (12, 20, 8), class_num=2, wide_slots=8)
    TRandom.RNG.set_seed(21)
    tm = t_wide_deep(200, (12, 20, 8), class_num=2, wide_slots=8)
    # seeded from one seed, both draw the same weights
    for a, b in zip(T.leaves(tm.params()), jax.tree.leaves(jm.params())):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    x, _ = W.wide_deep_data()
    check_module(jm.evaluate(), tm.evaluate(), x, jit=True)


def _jax_wide_deep(trainer, mesh=None):
    JRandom.RNG.set_seed(21)
    model = j_wide_deep(200, (12, 20, 8), class_num=2, wide_slots=8)
    ds = W.wide_deep_batches(JDataSet)
    if trainer == "distri":
        opt = JDistri(model, ds, JN.ClassNLLCriterion(), W.WD_BATCH,
                      mesh=mesh or _mesh(1), wire_dtype="float32")
    else:
        opt = JLocal(model, ds, JN.ClassNLLCriterion(), W.WD_BATCH)
    opt.set_optim_method(JO.SGD(learningrate=1.0))
    opt.set_end_when(JO.Trigger.max_iteration(W.WD_STEPS))
    losses = W.Losses()
    opt.set_train_summary(losses)
    opt.optimize()
    return ([losses.loss[k] for k in sorted(losses.loss)],
            jax.tree.leaves(model.params()))


def _check_run(got, want_losses, want_params):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL)
    assert len(want_params) == len([k for k in got if k.startswith("p")])
    for i, b in enumerate(want_params):
        assert rel(got[f"p{i}"], b) <= TOL, i


@pytest.mark.parametrize("trainer", ["local", "distri"])
def test_wide_and_deep_steps_match_jax_at_world1(trainer):
    jl, jp = _jax_wide_deep(trainer)
    got = W.wide_deep_run(trainer)
    assert len(got["losses"]) == W.WD_STEPS
    _check_run(got, jl, jp)


def test_wide_and_deep_world2_over_gloo_matches_a_two_device_mesh(tmp_path):
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", store, outs[r], "wide_deep"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    jl, jp = _jax_wide_deep("distri", mesh=_mesh(2))
    for out in outs:
        with np.load(out) as r:
            _check_run(dict(r), jl, jp)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_wide_and_deep_train",
        os.path.join(REPO, "examples", "recommendation",
                     "wide_and_deep_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_data_and_main_match_jax():
    JX = _jax_example()
    jsp, jdeep, jy = JX.synthetic_tabular(n=300)
    tsp, tdeep, ty = TX.synthetic_tabular(n=300)
    _same(tsp, jsp)
    np.testing.assert_array_equal(tdeep, jdeep)
    np.testing.assert_array_equal(ty, jy)
    argv = ["-e", "1", "-b", "512"]
    JRandom.RNG.set_seed(3)
    want = JX.main(argv)
    TRandom.RNG.set_seed(3)
    got = TX.main(argv + ["--device", "cpu"])
    assert abs(got - want) <= 1e-6, (got, want)
