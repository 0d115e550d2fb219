"""The port's optim methods and schedules against the JAX package's, on
the CPU.

Every method of ``tests/torch_port_methods_worker.py``'s ``CASES``
(Adam, Adagrad, Adadelta, Adamax, RMSprop, Ftrl, LBFGS, LarsSGD, and
SGD under Step, Exponential and EpochDecay) is held to the JAX
package within 1e-5 (absolute, on values of order 1):

- four bare ``step`` calls on a two-tensor parameter list;
- 2 epochs of 3 steps of a small MLP through ``LocalOptimizer``, through
  ``DistriOptimizer`` at world 1 against a 1-device mesh, and at
  world 2 (two processes over gloo) against a 2-device mesh: losses,
  final parameters and the optimizer state under its npz keys.
  LBFGS refuses world 2 in the port, and the JAX package's LBFGS on
  a 2-device mesh is pinned as wrong (``ROADMAP.md`` queue 3).

Also the schedules' rates, ``OptimMethod.save``/``load`` and training
checkpoints (tree and ``zero1_flat`` layouts) crossing the packages in
both directions, LBFGS's history cap, and the Adamax ε hazard: XLA
flushes the subnormal 1e-38 and gives NaN where a gradient is exactly
0, torch keeps it and gives a zero update.
"""

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
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_methods_worker as W  # noqa: E402

TOL = 1e-5
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_methods_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = [c for c in W.CASES]
# the methods whose hyperparameters are plain values (a schedule object
# pickles as its own package's class, so it cannot cross)
PLAIN = [c for c in W.CASES if not c.startswith("sgd_")]


@pytest.fixture(autouse=True)
def _port_world():
    Engine.reset()
    yield
    Engine.reset()


def _close(got, want, what, tol=TOL):
    """|got − want| ≤ tol · max(1, |want|) elementwise (LBFGS's ``rho``,
    1/sᵀy, runs into the thousands)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))) \
        if got.size else 0.0
    assert err <= tol, f"{what}: max scaled err {err:.3e} > {tol:g}"


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


# ------------------------------------------------------------ bare steps


@pytest.mark.parametrize("case", METHODS)
def test_steps_match_jax(case):
    rs = np.random.RandomState(1)
    params = [rs.randn(3, 4).astype(np.float32),
              rs.randn(5).astype(np.float32)]
    jm, tm = W.CASES[case](JO), W.CASES[case](TO)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jst, tst = jm.init_state(jp), tm.init_state(tp)
    for _ in range(4):
        # a quadratic's gradient plus noise, with no exact zero
        noise = [0.1 * rs.randn(*p.shape).astype(np.float32) + 0.05
                 for p in params]
        jg = [0.5 * a + jnp.asarray(n) for a, n in zip(jp, noise)]
        tg = [0.5 * a + torch.from_numpy(n) for a, n in zip(tp, noise)]
        jp, jst = jm.step(jg, jp, jst)
        tp, tst = tm.step(tg, tp, tst)
        for i, (a, b) in enumerate(zip(tp, jp)):
            _close(_np(a), b, f"{case} param {i}")
    assert set(tst) == set(jst)
    for k in tst:
        if isinstance(tst[k], list):
            for i, (a, b) in enumerate(zip(tst[k], jst[k])):
                _close(_np(a), b, f"{case} state {k}/{i}")
        else:
            _close(_np(tst[k]), jst[k], f"{case} state {k}")
            assert tst[k].dtype == torch.float32, k


@pytest.mark.parametrize("name", ["step", "exponential", "stair",
                                  "epochdecay"])
def test_schedule_rates_match_jax(name):
    make = {"step": lambda M: M.Step(3, 0.5),
            "exponential": lambda M: M.Exponential(4, 0.7),
            "stair": lambda M: M.Exponential(4, 0.7, stair_case=True),
            "epochdecay": lambda M: M.EpochDecay(W.decay)}[name]
    js, ts = make(JO), make(TO)
    for n in range(0, 12):
        for e in (0, 1, 2, 7, 998, 999, 1500):
            jst = {"neval": jnp.float32(n), "epoch": jnp.float32(e)}
            tst = {"neval": torch.tensor(float(n)),
                   "epoch": torch.tensor(float(e))}
            got, want = ts.rate(0.3, tst), js.rate(0.3, jst)
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, err_msg=f"{n} {e}")


# ------------------------------------------------------------- trainers


class _Losses(W.Losses):
    def get_summary_trigger(self, name):
        return None


class _JBatches(JDataSet):
    """The worker's fixed batches for the JAX trainer."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def size(self):
        return sum(W.SIZES)

    def data(self, train=True):
        return W.Batches.data(self, train)


def _mesh(n):
    return JEngine.build_mesh({"data": n}, devices=jax.devices()[:n])


def _trainer(pkg, layout, case, n=1):
    """(model, optimizer, losses): the MLP and ``case``'s method in a
    ``LocalOptimizer`` (``layout="tree"``) or a ``DistriOptimizer``
    (``"zero1_flat"``, at world ``n`` for JAX) of package ``pkg``, not
    yet run."""
    x, y = W.data()
    N, O, R = (JN, JO, JRandom) if pkg == "jax" else (TN, TO, TRandom)
    R.RNG.set_seed(4)
    model = W.mlp(N)
    R.RNG.set_seed(9)
    if layout == "tree":
        opt = JLocal(model, _JBatches(x, y), JN.ClassNLLCriterion(),
                     batch_size=8) if pkg == "jax" else TO.LocalOptimizer(
                model, W.Batches(x, y), TN.ClassNLLCriterion(),
                batch_size=8, device="cpu")
    elif pkg == "jax":
        opt = JDistri(model, _JBatches(x, y), JN.ClassNLLCriterion(), 8,
                      mesh=_mesh(n), wire_dtype="float32")
    else:
        opt = TO.DistriOptimizer(model, W.Batches(x, y),
                                 TN.ClassNLLCriterion(), 8,
                                 wire_dtype="float32", device="cpu")
    opt.set_optim_method(W.CASES[case](O))
    opt.set_end_when(O.Trigger.max_epoch(2))
    losses = _Losses()
    opt.set_train_summary(losses)
    return model, opt, losses


def _run(pkg, layout, case, n=1):
    model, opt, losses = _trainer(pkg, layout, case, n)
    opt.optimize()
    return model, opt, losses


def _check(t_state, t_losses, j_model, j_opt, j_losses, what):
    assert sorted(t_losses) == sorted(j_losses) and len(t_losses) == 6
    for n in t_losses:
        assert abs(t_losses[n] - j_losses[n]) <= TOL, (what, n, t_losses,
                                                       j_losses)
    for i, (a, b) in enumerate(zip(t_state["params"],
                                   jax.tree.leaves(j_model.params()))):
        _close(a, b, f"{what} param {i}")
    j_arrays = j_opt.optim_method.get_state_arrays()
    assert set(t_state["opt"]) == set(j_arrays), what
    for k, v in j_arrays.items():
        _close(t_state["opt"][k], v, f"{what} state {k}")


def _port_arrays(model, opt):
    return {"params": [_np(v) for v in T.leaves(model.params())],
            "opt": opt.optim_method.get_state_arrays()}


@pytest.mark.parametrize("layout", ["tree", "zero1_flat"])
@pytest.mark.parametrize("case", METHODS)
def test_trainers_match_jax(case, layout):
    """``LocalOptimizer`` (tree), and ``DistriOptimizer`` at world 1
    against a 1-device mesh (``zero1_flat``)."""
    jm, jo, jl = _run("jax", layout, case)
    tm, to, tl = _run("torch", layout, case)
    _check(_port_arrays(tm, to), tl.loss, jm, jo, jl.loss, case)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both ranks' results of the worker, every case in one run."""
    tmp = tmp_path_factory.mktemp("methods_world2")
    store = str(tmp / "store")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", store, str(tmp)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return tmp


@pytest.mark.parametrize("case", [c for c in METHODS if c != "lbfgs"])
def test_distri_world2_matches_a_two_device_mesh(world2, case):
    jm, jo, jl = _run("jax", "zero1_flat", case, n=2)
    for rank in range(2):
        with np.load(str(world2 / f"{case}.rank{rank}.npz")) as r:
            n_p = len(jax.tree.leaves(jm.params()))
            state = {"params": [r[f"p{i}"] for i in range(n_p)],
                     "opt": {k[4:]: r[k] for k in r.files
                             if k.startswith("opt/")}}
            losses = dict(enumerate(r["losses"].tolist(), start=1))
        _check(state, losses, jm, jo, jl.loss, f"{case} rank {rank}")


def test_lbfgs_world2_refused_and_jax_mesh_pinned_wrong(world2):
    """The port refuses LBFGS at world 2 (the worker checks the error);
    the JAX package's LBFGS runs on a 2-device mesh but leaves the
    world-1 trajectory (the exact one: one flat vector) by far more
    than the reduction order explains, as SGD shows it does not."""
    assert not list(world2.glob("lbfgs.rank*.npz"))

    def gap(case):
        a, _, _ = _run("jax", "zero1_flat", case, n=1)
        b, _, _ = _run("jax", "zero1_flat", case, n=2)
        return max(float(np.max(np.abs(np.asarray(u) - np.asarray(v))))
                   for u, v in zip(jax.tree.leaves(a.params()),
                                   jax.tree.leaves(b.params())))

    assert gap("sgd_step") <= TOL
    assert gap("lbfgs") > 1e-4


# ---------------------------------------------------------- state files


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", PLAIN)
def test_optim_method_files_cross_packages(tmp_path, case, writer):
    rs = np.random.RandomState(2)
    params = [rs.randn(3, 4).astype(np.float32),
              rs.randn(5).astype(np.float32)]
    if writer == "jax":
        m = W.CASES[case](JO)
        jp = {"0": {"weight": jnp.asarray(params[0]),
                    "bias": jnp.asarray(params[1])}}
        st = m.init_state(jp)
        for _ in range(2):
            jp, st = m.step(jax.tree.map(lambda a: 0.5 * a + 0.1, jp), jp,
                            st)
        m.state = st
    else:
        m = W.CASES[case](TO)
        tp = [torch.from_numpy(params[1]), torch.from_numpy(params[0])]
        m.param_tree = {"0": {"bias": 0, "weight": 1}}
        st = m.init_state(tp)
        for _ in range(2):
            tp, st = m.step([0.5 * a + 0.1 for a in tp], tp, st)
        m.state = st
    path = str(tmp_path / case)
    m.save(path)
    back = (TO if writer == "jax" else JO).OptimMethod.load(path)
    assert type(back).__name__ == type(m).__name__
    for k in ("learningrate", "learningrate_decay"):
        assert getattr(back, k) == getattr(m, k)
    want = JO.OptimMethod.get_state_arrays(m) if writer == "jax" \
        else m.get_state_arrays()
    if writer == "jax":
        back.param_tree = {"0": {"bias": 0, "weight": 1}}
        back.state = {k: ([v["0"]["bias"], v["0"]["weight"]]
                          if isinstance(v, dict) else v)
                      for k, v in back.state.items()}
    got = back.get_state_arrays()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case,layout", [("adam", "tree"),
                                         ("adam", "zero1_flat"),
                                         ("lbfgs", "zero1_flat")])
def test_checkpoints_resume_across_packages(tmp_path, case, layout,
                                            writer):
    """The writer trains epoch 1 and checkpoints; the other package
    loads the checkpoint and trains epoch 2; it ends where the writer's
    own epoch 2 ends.  (LBFGS's tree-layout keys cross in
    ``test_optim_method_files_cross_packages``.)"""
    ck = str(tmp_path)
    reader = "torch" if writer == "jax" else "jax"
    wm, wo, _ = _trainer(writer, layout, case)
    Wt = JO.Trigger if writer == "jax" else TO.Trigger
    wo.set_end_when(Wt.max_epoch(1)).set_checkpoint(ck, Wt.every_epoch())
    wo.optimize()
    S = JS if writer == "jax" else TS
    prefix = os.path.join(ck, S.checkpoint_prefixes(ck)[-1])
    assert TS.read_checkpoint_topology(prefix)["shard_layout"] == layout
    rm, ro, _ = _trainer(reader, layout, case)
    extra = (TS if reader == "torch" else JS).load_checkpoint(
        prefix, rm, ro.optim_method)
    for k in ("epoch", "neval", "epoch_neval0"):
        ro.state[k] = extra[k]
    assert extra["neval"] == 4
    ro.optimize()
    wo.set_end_when(Wt.max_epoch(2)).optimize()
    t_model, j_model = (rm, wm) if reader == "torch" else (wm, rm)
    for a, b in zip(T.leaves(t_model.params()),
                    jax.tree.leaves(j_model.params())):
        _close(_np(a), b, f"{case} {layout} resumed weights")


# ------------------------------------------------------- method details


def test_lbfgs_caps_its_history_with_a_warning():
    with pytest.warns(UserWarning, match="capped at 16"):
        m = TO.LBFGS(ncorrection=100)
    assert m.ncorrection == 16
    st = m.init_state([torch.zeros(3, 2)])
    assert st["s_hist"][0].shape == (16, 3, 2)
    assert st["rho"].shape == (16,) and st["hist_len"].dim() == 0
    assert TO.LBFGS().per_param_keys() == {"s_hist", "y_hist",
                                           "prev_param", "prev_grad"}


def test_adamax_subnormal_epsilon_pinned():
    """JAX's XLA flushes ε = 1e-38 to 0, so a gradient of exactly 0
    gives 0/0 = NaN there; torch keeps the subnormal and the entry does
    not move.  Where no gradient is 0 the two agree (the parity tests
    above)."""
    p = np.array([1.0, -2.0, 3.0], np.float32)
    g = np.array([0.5, 0.0, -0.25], np.float32)
    jm, tm = JO.Adamax(), TO.Adamax()
    step = jax.jit(jm.step)
    jp, _ = step([jnp.asarray(g)], [jnp.asarray(p)],
                 jm.init_state([jnp.asarray(p)]))
    tp, _ = tm.step([torch.from_numpy(g)], [torch.from_numpy(p)],
                    tm.init_state([torch.from_numpy(p)]))
    jp, tp = np.asarray(jp[0]), tp[0].numpy()
    assert np.isnan(jp[1]) and np.isfinite(tp).all()
    assert tp[1] == p[1]
    np.testing.assert_allclose(tp[[0, 2]], jp[[0, 2]], atol=1e-7)
