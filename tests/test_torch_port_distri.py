"""The port's DistriOptimizer against the JAX package's, on the CPU.

- World 1 (gloo over an in-process store) against JAX on a 1-device
  mesh: per-step losses within 1e-5 and final weights, BN state and
  the ``zero1_flat`` velocity within 1e-5, on the f32 and the bf16
  wire.
- World 2, two processes over gloo and a ``FileStore``, against a
  2-device mesh: the same limits, with a global batch the world does
  not divide (padded and masked) and with a per-process dataset.
- The retry (``shuffle=False``): a failure injected at the first step
  of epoch 2 reloads the epoch-1 checkpoint and the run ends bit-equal
  to the uninterrupted one, and within 1e-6 of JAX's weights (the
  JAX package's own retry test's limit); a fatal error reloads nothing.
- Checkpoints of ``zero1_flat`` state load across the packages, and
  what is not ported raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import DistributedDataSet as JDist
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.dataset import DistributedDataSet as TDist
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_distri_worker as W  # noqa: E402

TOL = 1e-5
RETRY_TOL = 1e-6
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_distri_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_world():
    """Each test makes (and ends) its own world of 1."""
    Engine.reset()
    yield
    Engine.reset()


def _mesh(n):
    return JEngine.build_mesh({"data": n}, devices=jax.devices()[:n])


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


class _JBatches(JDataSet):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def size(self):
        return sum(W.SIZES)

    def data(self, train=True):
        off = 0
        for b in W.SIZES:
            yield self.x[off:off + b], self.y[off:off + b]
            off += b


def _jax_run(ds, n, wire="float32", epochs=2, clip=1.5, lr=0.2, wd=1e-3):
    JRandom.RNG.set_seed(4)
    model = W.small_model(JN)
    opt = JDistri(model, ds, JN.ClassNLLCriterion(), 8, mesh=_mesh(n),
                  wire_dtype=wire)
    opt.set_optim_method(JO.SGD(learningrate=lr, momentum=0.9,
                                weightdecay=wd))
    if clip:
        opt.set_gradient_clipping_by_l2_norm(clip)
    opt.set_end_when(JO.Trigger.max_epoch(epochs))
    losses = _Losses()
    opt.set_train_summary(losses)
    JRandom.RNG.set_seed(9)
    opt.optimize()
    return model, opt, [losses.loss[k] for k in sorted(losses.loss)]


def _port_run(ds, wire="float32", epochs=2, clip=1.5, lr=0.2, wd=1e-3):
    TRandom.RNG.set_seed(4)
    model = W.small_model(TN)
    opt = TO.DistriOptimizer(model, ds, TN.ClassNLLCriterion(), 8,
                             wire_dtype=wire, device="cpu")
    opt.set_optim_method(TO.SGD(learningrate=lr, momentum=0.9,
                                weightdecay=wd))
    if clip:
        opt.set_gradient_clipping_by_l2_norm(clip)
    opt.set_end_when(TO.Trigger.max_epoch(epochs))
    losses = _Losses()
    opt.set_train_summary(losses)
    TRandom.RNG.set_seed(9)
    opt.optimize()
    return model, opt, [losses.loss[k] for k in sorted(losses.loss)]


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:g}"


def _check_against_jax(t_params, t_state, t_vel, t_losses, jm, jo, j_losses,
                       tol):
    assert len(t_losses) == len(j_losses) > 0
    for a, b in zip(t_losses, j_losses):
        assert abs(a - b) <= tol * max(1.0, abs(b)), (t_losses, j_losses)
    for i, b in enumerate(jax.tree.leaves(jm.params())):
        _close(t_params[i], b, tol, f"param {i}")
    for i, b in enumerate(jax.tree.leaves(jm.state())):
        _close(t_state[i], b, tol, f"state {i}")
    _close(t_vel, jo.optim_method.state["velocity"], tol, "velocity")


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_world1_trajectory_matches_a_one_device_mesh(wire):
    x, y = W.data(24)
    jm, jo, jl = _jax_run(JArray(x, y, 8), 1, wire)
    tm, to, tl = _port_run(TArray(x, y, 8), wire)
    assert to.n_shards == 1 and Engine.node_number() == 1
    _check_against_jax([v.detach().numpy() for v in T.leaves(tm.params())],
                       [v.detach().numpy() for v in T.leaves(tm.state())],
                       to.optim_method.state["velocity"].numpy(), tl, jm,
                       jo, jl, TOL)
    topo = to._topology()
    assert topo["shard_layout"] == "zero1_flat" and topo["pad"] == 0
    assert topo["flat_elems"] == sum(v.numel()
                                     for v in T.leaves(tm.params()))


@pytest.mark.parametrize("case", ["array", "per_process"])
def test_world2_over_gloo_matches_a_two_device_mesh(tmp_path, case):
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", store, outs[r], case],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    x, y = W.data()
    ds = _JBatches(x, y) if case == "array" else JDist(
        x, y, 8, shuffle=True, process_id=0, num_processes=1)
    jm, jo, jl = _jax_run(ds, 2)
    assert len(jl) == 6
    for out in outs:
        with np.load(out) as r:
            n_p = len(jax.tree.leaves(jm.params()))
            n_s = len(jax.tree.leaves(jm.state()))
            _check_against_jax([r[f"p{i}"] for i in range(n_p)],
                               [r[f"s{i}"] for i in range(n_s)],
                               r["velocity"], list(r["losses"]), jm, jo, jl,
                               TOL)


def _retry_run(tmp_path, fail_at=None, error=RuntimeError):
    x, y = W.data(64)
    TRandom.RNG.set_seed(11)
    model = W.small_model(TN)
    opt = TO.DistriOptimizer(model, TArray(x, y, 16, shuffle=False),
                             TN.ClassNLLCriterion(), 16,
                             wire_dtype="float32", device="cpu")
    opt.set_optim_method(TO.SGD(learningrate=0.2, momentum=0.9))
    opt.set_end_when(TO.Trigger.max_epoch(3))
    armed = {"on": fail_at is not None}
    if fail_at is not None:
        opt.set_checkpoint(str(tmp_path), TO.Trigger.every_epoch())
        orig_put = opt._put_batch

        def poisoned_put(inp, tgt, mask):
            if armed["on"] and opt.state["neval"] == fail_at:
                armed["on"] = False
                raise error("injected executor loss")
            return orig_put(inp, tgt, mask)

        opt._put_batch = poisoned_put
    opt.optimize()
    assert not armed["on"]
    return model, opt


def test_retry_ends_bit_equal_and_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_RETRY_BACKOFF_BASE", "0")
    ref, ref_opt = _retry_run(tmp_path / "ref")
    model, opt = _retry_run(tmp_path / "ck", fail_at=5)
    assert opt.retries == 1 and opt.state["neval"] == 13
    assert ref_opt.state["neval"] == 13
    for a, b in zip(T.leaves(model.params()), T.leaves(ref.params())):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(model.state()), T.leaves(ref.state())):
        assert torch.equal(a, b)
    assert torch.equal(opt.optim_method.state["velocity"],
                       ref_opt.optim_method.state["velocity"])
    x, y = W.data(64)
    JRandom.RNG.set_seed(11)
    jm = W.small_model(JN)
    jo = JDistri(jm, JArray(x, y, 16, shuffle=False), JN.ClassNLLCriterion(),
                 16, mesh=_mesh(1), wire_dtype="float32")
    jo.set_optim_method(JO.SGD(learningrate=0.2, momentum=0.9))
    jo.set_end_when(JO.Trigger.max_epoch(3)).optimize()
    for a, b in zip(T.leaves(model.params()), jax.tree.leaves(jm.params())):
        _close(a.detach().numpy(), b, RETRY_TOL, "retried weights vs JAX")


def test_fatal_error_makes_zero_reloads(tmp_path, monkeypatch):
    calls = []
    real = TS.load_latest_checkpoint
    monkeypatch.setattr(TS, "load_latest_checkpoint",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    with pytest.raises(ValueError, match="injected"):
        _retry_run(tmp_path, fail_at=5, error=ValueError)
    assert calls == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_zero1_checkpoint_resumes_across_packages(tmp_path, writer):
    x, y = W.data(32)
    kw = dict(clip=None, wd=0.0, epochs=1)
    if writer == "jax":
        JRandom.RNG.set_seed(4)
        wm = W.small_model(JN)
        w = JDistri(wm, JArray(x, y, 8, shuffle=False),
                    JN.ClassNLLCriterion(), 8, mesh=_mesh(1),
                    wire_dtype="float32")
        w.set_optim_method(JO.SGD(learningrate=0.2, momentum=0.9))
        w.set_end_when(JO.Trigger.max_epoch(1)).set_checkpoint(
            str(tmp_path), JO.Trigger.every_epoch())
        w.optimize()
        prefix = os.path.join(str(tmp_path),
                              JS.checkpoint_prefixes(str(tmp_path))[-1])
    else:
        wm, w, _ = _port_run(TArray(x, y, 8, shuffle=False), **kw)
        w.checkpoint_path = str(tmp_path)
        w._checkpoint()
        prefix = str(tmp_path / "checkpoint_2_5")
    assert TS.read_checkpoint_topology(prefix)["shard_layout"] == \
        "zero1_flat"
    # the reader resumes from the file and trains epoch 2
    if writer == "jax":
        TRandom.RNG.set_seed(99)
        rm = W.small_model(TN)
        r = TO.DistriOptimizer(rm, TArray(x, y, 8, shuffle=False),
                               TN.ClassNLLCriterion(), 8,
                               wire_dtype="float32", device="cpu")
        r.set_optim_method(TO.SGD(learningrate=0.2, momentum=0.9))
        extra = TS.load_checkpoint(prefix, rm, r.optim_method)
        trig = TO.Trigger
    else:
        JRandom.RNG.set_seed(99)
        rm = W.small_model(JN)
        r = JDistri(rm, JArray(x, y, 8, shuffle=False),
                    JN.ClassNLLCriterion(), 8, mesh=_mesh(1),
                    wire_dtype="float32")
        r.set_optim_method(JO.SGD(learningrate=0.2, momentum=0.9))
        extra = JS.load_checkpoint(prefix, rm, r.optim_method)
        trig = JO.Trigger
    for k in ("epoch", "neval", "epoch_neval0"):
        r.state[k] = extra[k]
    assert extra["neval"] == 5
    r.set_end_when(trig.max_epoch(2)).optimize()
    w.set_end_when((JO if writer == "jax" else TO).Trigger.max_epoch(2))
    w.optimize()
    t_model, j_model = (rm, wm) if writer == "jax" else (wm, rm)
    for a, b in zip(T.leaves(t_model.params()),
                    jax.tree.leaves(j_model.params())):
        _close(a.detach().numpy(), b, TOL, "resumed weights")


def test_what_is_not_ported_raises(tmp_path):
    x, y = W.data(16)
    m = W.small_model(TN)
    ds = TArray(x, y, 8)
    for kw, msg in ((dict(wire_dtype="int8"), "int8"),
                    (dict(wire_ef=True), "error feedback"),
                    (dict(overlap_bucket_mb=4.0), "bucketed"),
                    (dict(data_axes=("dcn", "data")), "hierarchical")):
        with pytest.raises(NotImplementedError, match=msg):
            TO.DistriOptimizer(m, ds, TN.ClassNLLCriterion(), 8,
                               device="cpu", **kw)
    with pytest.raises(ValueError, match="not supported"):
        TO.DistriOptimizer(m, ds, TN.ClassNLLCriterion(), 8,
                           wire_dtype="fp16", device="cpu")
    opt = TO.DistriOptimizer(m, ds, TN.ClassNLLCriterion(), 8, device="cpu")
    opt.optim_method.load_state_arrays({"velocity": np.zeros(3),
                                        "neval": np.zeros(())})
    opt.optim_method.loaded_topology = {"world_size": 4,
                                        "shard_layout": "zero1_flat"}
    with pytest.raises(NotImplementedError, match="world-4"):
        opt.optimize()
    local = TO.Optimizer(model=m, training_set=ds,
                         criterion=TN.ClassNLLCriterion(), device="cpu")
    assert type(local) is TO.LocalOptimizer
    dist_opt = TO.Optimizer(model=m, training_set=ds,
                            criterion=TN.ClassNLLCriterion(),
                            distributed=True, device="cpu")
    assert isinstance(dist_opt, TO.DistriOptimizer)
    per_process = TO.Optimizer(model=m, training_set=TDist(x, y, 8),
                               criterion=TN.ClassNLLCriterion(),
                               device="cpu")
    assert isinstance(per_process, TO.DistriOptimizer)
    with pytest.raises(ValueError, match="world runs on cpu"):
        TO.DistriOptimizer(m, ds, TN.ClassNLLCriterion(), 8, device="cuda")
