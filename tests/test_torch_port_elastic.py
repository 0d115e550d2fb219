"""The port's elastic layer (``bigdl_tpu_torch/resilience/elastic.py``)
against the JAX package's, on the CPU.

- ``ensure_shard_layout`` bit-equal to JAX's on the same arrays: the
  same world, a resize 2 -> 1 and 1 -> 4 with bucket plans, a plan
  change, the EF residual reset (kept bit for bit when nothing
  changed).
- Checkpoints of the int8 wire with error feedback and two buckets
  (``CKPT_KW``), written at world 2 and resumed at world 1, and the
  reverse, by either package: the port's and JAX's resumes from one
  file agree within 1e-5 (weights, losses, the momentum).
- Preemption in a child process: SIGTERM at step 3, exit 170, the
  emergency checkpoint, and ``restore_latest`` in a second child ending
  bit-equal to an uninterrupted child.
- ``HeartbeatMonitor``: a silent peer raises ``PeerLostError``,
  classified fatal; ``run_main``'s exit codes and ``record_resume``'s
  counters equal to JAX's.
"""

import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as JN
from bigdl_tpu import obs as jobs
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.parallel import wire as JW
from bigdl_tpu.resilience import elastic as J
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.parallel import wire as TW
from bigdl_tpu_torch.resilience import elastic as E
from bigdl_tpu_torch.resilience.retry import PeerLostError, classify
from bigdl_tpu_torch.utils import tree as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_distri_worker as W  # noqa: E402

TOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DISTRI_WORKER = os.path.join(HERE, "torch_port_distri_worker.py")
ELASTIC_WORKER = os.path.join(HERE, "torch_port_elastic_worker.py")


@pytest.fixture(autouse=True)
def _clean():
    Engine.reset()
    tobs.reset()
    jobs.reset()
    E.clear_preemption()
    yield
    Engine.reset()
    tobs.reset()
    jobs.reset()
    E.clear_preemption()


def _mesh(n):
    return JEngine.build_mesh({"data": n}, devices=jax.devices()[:n])


# ---- ensure_shard_layout -----------------------------------------------------
ELEMS = 135


def _state(length, world, rs):
    return {"velocity": rs.randn(length).astype(np.float32),
            "m2": rs.randn(length).astype(np.float32),
            "neval": np.float32(7.0),
            "wire_ef": rs.randn(world, length).astype(np.float32)}


LAYOUTS = {
    # name: (old world, old quantum, old bucket target, new world,
    #        new quantum, new target)
    "same_world": (2, 32, 64, 2, 32, 64),
    "resize_2to1": (2, 32, 64, 1, 16, 0),
    "resize_1to4": (1, 16, 48, 4, 64, 128),
    "plan_change": (2, 32, 64, 2, 32, 96),
    "monolithic_2to1": (2, 2, 0, 1, 1, 0),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_ensure_shard_layout_bit_equal_to_jax(case):
    ow, oq, ot, nw, nq, nt = LAYOUTS[case]
    rs = np.random.RandomState(0)
    old_padded = ELEMS + (-ELEMS) % oq
    old_b = JW.plan_buckets(old_padded, oq, ot)
    topo = {"world_size": ow, "shard_layout": "zero1_flat",
            "flat_elems": ELEMS, "pad": old_padded - ELEMS}
    if len(old_b) > 1:
        topo["buckets"] = [list(b) for b in old_b]
    state = _state(old_padded, ow, rs)
    pad = (-ELEMS) % nq
    new_b = JW.plan_buckets(ELEMS + pad, nq, nt)
    j = J.ensure_shard_layout(dict(state), ELEMS, pad, nw, _mesh(nw), "data",
                              topology=topo, buckets=new_b)
    t = E.ensure_shard_layout({k: torch.from_numpy(np.array(v))
                               for k, v in state.items()}, ELEMS, pad, nw,
                              topology=topo, buckets=new_b)
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    # what a resize or plan change does to the residual
    changed = (ow, old_b) != (nw, new_b) and not (
        len(old_b) == len(new_b) == 1 and ow == nw)
    ef = t["wire_ef"].numpy()
    assert ef.shape == (nw, ELEMS + pad)
    if changed:
        assert not ef.any()
    else:
        np.testing.assert_array_equal(ef, state["wire_ef"])
    # the flat-coordinate values survive: un-permuted, re-padded
    coords = TW.bucket_param_coords(new_b, nw)
    flat = np.zeros(ELEMS + pad, np.float32)
    flat[coords] = t["velocity"].numpy()
    old_flat = np.zeros(old_padded, np.float32)
    old_flat[TW.bucket_param_coords(old_b, ow)] = state["velocity"]
    np.testing.assert_array_equal(flat[:ELEMS], old_flat[:ELEMS])
    assert not flat[ELEMS:].any() or not changed


# ---- checkpoints across worlds and packages ----------------------------------
def _workers(tmp, world, case, out, extra=None):
    store = os.path.join(tmp, "store")
    args = [case] + ([extra] if extra else [])
    procs = [subprocess.Popen(
        [sys.executable, DISTRI_WORKER, str(r), str(world), store,
         out if case == "ckpt" or r == 0 else os.path.join(tmp, "x.npz")]
        + args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def _jax_ckpt_run(world, directory=None, resume=None):
    x, y = W.data(W.CKPT_N)
    JRandom.RNG.set_seed(4)
    make = lambda m, d: JDistri(  # noqa: E731
        m, d, JN.ClassNLLCriterion(), 8, mesh=_mesh(world), **W.CKPT_KW)
    return W.ckpt_run(JN, JO, make, JArray(x, y, 8, shuffle=False),
                      directory=directory, resume=resume,
                      restore_latest=J.restore_latest)


def _port_ckpt_run(directory=None, resume=None):
    x, y = W.data(W.CKPT_N)
    TRandom.RNG.set_seed(4)
    make = lambda m, d: TO.DistriOptimizer(  # noqa: E731
        m, d, TN.ClassNLLCriterion(), 8, device="cpu", **W.CKPT_KW)
    return W.ckpt_run(TN, TO, make, TArray(x, y, 8, shuffle=False),
                      directory=directory, resume=resume)


def _jax_arrays(model, opt, losses):
    out = {f"p{i}": np.asarray(v)
           for i, v in enumerate(jax.tree.leaves(model.params()))}
    out.update({f"s{i}": np.asarray(v)
                for i, v in enumerate(jax.tree.leaves(model.state()))})
    out.update({f"opt_{k}": np.asarray(v)
                for k, v in opt.optim_method.state.items()})
    out["losses"] = np.asarray([losses.loss[n] for n in sorted(losses.loss)])
    return out


@pytest.mark.parametrize("direction", ["2to1", "1to2"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bucketed_ef_checkpoint_resumes_across_worlds(tmp_path, writer,
                                                      direction):
    old, new = (2, 1) if direction == "2to1" else (1, 2)
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    if writer == "jax":
        _jax_ckpt_run(old, directory=ck)
    elif old == 2:
        _workers(str(tmp_path), 2, "ckpt", ck)
    else:
        _port_ckpt_run(directory=ck)
        Engine.reset()
    from bigdl_tpu_torch.utils import serializer as TS

    prefix = os.path.join(ck, TS.checkpoint_prefixes(ck)[-1])
    topo = TS.read_checkpoint_topology(prefix)
    assert topo["world_size"] == old and topo["wire"]["ef"]
    assert len(topo["buckets"]) == 2
    # both packages resume the one file at the new world
    j = _jax_arrays(*_jax_ckpt_run(new, resume=ck))
    if new == 1:
        tm, to, tl = _port_ckpt_run(resume=ck)
        t = {f"p{i}": v.detach().numpy()
             for i, v in enumerate(T.leaves(tm.params()))}
        t.update({f"s{i}": v.detach().numpy()
                  for i, v in enumerate(T.leaves(tm.state()))})
        t.update({f"opt_{k}": v.numpy()
                  for k, v in to.optim_method.state.items()})
        t["losses"] = np.asarray([tl.loss[n] for n in sorted(tl.loss)])
    else:
        out = str(tmp_path / "resumed.npz")
        _workers(str(tmp_path), 2, "resume", out, extra=ck)
        t = dict(np.load(out))
    assert len(t["losses"]) == len(j["losses"]) == 4
    assert set(t) == set(j)
    for k in j:
        scale = max(1.0, float(np.abs(j[k]).max()))
        err = float(np.abs(t[k] - j[k]).max()) if j[k].size else 0.0
        assert err <= TOL * scale, f"{k}: {err:.3e}"
    # the residual of the new world started from zeros: at world 1 it
    # stays zero, at world 2 it holds the new run's errors
    assert t["opt_wire_ef"].shape[0] == new
    assert (np.abs(t["opt_wire_ef"]).max() > 0) == (new > 1)


def test_local_optimizer_refuses_a_zero1_state(tmp_path):
    x, y = W.data(16)
    opt = TO.LocalOptimizer(W.small_model(TN), TArray(x, y, 8),
                            TN.ClassNLLCriterion(), 8, device="cpu")
    opt.set_optim_method(TO.SGD(learningrate=0.1, momentum=0.9))
    opt.optim_method.load_state_arrays({"velocity": np.zeros(135),
                                        "neval": np.zeros(())})
    opt.optim_method.loaded_topology = {"world_size": 2,
                                        "shard_layout": "zero1_flat"}
    with pytest.raises(NotImplementedError, match="tree state"):
        opt.optimize()


# ---- preemption -----------------------------------------------------------------
def _child(mode, ck, out):
    return subprocess.Popen(
        [sys.executable, ELASTIC_WORKER, mode, ck, out], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_sigterm_checkpoints_exits_170_and_resumes_bit_equal(tmp_path):
    ck, ck_ref = str(tmp_path / "ck"), str(tmp_path / "ref")
    ref = _child("plain", ck_ref, str(tmp_path / "ref.npz"))
    child = _child("preempt", ck, str(tmp_path / "never.npz"))
    lines = []
    for line in child.stdout:
        lines.append(line)
        if line.startswith("STEP 3"):
            child.send_signal(signal.SIGTERM)
            break
    rest = child.communicate(timeout=120)[0]
    assert child.returncode == E.EXIT_PREEMPTED == 170, "".join(lines) + rest
    assert not os.path.exists(tmp_path / "never.npz")
    from bigdl_tpu_torch.utils import serializer as TS

    names_ = TS.checkpoint_prefixes(ck)
    assert names_, rest
    prefix = os.path.join(ck, names_[-1])
    assert TS.verify_checkpoint(prefix)[0]
    neval = TS.read_checkpoint_topology(prefix)["step"]
    assert 4 <= neval <= 5                      # mid-epoch 1 (8 steps)
    resumed = _child("resume", ck, str(tmp_path / "resumed.npz"))
    out = resumed.communicate(timeout=120)[0]
    assert resumed.returncode == 0, out
    assert f"RESUMED {neval}" in out
    ref_out = ref.communicate(timeout=120)[0]
    assert ref.returncode == 0, ref_out
    a, b = np.load(tmp_path / "resumed.npz"), np.load(tmp_path / "ref.npz")
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_preemption_flag_and_handler():
    assert not E.preemption_requested()
    E.request_preemption(15)
    assert E.preemption_requested() and E.preemption_signal() == 15
    E.clear_preemption()
    assert not E.preemption_requested()
    # Engine.init installs the handler (BIGDL_TORCH_PREEMPTION_HANDLER);
    # reset drops a pending request
    Engine.init("cpu")
    assert signal.SIGTERM in E._installed
    E.request_preemption()
    Engine.reset()
    assert not E.preemption_requested()
    exc = E.Preempted("x", step=3)
    assert isinstance(exc, SystemExit) and exc.code == 170
    assert (E.EXIT_PREEMPTED, E.EXIT_TRANSIENT, E.EXIT_FATAL) == \
        (J.EXIT_PREEMPTED, J.EXIT_TRANSIENT, J.EXIT_FATAL)


# ---- heartbeats, run_main, record_resume ---------------------------------------
def test_silent_peer_raises_peer_lost_classified_fatal(tmp_path):
    now = [1000.0]
    mon = E.HeartbeatMonitor(str(tmp_path), host=0, n_hosts=2, timeout_s=5.0,
                             clock=lambda: now[0])
    mon.beat(1, force=True)
    mon.check()                         # the peer counts from the start
    now[0] += 6.0
    with pytest.raises(PeerLostError, match="host 1 silent") as err:
        mon.check()
    assert classify(err.value) == "fatal"
    reg = tobs.get_registry()
    fams = {f.name: f for f in reg.families()}
    assert fams[names.PEER_LOST_TOTAL].child_items()[0][1].value == 1
    ages = dict(fams[names.HEARTBEAT_AGE_SECONDS].child_items())
    assert list(ages.values())[0].value >= 6.0
    from bigdl_tpu_torch.obs.server import health_payload

    assert health_payload()["heartbeat"] is not None
    # a peer that beats again is no longer silent to a new monitor
    peer = E.HeartbeatMonitor(str(tmp_path), host=1, n_hosts=2,
                              timeout_s=5.0, clock=lambda: now[0])
    peer.beat(2, force=True)
    fresh = E.HeartbeatMonitor(str(tmp_path), host=0, n_hosts=2,
                               timeout_s=1e9)
    fresh.check()


def _exit_code(mod, fn):
    try:
        return mod.run_main(fn)
    except SystemExit as e:
        return e.code


def test_run_main_and_record_resume_match_jax():
    def ok():
        return None

    def fatal():
        raise ValueError("bad config")

    def transient():
        raise RuntimeError("lost a device")

    for fn in (ok, fatal, transient):
        assert _exit_code(E, fn) == _exit_code(J, fn)
    assert _exit_code(E, lambda: (_ for _ in ()).throw(
        E.Preempted("p"))) == 170
    for old, new in ((2, 1), (1, 1), (None, 4), (1, 4), (2, 1)):
        assert E.record_resume(old, new) == J.record_resume(old, new)

    def counts(reg, name):
        for fam in reg.families():
            if fam.name == name:
                return {tuple(k): c.value for k, c in fam.child_items()}
        return {}

    assert counts(tobs.get_registry(), names.RESUMES_TOTAL) == \
        counts(jobs.get_registry(), names.RESUMES_TOTAL)
