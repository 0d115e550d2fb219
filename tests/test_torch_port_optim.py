"""The port's training path against the JAX package, on the CPU.

``SGD`` steps and the learning-rate schedules against
``bigdl_tpu/optim/optim_method.py`` (f32 elementwise math in the same
order: atol 1e-6, rtol 1e-6); a ``LocalOptimizer`` run of 3 steps over a
fused ``build_resnet_cifar(20)`` (batch 4, 32x32, f32) against the JAX
``LocalOptimizer`` from the same seeds and the same shuffle order: the
loss of each step within 1e-5, the final params and BN state within
2e-5 (3 momentum steps of f32 sums taken in other orders); and the
port's own contracts: the bf16 policy keeps master params and
gradients f32, and the non-finite guard skips a poisoned step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models import resnet as JR
from bigdl_tpu.nn import fused as JF
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import to_dataset
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.nn import fused as TF


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach().numpy() if isinstance(v, torch.Tensor) else v)
    return out


# ------------------------------------------------------------------- SGD


@pytest.mark.parametrize("kw", [
    dict(learningrate=0.1),
    dict(learningrate=0.1, momentum=0.9),
    dict(learningrate=0.05, momentum=0.9, dampening=0.0, nesterov=True),
    dict(learningrate=0.1, momentum=0.5, dampening=0.2, weightdecay=1e-2),
    dict(learningrate=0.2, learningrate_decay=0.3, weightdecay=1e-3),
], ids=["plain", "momentum", "nesterov", "damp_wd", "lr_decay"])
def test_sgd_steps_match_jax(kw):
    rs = np.random.RandomState(0)
    params = [rs.randn(3, 4).astype(np.float32),
              rs.randn(5).astype(np.float32)]
    jm, tm = JO.SGD(**kw), TO.SGD(**kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jst, tst = jm.init_state(jp), tm.init_state(tp)
    for _ in range(4):
        grads = [rs.randn(*p.shape).astype(np.float32) for p in params]
        jp, jst = jm.step([jnp.asarray(g) for g in grads], jp, jst)
        tp, tst = tm.step([torch.from_numpy(g) for g in grads], tp, tst)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
    assert float(tst["neval"]) == float(jst["neval"]) == 4.0


def _schedules(M):
    seq = M.SequentialSchedule(4).add(M.Warmup(0.02), 3) \
        .add(M.MultiStep([2, 5], 0.1), 20)
    return {"multistep": M.MultiStep([2, 5, 9], 0.5),
            "warmup": M.Warmup(0.01),
            "sequential": seq}


@pytest.mark.parametrize("name", ["multistep", "warmup", "sequential"])
def test_schedule_rates_match_jax(name):
    jm = JO.SGD(learningrate=0.1,
                learningrate_schedule=_schedules(JO)[name])
    tm = TO.SGD(learningrate=0.1,
                learningrate_schedule=_schedules(TO)[name])
    jst = jm.init_state([jnp.zeros(2)])
    tst = tm.init_state([torch.zeros(2)])
    for n in range(14):
        jst["neval"] = jnp.asarray(float(n), jnp.float32)
        tst["neval"] = torch.tensor(float(n))
        np.testing.assert_allclose(float(tm.current_rate(tst)),
                                   float(jm.current_rate(jst)), rtol=1e-6,
                                   atol=1e-7, err_msg=f"neval {n}")


def test_imagenet_recipe_rates_match_jax():
    kw = dict(n_epochs=4, iterations_per_epoch=3, warmup_epochs=1)
    jm = JR.imagenet_recipe_optim(512, **kw)
    tm = TR.imagenet_recipe_optim(512, **kw)
    assert (tm.momentum, tm.nesterov, tm.weightdecay) == (0.9, True, 1e-4)
    jst = jm.init_state([jnp.zeros(2)])
    tst = tm.init_state([torch.zeros(2)])
    for n in range(14):
        jst["neval"] = jnp.asarray(float(n), jnp.float32)
        tst["neval"] = torch.tensor(float(n))
        np.testing.assert_allclose(float(tm.current_rate(tst)),
                                   float(jm.current_rate(jst)), rtol=1e-6)


# ------------------------------------------------------- LocalOptimizer


class _Summary:
    """Collects the per-step "Loss" scalars (the train-summary hook)."""

    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def test_local_optimizer_trajectory_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.rand(8, 3, 32, 32).astype(np.float32)
    y = (rs.randint(0, 10, 8) + 1).astype(np.float32)

    JRandom.RNG.set_seed(7)
    jm = JF.fuse_conv_bn(JR.build_resnet_cifar(20, 10))
    jsum = _Summary()
    jopt = JLocal(jm, (x, y), JN.ClassNLLCriterion(), batch_size=4)
    jopt.set_optim_method(JO.SGD(learningrate=0.1, momentum=0.9))
    jopt.set_end_when(JO.Trigger.max_iteration(3))
    jopt.set_train_summary(jsum)
    jopt.optimize()

    TRandom.RNG.set_seed(7)
    tm = TF.fuse_conv_bn(TR.build_resnet_cifar(20, 10, device="cpu"))
    tsum = _Summary()
    topt = TO.LocalOptimizer(tm, (x, y), TN.ClassNLLCriterion(),
                             batch_size=4, device="cpu")
    topt.set_optim_method(TO.SGD(learningrate=0.1, momentum=0.9))
    topt.set_end_when(TO.Trigger.max_iteration(3))
    topt.set_train_summary(tsum)
    topt.optimize()

    assert sorted(tsum.loss) == sorted(jsum.loss) == [1, 2, 3]
    for n in (1, 2, 3):
        np.testing.assert_allclose(tsum.loss[n], jsum.loss[n], atol=1e-5,
                                   err_msg=f"step {n}")
    assert topt.state["neval"] == jopt.state["neval"] == 4
    assert topt.state["epoch"] == jopt.state["epoch"] == 2
    assert not tm.training
    jp, tp = _flat(jax.tree.map(np.asarray, jm.params())), _flat(tm.params())
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-5, err_msg=k)
    js, ts = _flat(jax.tree.map(np.asarray, jm.state())), _flat(tm.state())
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=2e-5, err_msg=k)


def _tiny(seed=0):
    TRandom.RNG.set_seed(seed)
    return TN.Sequential() \
        .add(TN.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, with_bias=False)) \
        .add(TN.SpatialBatchNormalization(4)).add(TN.ReLU()) \
        .add(TN.SpatialAveragePooling(4, 4, global_pooling=True)) \
        .add(TN.Reshape([4])).add(TN.Linear(4, 3))


def _data(n=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3, 4, 4).astype(np.float32),
            (rs.randint(0, 3, n) + 1).astype(np.float32))


class _RecordingSGD(TO.SGD):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.grad_dtypes = []

    def step(self, grads, params, state):
        self.grad_dtypes.append({g.dtype for g in grads})
        return super().step(grads, params, state)


def test_bf16_policy_keeps_master_params_and_grads_f32():
    model = _tiny()
    seen = {}

    def hook(mod, inp, out):
        seen[type(mod).__name__] = (inp[0].dtype, mod.weight.dtype, out.dtype)

    for m in model.modules[:2]:
        m.register_forward_hook(hook)
    sgd = _RecordingSGD(learningrate=0.1, momentum=0.9)
    opt = TO.LocalOptimizer(model, _data(), TN.CrossEntropyCriterion(),
                            batch_size=4, device="cpu")
    opt.set_optim_method(sgd).set_compute_dtype("bfloat16")
    opt.set_end_when(TO.Trigger.max_iteration(2))
    opt.optimize()
    bf = torch.bfloat16
    # the conv and BN (γ/β included) ran in bf16 ...
    assert seen["SpatialConvolution"] == (bf, bf, bf)
    assert seen["SpatialBatchNormalization"] == (bf, bf, bf)
    # ... on f32 master params, with f32 gradients, state and stats
    assert sgd.grad_dtypes == [{torch.float32}] * 2
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert all(v.dtype == torch.float32 for v in sgd.state["velocity"])
    assert np.isfinite(opt.state["loss"])


def test_nonfinite_guard_skips_a_nan_step():
    model = _tiny(seed=1)
    x, y = _data(4)
    x[0, 0, 0, 0] = np.nan
    before_p = {k: v.clone() for k, v in _flat_t(model.params()).items()}
    before_s = {k: v.clone() for k, v in _flat_t(model.state()).items()}
    sgd = TO.SGD(learningrate=0.1, momentum=0.9)
    opt = TO.LocalOptimizer(model, (x, y), TN.CrossEntropyCriterion(),
                            batch_size=4, device="cpu")
    opt.set_optim_method(sgd).set_end_when(TO.Trigger.max_iteration(1))
    opt.optimize()
    assert opt.state["nonfinite_skips"] == 1 and opt.state["neval"] == 2
    assert not np.isfinite(opt.state["loss"])
    for k, v in _flat_t(model.params()).items():
        assert torch.equal(v, before_p[k]), k
    for k, v in _flat_t(model.state()).items():
        assert torch.equal(v, before_s[k]), k
    assert float(sgd.state["neval"]) == 0.0
    assert all(float(v.abs().sum()) == 0.0 for v in sgd.state["velocity"])
    # a clean batch then trains
    opt.dataset = to_dataset(_data(4, seed=2), 4)
    opt.set_end_when(TO.Trigger.max_iteration(2)).optimize()
    assert opt.state["nonfinite_skips"] == 1
    assert float(sgd.state["neval"]) == 1.0
    assert not torch.equal(model.modules[-1].weight,
                           before_p["5.weight"])


def _flat_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_t(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v.detach()
    return out


def test_consecutive_nonfinite_steps_raise(monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_MAX_NONFINITE_SKIPS", "2")
    x, y = _data(12)
    x[:] = np.nan
    opt = TO.LocalOptimizer(_tiny(), (x, y), TN.CrossEntropyCriterion(),
                            batch_size=4, device="cpu")
    opt.set_end_when(TO.Trigger.max_iteration(3))
    with pytest.raises(TO.NonFiniteStepError, match="2 consecutive"):
        opt.optimize()


def test_guard_off_trains_on_nan(monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_NONFINITE_GUARD", "0")
    model = _tiny()
    x, y = _data(4)
    x[0, 0, 0, 0] = np.nan
    opt = TO.LocalOptimizer(model, (x, y), TN.CrossEntropyCriterion(),
                            batch_size=4, device="cpu")
    opt.set_end_when(TO.Trigger.max_iteration(1)).optimize()
    assert opt.state["nonfinite_skips"] == 0
    assert not torch.isfinite(model.modules[-1].weight).all()


@pytest.mark.parametrize("const,l2", [((-0.5, 0.5), None), (None, 1.0),
                                      ((-0.3, 0.2), 0.4)])
def test_grad_clipper_matches_jax(const, l2):
    from bigdl_tpu.optim.optimizer import _GradClipper as JClip
    from bigdl_tpu_torch.optim.optimizer import _GradClipper as TClip

    rs = np.random.RandomState(5)
    grads = [rs.randn(4, 3).astype(np.float32), rs.randn(6).astype(np.float32)]
    jc, tc = JClip(), TClip()
    jc.const_clip = tc.const_clip = const
    jc.l2_norm_clip = tc.l2_norm_clip = l2
    want = jc([jnp.asarray(g) for g in grads])
    got = tc([torch.from_numpy(g) for g in grads])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_triggers_match_jax():
    states = [dict(epoch=e, neval=n, epoch_finished=f)
              for e, n, f in ((1, 1, 0), (1, 3, 0), (2, 5, 1), (2, 6, 1),
                              (3, 9, 2), (4, 12, 3))]
    for name, arg in (("every_epoch", ()), ("max_epoch", (2,)),
                      ("max_iteration", (5,))):
        jt = getattr(JO.Trigger, name)(*arg)
        tt = getattr(TO.Trigger, name)(*arg)
        assert [tt(dict(s)) for s in states] == [jt(dict(s)) for s in states]
