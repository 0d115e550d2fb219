"""The fused optimizer update (``ops/fused_update.py``) and the trainer
path that takes it.

- The plain version against the per-tensor path (``_GradClipper``,
  ``Adam.step``, the frozen keep and the guard's ``_where``) over tensors
  of mixed shapes, bit for bit on the CPU: with and without an L2 clip,
  a constant clip, a frozen tensor, a NaN or an inf gradient and a
  non-finite loss (p, m, v and ``neval`` kept exactly, ``ok`` False),
  and the guard off.
- ``LocalOptimizer`` with ``Adam`` takes the fused path (``fused`` True
  on its ``step.update`` span), with ``SGD`` and on a health step the
  per-tensor one; 3 fused steps give the per-tensor path's losses,
  parameters and state bit for bit.
- Marked ``cuda`` (skips without a card): the kernel against the plain
  version at GPT-2-medium's 389 tensors (406.3M values).  Run it on the
  card with ``python -m pytest --noconftest -m cuda
  tests/test_torch_port_fused_update.py`` (``--noconftest``: the tests'
  ``conftest.py`` imports JAX, which that machine lacks).
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import _cuda
from bigdl_tpu_torch.ops import fused_update as F

SHAPES = [(3, 4), (5,), (2, 3, 4), (7,), (1,), (4, 6)]
BETAS = (0.9, 0.999)
EPS = 1e-8
NEVAL = 4.0


def _tensors(shapes, seed=0, device="cpu"):
    """(grads, params, m, v) of ``shapes``, f32, from numpy."""
    rs = np.random.RandomState(seed)

    def make(scale, positive=False):
        out = []
        for s in shapes:
            a = rs.randn(*s).astype(np.float32) * scale
            out.append(torch.from_numpy(np.abs(a) if positive else a)
                       .to(device))
        return out

    return make(0.5), make(0.1), make(0.01), make(1e-4, positive=True)


def _method():
    from bigdl_tpu_torch.optim import Adam

    return Adam(learningrate=0.01, beta1=BETAS[0], beta2=BETAS[1],
                epsilon=EPS)


def _state(m, v, device="cpu"):
    one = torch.ones((), dtype=torch.float32, device=device)
    return {"neval": one * NEVAL, "epoch": one * 0, "lr_decay": one * 0.01,
            "lr_scale": one, "m": m, "v": v}


CASES = {
    # name: (L2 clip, constant clip, frozen tensors, poison, guard)
    "no_clip": (None, None, (), None, True),
    "l2_clip": (0.5, None, (), None, True),
    "l2_clip_at_one": (1e30, None, (), None, True),
    "const_clip": (None, (-0.3, 0.4), (), None, True),
    "both_clips": (0.5, (-0.3, 0.4), (), None, True),
    "frozen": (0.5, None, (1, 4), None, True),
    "nan_grad": (0.5, None, (), "nan", True),
    "inf_grad": (None, None, (), "inf", True),
    "inf_grad_const_clip": (None, (-0.3, 0.4), (), "inf", True),
    "nonfinite_loss": (0.5, None, (), "loss", True),
    "no_guard": (0.5, None, (1,), None, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_update_is_the_per_tensor_path_bit_for_bit(case):
    from bigdl_tpu_torch.optim.optimizer import _GradClipper, _where

    l2, const, frozen_at, poison, guard = CASES[case]
    grads, params, m, v = _tensors(SHAPES)
    loss = torch.tensor(1.25)
    if poison == "nan":
        grads[2][1, 2, 3] = float("nan")
    elif poison == "inf":
        grads[3][0] = float("inf")
    elif poison == "loss":
        loss = torch.tensor(float("inf"))
    frozen = [i in frozen_at for i in range(len(SHAPES))]
    # the trainer's backward zeroes a frozen tensor's gradient
    grads = [g * 0.0 if f else g for g, f in zip(grads, frozen)]
    method = _method()
    state = _state([a.clone() for a in m], [a.clone() for a in v])

    # the per-tensor path, as LocalOptimizer._train_step runs it
    clipper = _GradClipper()
    clipper.l2_norm_clip, clipper.const_clip = l2, const
    g = clipper(grads) if clipper.active else grads
    old = [p.clone() for p in params]
    new_p, new_opt = method.step(g, old, state)
    new_p = [o if f else q for q, o, f in zip(new_p, old, frozen)]
    if guard:
        ok_ref = torch.isfinite(loss)
        for a in g:
            ok_ref = ok_ref & torch.isfinite(a).all()
        new_p = _where(ok_ref, new_p, old)
        new_opt = _where(ok_ref, new_opt, state)

    # the fused update, in place, with the trainer's scalars
    p2, m2, v2 = ([a.clone() for a in x] for x in (params, m, v))
    upd = F.PlainAdamUpdate(grads, p2, m2, v2, frozen, l2, const)
    ok = upd.stats(loss) if (guard or l2 is not None) else None
    t = state["neval"] + 1.0
    upd.apply(method.current_rate(state), 1 - BETAS[0] ** t,
              1 - BETAS[1] ** t, beta1=BETAS[0], beta2=BETAS[1], eps=EPS,
              gate=guard)
    neval = torch.where(ok, t, state["neval"]) if guard else t

    for a, b in zip(p2 + m2 + v2, new_p + new_opt["m"] + new_opt["v"]):
        assert torch.equal(a, b)
    assert torch.equal(neval, new_opt["neval"])
    if guard:
        assert bool(ok) == bool(ok_ref) == (poison is None or (
            poison == "inf" and const is not None))
    if poison is not None and not bool(ok):
        for a, b in zip(p2 + m2 + v2, params + m + v):
            assert torch.equal(a, b)
        assert float(neval) == NEVAL
    for i in frozen_at:
        assert torch.equal(p2[i], params[i])
        if guard and bool(ok):
            assert torch.equal(m2[i], BETAS[0] * m[i] + (1 - BETAS[0])
                               * grads[i])


def test_takes_wants_f32_contiguous_tensors_on_one_device():
    grads, params, m, v = _tensors(SHAPES)
    assert F.takes(params) and F.takes(params, m, v)
    assert not F.takes([])
    assert not F.takes(params, m[:-1], v)
    assert not F.takes(params[:-1] + [params[-1].double()])
    assert not F.takes(params[:1] + [torch.zeros(4, 3).t()])
    assert not F.takes(params, m[:-1] + [torch.zeros(5)], v)
    # on the CPU the wrapper gives the plain version
    assert isinstance(F.adam_update(grads, params, m, v),
                      F.PlainAdamUpdate)


# ---------------------------------------------------------------- trainer

STEPS = 3


def _trainer(method="adam", clip="l2", frozen=False):
    import bigdl_tpu_torch.nn as N
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    RandomGenerator.RNG.set_seed(3)
    model = (N.Sequential().add(N.Linear(6, 5).set_name("fc1"))
             .add(N.Tanh()).add(N.Linear(5, 3).set_name("fc2"))
             .add(N.LogSoftMax()))
    if frozen:
        model.freeze("fc1")
    rs = np.random.RandomState(0)
    x = rs.randn(STEPS * 8, 6).astype(np.float32)
    y = (rs.randint(0, 3, STEPS * 8) + 1).astype(np.float32)
    opt = LocalOptimizer(model, ArrayDataSet(x, y, 8, shuffle=False),
                         N.ClassNLLCriterion(), batch_size=8, device="cpu")
    opt.set_optim_method(_method() if method == "adam"
                         else SGD(learningrate=0.1, momentum=0.5))
    if clip == "l2":
        opt.set_gradient_clipping_by_l2_norm(0.5)
    elif clip == "const":
        opt.set_constant_gradient_clipping(-0.05, 0.05)
    return opt.set_end_when(Trigger.max_iteration(STEPS))


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value


def _train(opt, fused=True):
    if not fused:
        opt._fused_adam_now = lambda *a: False
    losses = _Losses()
    opt.set_train_summary(losses)
    opt.optimize()
    st = opt.optim_method.state
    return ([losses.loss[k] for k in sorted(losses.loss)],
            [p.detach().clone() for p in opt._param_leaves()[1]],
            st.get("m"), st.get("v"), st["neval"], opt._frozen_mask)


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """The obs tracer on (its spans carry the regions' attributes)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.engine import Engine

    for k in ("BIGDL_TORCH_PROFILE", "BIGDL_TORCH_OBS_PORT",
              "BIGDL_TORCH_NONFINITE_GUARD", "BIGDL_TORCH_HEALTH_EVERY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path))
    Engine.reset()
    obs.reset()
    yield lambda: [r for r in obs.get_tracer().recent()
                   if r["kind"] == "span" and r["name"] == "step.update"]
    obs.reset()
    Engine.reset()


@pytest.mark.parametrize("case", [("l2", False), ("none", False),
                                  ("const", False), ("l2", True)])
def test_local_optimizer_fused_steps_equal_the_per_tensor_path(case,
                                                               traced):
    clip, frozen = case
    fused = _train(_trainer(clip=clip, frozen=frozen))
    spans = traced()
    assert [s["attrs"]["fused"] for s in spans] == [True] * STEPS
    plain = _train(_trainer(clip=clip, frozen=frozen), fused=False)
    assert [s["attrs"]["fused"] for s in traced()[STEPS:]] == \
        [False] * STEPS
    assert fused[0] == plain[0] and len(fused[0]) == STEPS
    for a, b in zip(fused[1] + fused[2] + fused[3],
                    plain[1] + plain[2] + plain[3]):
        assert torch.equal(a, b)
    assert float(fused[4]) == float(plain[4]) == STEPS
    start = _trainer(frozen=frozen)._param_leaves()[1]
    assert sum(fused[5]) == (2 if frozen else 0)
    for a, b, f in zip(fused[1], start, fused[5]):
        assert torch.equal(a, b.detach()) == f


def test_sgd_and_health_steps_take_the_per_tensor_path(traced,
                                                       monkeypatch):
    _train(_trainer(method="sgd"))
    assert [s["attrs"]["fused"] for s in traced()] == [False] * STEPS
    # health every 2nd step, the guard off (with it on, every step keeps
    # stats to read should the guard trip): step 2 takes the per-tensor
    # path, steps 1 and 3 the fused one
    monkeypatch.setenv("BIGDL_TORCH_HEALTH_EVERY", "2")
    monkeypatch.setenv("BIGDL_TORCH_NONFINITE_GUARD", "0")
    _train(_trainer())
    assert [s["attrs"]["fused"] for s in traced()[STEPS:]] == \
        [True, False, True]
    monkeypatch.setenv("BIGDL_TORCH_NONFINITE_GUARD", "1")
    _train(_trainer())
    assert [s["attrs"]["fused"] for s in traced()[2 * STEPS:]] == \
        [False] * STEPS


def test_a_nonfinite_batch_leaves_the_fused_state_as_it_was():
    opt = _trainer()
    names, params, tree = opt._param_leaves()
    opt._init_opt_state(params, tree)
    opt._frozen_mask = [False] * len(params)
    st = opt.optim_method.state
    before = [t.clone() for t in params + st["m"] + st["v"]]
    x = torch.full((8, 6), float("nan"))
    y = torch.ones(8)
    new, loss, ok = opt._train_step(names, params, st, x, y, None, True, 0)
    assert not bool(ok) and not torch.isfinite(loss)
    assert new["m"] is st["m"] and float(new["neval"]) == 0.0
    for a, b in zip(before, params + st["m"] + st["v"]):
        assert torch.equal(a.detach(), b.detach())


# ------------------------------------------------------------------ card

# GPT-2-medium as the benchmark builds it: token and position tables,
# 24 blocks of two LayerNorms, q/k/v/out projections and the MLP, the
# final LayerNorm and an untied bias-free head
D, FF, VOCAB, POS, LAYERS = 1024, 4096, 50257, 1024, 24


def gpt2_medium_shapes():
    shapes = [(VOCAB, D), (POS, D)]
    for _ in range(LAYERS):
        shapes += [(D,), (D,)] + [(D, D), (D,)] * 4 + [(D,), (D,)]
        shapes += [(FF, D), (FF,), (D, FF), (D,)]
    return shapes + [(D,), (D,), (VOCAB, D)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; on the card: python -m pytest "
                    "--noconftest -m cuda "
                    "tests/test_torch_port_fused_update.py")
    torch.cuda.empty_cache()
    yield torch.device("cuda")
    torch.cuda.empty_cache()


def _card_tensors(shapes, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(scale):
        return [torch.randn(s, generator=gen, device=dev) * scale
                for s in shapes]

    g, p, m = make(1e-3), make(0.02), make(1e-3)
    v = [(a * a).mul_(0.1) for a in make(1e-3)]
    return g, p, m, v


CARD_CASES = {
    # name: (L2 clip, constant clip, frozen tensors, poison, bit-equal)
    "no_clip_unaligned": (None, None, (), None, True),
    "clip_at_one": (1e30, None, (), None, True),
    "clip": (1.0, None, (), None, False),
    "frozen_const_clip": (1.0, (-2e-3, 2e-3), (0, 5), None, False),
    "nan": (1.0, None, (), "nan", True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_the_plain_version_at_gpt2_medium(case, card):
    l2, const, frozen_at, poison, exact = CARD_CASES[case]
    shapes = gpt2_medium_shapes()
    assert len(shapes) == 389
    assert sum(int(np.prod(s)) for s in shapes) == 406_286_336
    g, p, m, v = _card_tensors(shapes, card, seed=26)
    if poison == "nan":
        g[200].view(-1)[12345] = float("nan")
    frozen = [i in frozen_at for i in range(len(shapes))]
    g = [a * 0.0 if f else a for a, f in zip(g, frozen)]
    loss = torch.tensor(2.5, device=card)
    one = torch.ones((), device=card)
    t = one * 5.0 + 1.0
    lr = (one * 3e-4) / (1.0 + (one * 5.0) * 0.0)
    bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
    p0, m0, v0 = ([a.clone() for a in x] for x in (p, m, v))

    def copies():
        out = [[a.clone() for a in x] for x in (p0, m0, v0)]
        if case == "no_clip_unaligned":
            # p and m views 4 bytes past an aligned start: the kernel's
            # scalar path for those tensors
            for k, i in ((0, 3), (0, 100), (1, 7), (1, 100)):
                a = out[k][i]
                base = torch.empty(a.numel() + 1, device=card)
                base[1:].copy_(a.reshape(-1))
                out[k][i] = base[1:].view(a.shape)
                assert out[k][i].data_ptr() % 16 == 4
        return out

    def run(cls, pp, mm, vv):
        upd = cls(g, pp, mm, vv, frozen, l2, const)
        ok = upd.stats(loss)
        upd.apply(lr, bc1, bc2, beta1=BETAS[0], beta2=BETAS[1], eps=EPS,
                  gate=True)
        return bool(ok)

    before = _cuda.launches["fused_adam"]
    pk, mk, vk = copies()
    ok_k = run(F.adam_update, pk, mk, vk)
    assert _cuda.launches["fused_adam"] == before + 2
    # run to run: the same bits
    pk2, mk2, vk2 = copies()
    assert run(F.KernelAdamUpdate, pk2, mk2, vk2) == ok_k
    for a, b in zip(pk + mk + vk, pk2 + mk2 + vk2):
        assert torch.equal(a, b)
    del pk2, mk2, vk2
    ok_p = run(F.PlainAdamUpdate, p, m, v)
    torch.cuda.synchronize()
    assert ok_k == ok_p == (poison is None)
    if not ok_k:
        for a, b in zip(pk + mk + vk, p0 + m0 + v0):
            assert torch.equal(a, b)
        return
    for i in frozen_at:
        assert torch.equal(pk[i], p0[i])
    if exact:
        for a, b in zip(pk + mk + vk, p + m + v):
            assert torch.equal(a, b)
        return
    # the norm is summed in another order: the scale may differ by a few
    # ulps, and each value as much relative to its step
    for a, b, a0 in zip(pk + mk + vk, p + m + v, p0 + m0 + v0):
        step = (b - a0).abs().max().item()
        assert (a - b).abs().max().item() <= 1e-5 * step + \
            float(torch.finfo(torch.float32).eps) * b.abs().max().item()


def test_the_kernel_source_and_the_wrapper_share_their_constants():
    import os

    src = open(os.path.join(_cuda.CSRC, "fused_adam.cu")).read()
    assert f"constexpr long long CHUNK = {F.CHUNK};" in src
    for name in ("CONST_CLIP", "L2_CLIP", "GATE"):
        assert f"constexpr int {name} = {getattr(F, name)};" in src
    for name in ("FROZEN", "ALIGNED"):
        assert f"constexpr long long {name} = {getattr(F, name)};" in src
    assert _cuda.SOURCES["fused_adam"] == "fused_adam.cu"
    sym, argtypes = _cuda._SIGNATURES["fused_adam"]
    assert sym == "bigdl_fused_adam" and len(argtypes) == 19
    assert f"extern \"C\" int {sym}(" in src
    # the header's ok byte and the table's entry and header widths
    assert "unsigned int ticket;\n  float scale;\n  unsigned char ok;" in src
    assert F.OK_BYTE == 8 and F.HEADER_WORDS == F.ENTRY_WORDS == 8
