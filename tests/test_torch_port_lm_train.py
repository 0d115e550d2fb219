"""Training the port's TransformerLM against the JAX package, on the CPU.

A tiny flagship (vocab 64, dim 32, 2 heads, 2 layers, T=16) trained 3
steps by the JAX ``LocalOptimizer`` with ``attn_impl="pallas_interpret"``
(the Pallas flash forward and both backward kernels in interpret mode)
against the port's ``LocalOptimizer`` with ``attn_impl="kernel"`` on the
CPU (the flash forward and backward's plain versions), from the same
seeds, int32 tokens and shuffle order: each step's loss within 1e-5 and
the final params within 2e-5, the limits the ResNet trajectory test
holds (3 SGD steps of f32 sums taken in other orders); the whole-model
gradient of one step against ``jax.grad`` within atol 1e-5, rtol 1e-4.
Then the port's own contracts: ``remat`` changes the schedule, not the
math, with dropout on; dropout's mask, share and scale; and int32
tokens that reach the embedding unrounded under the bf16 policy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.common import fold_in
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_build
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, dropout
from bigdl_tpu_torch.ops import attention as TA

VOCAB, T = 64, 16
TINY = dict(dim=32, n_head=2, n_layer=2, max_len=T)


def _tokens(n=8, seed=0, vocab=VOCAB):
    """int32 ids and 1-based targets, as chip_smoke.py makes them."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (n, T)).astype(np.int32),
            (rs.randint(0, vocab, (n, T)) + 1).astype(np.int32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach().numpy() if isinstance(v, torch.Tensor) else v)
    return out


class _Summary:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def test_three_step_trajectory_matches_jax():
    x, y = _tokens()
    JRandom.RNG.set_seed(3)
    jm = j_build(VOCAB, attn_impl="pallas_interpret", **TINY)
    jsum = _Summary()
    jopt = JLocal(jm, (x, y), JN.CrossEntropyCriterion(), batch_size=4)
    jopt.set_optim_method(JO.SGD(learningrate=0.1))
    jopt.set_end_when(JO.Trigger.max_iteration(3)).set_train_summary(jsum)
    jopt.optimize()

    TRandom.RNG.set_seed(3)
    tm = t_build(VOCAB, attn_impl="kernel", device="cpu", **TINY)
    tsum = _Summary()
    topt = TO.LocalOptimizer(tm, (x, y), TN.CrossEntropyCriterion(),
                             batch_size=4, device="cpu")
    topt.set_optim_method(TO.SGD(learningrate=0.1))
    topt.set_end_when(TO.Trigger.max_iteration(3)).set_train_summary(tsum)
    topt.optimize()

    assert sorted(tsum.loss) == sorted(jsum.loss) == [1, 2, 3]
    for n in (1, 2, 3):
        np.testing.assert_allclose(tsum.loss[n], jsum.loss[n], atol=1e-5,
                                   err_msg=f"step {n}")
    jp, tp = _flat(jax.tree.map(np.asarray, jm.params())), _flat(tm.params())
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-5, err_msg=k)


def test_whole_model_gradient_matches_jax_grad():
    x, y = _tokens(4, seed=1)
    JRandom.RNG.set_seed(5)
    jm = j_build(VOCAB, attn_impl="pallas_interpret", **TINY)
    TRandom.RNG.set_seed(5)
    tm = t_build(VOCAB, attn_impl="kernel", device="cpu", **TINY)
    crit = JN.CrossEntropyCriterion()

    def loss_fn(p):
        logits, _ = jm.apply(p, {}, jnp.asarray(x), training=True)
        return crit.loss(logits, jnp.asarray(y))

    jloss, jg = jax.value_and_grad(loss_fn)(jm.params())
    tm.train()
    named = list(tm.named_parameters())
    tloss = TN.CrossEntropyCriterion().loss(tm(torch.from_numpy(x)),
                                            torch.from_numpy(y))
    tg = torch.autograd.grad(tloss, [p for _, p in named])
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert set(jflat) == {n for n, _ in named}
    for (name, _), g in zip(named, tg):
        np.testing.assert_allclose(g.numpy(), jflat[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    for w in ("wq", "wk", "wv"):
        assert np.abs(jflat[f"h0.attn.{w}"]).max() > 0


def test_remat_matches_plain_with_dropout(monkeypatch):
    """remat=True recomputes each block in the backward (one more flash
    forward per block) and draws the same dropout masks: the same loss
    and gradients as the stored-activation path."""
    calls = {"fwd": 0}
    fwd = TA._flash_forward

    def counting(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    monkeypatch.setattr(TA, "_flash_forward", counting)
    x, y = _tokens(2, seed=4)
    seed = fold_in(1234, 1)
    out = {}
    for remat in (False, True):
        TRandom.RNG.set_seed(9)
        m = t_build(VOCAB, attn_impl="kernel", dropout=0.1, remat=remat,
                    device="cpu", **TINY)
        m.train()
        named = list(m.named_parameters())
        calls["fwd"] = 0
        loss = TN.CrossEntropyCriterion().loss(
            m(torch.from_numpy(x), rng_seed=seed), torch.from_numpy(y))
        grads = torch.autograd.grad(loss, [p for _, p in named])
        out[remat] = (loss.item(), grads, calls["fwd"])
        with torch.no_grad():
            plain = TN.CrossEntropyCriterion().loss(
                m(torch.from_numpy(x)), torch.from_numpy(y))
        assert plain.item() != out[remat][0]     # the masks are live
    assert out[False][2] == 2 and out[True][2] == 4
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for (name, _), a, b in zip(named, out[False][1], out[True][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=name)


def test_dropout_mask_share_scale_and_seed():
    x = torch.ones(200_000)
    y = dropout(x, 0.25, seed=7)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005
    assert torch.all(y[kept] == 1.0 / 0.75)
    assert torch.equal(dropout(x, 0.25, seed=7), y)
    assert not torch.equal(dropout(x, 0.25, seed=8), y)


@pytest.mark.parametrize("p,train,seed,acts", [
    (0.5, True, 3, True), (0.5, False, 3, False), (0.0, True, 3, False),
    (0.5, True, None, False)])
def test_attention_dropout_acts_only_in_training_with_p_and_seed(
        p, train, seed, acts):
    TRandom.RNG.set_seed(0)
    mha = MultiHeadAttention(32, 2, causal=True, dropout=p)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 32)
                         .astype(np.float32))
    mha.train(train)
    with torch.no_grad():
        got = mha(x, seed)
        mha.dropout = 0.0
        want = mha(x)
    assert (not torch.equal(got, want)) == acts


def test_int32_tokens_reach_the_embedding_unrounded_under_bf16():
    vocab = 1000                     # bf16 holds integers exactly to 256
    x, y = _tokens(4, seed=2, vocab=vocab)
    x[0, :4] = [257, 999, 511, 777]
    TRandom.RNG.set_seed(0)
    m = t_build(vocab, attn_impl="kernel", device="cpu", **TINY)
    seen = []
    m.wte.register_forward_hook(lambda mod, inp, out: seen.append(inp[0]))
    opt = TO.LocalOptimizer(m, (x, y), TN.CrossEntropyCriterion(),
                            batch_size=4, device="cpu")
    opt.set_compute_dtype("bfloat16").set_end_when(
        TO.Trigger.max_iteration(1))
    opt.optimize()
    tokens, = seen
    assert tokens.dtype == torch.int32
    assert sorted(map(tuple, tokens.numpy())) == sorted(map(tuple, x))
    assert np.isfinite(opt.state["loss"])


def test_remat_under_the_bf16_policy_trains_like_plain():
    """LocalOptimizer's bf16 casts live only inside its functional_call;
    the remat recompute in the backward must still run on them (and
    draw the same dropout masks): the same losses and params as without
    remat."""
    x, y = _tokens(4, seed=6)
    runs = {}
    for remat in (False, True):
        TRandom.RNG.set_seed(2)
        m = t_build(VOCAB, attn_impl="kernel", dropout=0.1, remat=remat,
                    device="cpu", **TINY)
        summary = _Summary()
        opt = TO.LocalOptimizer(m, (x, y), TN.CrossEntropyCriterion(),
                                batch_size=2, device="cpu")
        opt.set_optim_method(TO.SGD(learningrate=0.1)).set_compute_dtype(
            "bfloat16").set_train_summary(summary)
        opt.set_end_when(TO.Trigger.max_iteration(2)).optimize()
        runs[remat] = (summary.loss, _flat(m.params()))
    assert runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][k], v, err_msg=k)
