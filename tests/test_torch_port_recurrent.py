"""The port's recurrent stack and PTB language model against the JAX
package, on the CPU.

Each cell (``RnnCell``, ``LSTM``, ``LSTMPeephole``, ``GRU``) through
``Recurrent``, ``BiRecurrent`` and a two-cell ``MultiRNNCell``, at B=3,
T=5, in=4, H=6, from the same seeded weights and numpy inputs: outputs
within atol 1e-5, and the gradients of the input and of every weight
against ``jax.grad`` within atol 1e-5, rtol 1e-4 (f32 sums of the same
products taken in other orders; ``lax.scan`` against a Python loop).
Then ``TimeDistributed(Linear)``, ``TimeDistributedCriterion`` in every
``size_average`` setting, ``Select``, ``LookupTable`` with
``padding_value`` and ``max_norm``, the per-gate dropout's masks, and a
tiny PTB LM (vocab 50, hidden 8, T=6) trained 3 steps by both
``LocalOptimizer``s with the L2 clip: each loss within 1e-5, the final
params within 2e-5 (the limits of ``test_torch_port_lm_train.py``), and
the perplexity within 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import text as JT
from bigdl_tpu.models import rnn as JRNN
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import text as TT
from bigdl_tpu_torch.models import rnn as TRNN
from bigdl_tpu_torch.nn.recurrent import _gate_dropout
from bigdl_tpu_torch.utils.convert import load_jax_params

B, T, IN, H = 3, 5, 4, 6
CELLS = ["RnnCell", "LSTM", "LSTMPeephole", "GRU"]
WRAPPERS = ["Recurrent", "BiRecurrent", "MultiRNNCell"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach().numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _build(pkg, cell, wrapper):
    """The same layer in either package (``pkg`` is ``JN`` or ``TN``)."""
    make = getattr(pkg, cell)
    if wrapper == "Recurrent":
        return pkg.Recurrent().add(make(IN, H))
    if wrapper == "BiRecurrent":
        return pkg.BiRecurrent().add(make(IN, H))
    return pkg.Recurrent().add(pkg.MultiRNNCell([make(IN, H), make(H, H)]))


def _pair(cell, wrapper, seed=7):
    JRandom.RNG.set_seed(seed)
    jm = _build(JN, cell, wrapper)
    TRandom.RNG.set_seed(seed)
    tm = _build(TN, cell, wrapper)
    return jm, tm


def _input(seed=0, shape=(B, T, IN)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = [(c, w) for w in WRAPPERS for c in CELLS]


@pytest.mark.parametrize("cell,wrapper", CASES)
def test_seeded_init_draws_the_jax_numbers(cell, wrapper):
    jm, tm = _pair(cell, wrapper)
    jp, tp = _flat(jax.tree.map(np.asarray, jm.params())), _flat(tm.params())
    assert set(jp) == set(tp) and jp
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


@pytest.mark.parametrize("cell,wrapper", CASES)
def test_outputs_match_jax(cell, wrapper):
    jm, _ = _pair(cell, wrapper)
    # a model drawn from another seed, given JAX's weights by the converter
    TRandom.RNG.set_seed(99)
    tm = _build(TN, cell, wrapper)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    x = _input()
    want, _ = jm.apply(jm.params(), jm.state(), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    width = 2 * H if wrapper == "BiRecurrent" else H
    assert tuple(got.shape) == (B, T, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("cell,wrapper", CASES)
def test_gradients_match_jax_grad(cell, wrapper):
    jm, tm = _pair(cell, wrapper)
    x = _input(1)
    width = 2 * H if wrapper == "BiRecurrent" else H
    r = np.random.RandomState(2).randn(B, T, width).astype(np.float32)

    def j_loss(p, xx):
        out, _ = jm.apply(p, jm.state(), xx, training=True)
        return jnp.sum(out * r)

    jgp, jgx = jax.grad(j_loss, argnums=(0, 1))(jm.params(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    named = list(tm.named_parameters())
    loss = torch.sum(tm(xt) * torch.from_numpy(r))
    grads = torch.autograd.grad(loss, [xt] + [p for _, p in named])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-4, err_msg="input")
    jflat = _flat(jax.tree.map(np.asarray, jgp))
    assert set(jflat) == {n for n, _ in named}
    for (name, _), g in zip(named, grads[1:]):
        assert np.abs(jflat[name]).max() > 0, name
        np.testing.assert_allclose(g.numpy(), jflat[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("cell", CELLS + ["MultiRNNCell"])
def test_a_cell_alone_runs_one_timestep_as_jax(cell):
    def build(pkg):
        if cell == "MultiRNNCell":
            return pkg.MultiRNNCell([pkg.LSTM(IN, H), pkg.GRU(H, H)])
        return getattr(pkg, cell)(IN, H)

    JRandom.RNG.set_seed(4)
    jm = build(JN)
    TRandom.RNG.set_seed(4)
    tm = build(TN)
    x = _input(3, (B, IN))
    want, _ = jm.apply(jm.params(), jm.state(), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_time_distributed_linear_and_select_match_jax():
    JRandom.RNG.set_seed(5)
    jm = JN.Sequential().add(JN.TimeDistributed(JN.Linear(IN, 7))) \
        .add(JN.Select(2, -1))
    TRandom.RNG.set_seed(5)
    tm = TN.Sequential().add(TN.TimeDistributed(TN.Linear(IN, 7))) \
        .add(TN.Select(2, -1))
    assert set(_flat(tm.params())) == {"0.0.weight", "0.0.bias"}
    x = _input(4)
    want, _ = jm.apply(jm.params(), jm.state(), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (B, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with torch.no_grad():
        first = TN.Select(2, 1)(torch.from_numpy(x))
    np.testing.assert_array_equal(first.numpy(), x[:, 0])


@pytest.mark.parametrize("outer", [True, False])
@pytest.mark.parametrize("inner", [True, False])
def test_time_distributed_criterion_matches_jax(outer, inner):
    rs = np.random.RandomState(6)
    logp = np.log(rs.dirichlet(np.ones(9), size=(B, T))).astype(np.float32)
    tgt = (rs.randint(0, 9, (B, T)) + 1).astype(np.float32)
    jc = JN.TimeDistributedCriterion(
        JN.ClassNLLCriterion(size_average=inner), size_average=outer)
    tc = TN.TimeDistributedCriterion(
        TN.ClassNLLCriterion(size_average=inner), size_average=outer)
    want = float(jc.loss(jnp.asarray(logp), jnp.asarray(tgt)))
    got = tc.loss(torch.from_numpy(logp), torch.from_numpy(tgt)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the sum over steps, scaled as the flags say
    per_step = -np.take_along_axis(logp, tgt[..., None].astype(int) - 1,
                                   -1)[..., 0]
    total = per_step.mean(0).sum() if inner else per_step.sum()
    np.testing.assert_allclose(got, total / T if outer else total,
                               rtol=1e-5)


@pytest.mark.parametrize("padding,max_norm", [(3, float("inf")), (0, 1.5),
                                               (3, 1.5)])
def test_lookup_table_matches_jax_and_keeps_its_weight(padding, max_norm):
    """With ``max_norm`` the all-zero padding row's norm has no
    derivative: JAX's gradient is NaN on that row, the port's takes
    torch's 0 subgradient there, so that row is held to be finite and
    the others to JAX's."""
    JRandom.RNG.set_seed(8)
    jm = JN.LookupTable(10, 5, padding_value=padding, max_norm=max_norm)
    TRandom.RNG.set_seed(8)
    tm = TN.LookupTable(10, 5, padding_value=padding, max_norm=max_norm)
    w0 = tm.weight.detach().clone()
    np.testing.assert_array_equal(w0.numpy(),
                                  np.asarray(jm.params()["weight"]))
    assert bool(w0[2].any()) == (padding != 3) and w0[3].abs().sum() > 0
    ids = np.array([[1, 3, 10, 4], [2.0, 7, 3, 1]], np.float32)
    r = np.random.RandomState(9).randn(2, 4, 5).astype(np.float32)

    def j_loss(p):
        out, _ = jm.apply(p, {}, jnp.asarray(ids))
        return jnp.sum(out * r), out

    (_, want), jg = jax.value_and_grad(j_loss, has_aux=True)(jm.params())
    out = tm(torch.from_numpy(ids))
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)),
                               [tm.weight])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    jgw = np.asarray(jg["weight"])
    rows = np.isfinite(jgw).all(axis=1)
    assert rows.sum() == (9 if padding and max_norm != float("inf") else 10)
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy()[rows], jgw[rows], atol=1e-5,
                               rtol=1e-4)
    torch.testing.assert_close(tm.weight.detach(), w0, rtol=0, atol=0)
    if max_norm != float("inf"):
        norms = out.detach().norm(dim=-1)
        assert float(norms.max()) <= max_norm + 1e-5
        assert float(w0.norm(dim=1).max()) > max_norm


def test_gate_dropout_masks_share_and_scale():
    p, keep = 0.3, 0.7
    x = torch.ones(16, 20, 32)
    d = _gate_dropout(x, 4, p, True, seed=123)
    assert tuple(d.shape) == (4, 16, 20, 32)
    vals = set(np.unique(d.numpy()).tolist())
    assert vals <= {0.0, np.float32(1 / keep)}
    n = x.numel()
    for g in range(4):
        share = float((d[g] != 0).float().mean())
        assert abs(share - keep) <= 3 * np.sqrt(keep * p / n), (g, share)
        for h in range(g):
            assert not torch.equal(d[g] != 0, d[h] != 0), (g, h)
    again = _gate_dropout(x, 4, p, True, seed=123)
    assert torch.equal(d, again)
    assert not torch.equal(d, _gate_dropout(x, 4, p, True, seed=124))
    for off in ((0.0, True, 1), (p, False, 1), (p, True, None)):
        assert _gate_dropout(x, 4, *off) is None


@pytest.mark.parametrize("cell", ["LSTM", "LSTMPeephole", "GRU"])
def test_dropout_through_the_lm_path(cell):
    """p = 0 in training with a seed is the plain path; p > 0 draws a
    mask from the step's seed, which ``Sequential`` folds per child."""
    x = _input(5)
    outs = {}
    for p in (0.0, 0.4):
        TRandom.RNG.set_seed(11)
        m = TN.Sequential().add(TN.Recurrent().add(
            getattr(TN, cell)(IN, H, p=p)))
        assert m.takes_rng_seed
        m.train()
        with torch.no_grad():
            outs[p] = [m(torch.from_numpy(x), rng_seed=s) for s in (1, 1, 2)]
            outs[p].append(m(torch.from_numpy(x)))
            m.evaluate()
            outs[p].append(m(torch.from_numpy(x), rng_seed=1))
    plain = outs[0.0][3]
    for o in outs[0.0] + outs[0.4][3:]:
        torch.testing.assert_close(o, plain, rtol=0, atol=0)
    seeded = outs[0.4]
    assert torch.equal(seeded[0], seeded[1])
    assert not torch.equal(seeded[0], seeded[2])
    assert not torch.equal(seeded[0], plain)


def test_text_pipeline_matches_jax():
    for kw in (dict(n_tokens=500, vocab_size=50, seed=3), dict()):
        np.testing.assert_array_equal(TT.synthetic_ptb_stream(**kw),
                                      JT.synthetic_ptb_stream(**kw))
    stream = TT.synthetic_ptb_stream(n_tokens=1000, vocab_size=50)
    for got, want in zip(TT.ptb_bptt_batches(stream, 4, 6),
                         JT.ptb_bptt_batches(stream, 4, 6)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="too short"):
        TT.ptb_bptt_batches(stream[:10], 4, 6)
    words = [["a", "b", "a"], ["c", "a", "b"]]
    td, jd = TT.Dictionary(words), JT.Dictionary(words)
    assert [td.get_index(w) for w in "abcz"] == [jd.get_index(w)
                                                 for w in "abcz"]
    assert td.get_word(2) == jd.get_word(2) and len(td) == len(jd) == 3
    s = TT.LabeledSentence([1, 2], [2, 3])
    assert s.data.dtype == s.labels.dtype == np.float32


class _Summary:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def test_tiny_ptb_lm_trains_as_jax():
    stream = TT.synthetic_ptb_stream(n_tokens=600, vocab_size=50)
    xs, ys = TT.ptb_bptt_batches(stream, 4, 6)
    x, y = xs.reshape(-1, 6), ys.reshape(-1, 6)

    def run(pkg, local, build, sgd, trig, **kw):
        JRandom.RNG.set_seed(21)
        TRandom.RNG.set_seed(21)
        model = build(50, embed_size=8, hidden_size=8, **kw)
        summ = _Summary()
        crit = pkg.TimeDistributedCriterion(pkg.ClassNLLCriterion(),
                                            size_average=True)
        opt = local(model, (x, y), crit, batch_size=4, **kw)
        opt.set_optim_method(sgd(learningrate=0.5))
        opt.set_end_when(trig.max_iteration(3)).set_train_summary(summ)
        opt.set_gradient_clipping_by_l2_norm(TRNN.PTB_CLIP_NORM)
        return opt.optimize(), summ

    jm, jsum = run(JN, JLocal, JRNN.build_ptb_lm, JO.SGD, JO.Trigger)
    tm, tsum = run(TN, TO.LocalOptimizer, TRNN.build_ptb_lm, TO.SGD,
                   TO.Trigger, device="cpu")
    assert sorted(tsum.loss) == sorted(jsum.loss) == [1, 2, 3]
    for n in (1, 2, 3):
        np.testing.assert_allclose(tsum.loss[n], jsum.loss[n], atol=1e-5,
                                   err_msg=f"step {n}")
    jp, tp = _flat(jax.tree.map(np.asarray, jm.params())), _flat(tm.params())
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-5, err_msg=k)
    want = JRNN.perplexity(jm, x, y, batch_size=5)
    got = TRNN.perplexity(tm, x, y, batch_size=5, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 1.0 < got < 50.0
