"""The port's sequence parallelism against bigdl_tpu.parallel, on the CPU.

Ring and Ulysses attention, their ``*_sharded`` forms, the int8 ring
wire, ``RingMultiHeadAttention`` / ``UlyssesMultiHeadAttention`` and the
long-context example run at world 2 (and the data x seq composition at
world 4) in gloo processes through ``tests/torch_port_seq_worker.py``,
each rank on its block of the sequence.  The JAX side runs the same
numpy inputs through its shard_map forms on a 2-device (4-device) mesh
of the 8 virtual CPU devices.  The rank blocks, put back in order, must
match JAX's global arrays within 1e-5 (f32 sums in another order):
outputs and the gradients of ``sum(out · ct)``, the modules' parameter
gradients of ``sum(out²)`` (against JAX's sharded module and its dense
``MultiHeadAttention``), the int8 ring against JAX's int8 ring (the
same quantizer), and the example's per-step losses and final
parameters at worlds 1 and 2."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.nn.attention import MultiHeadAttention as JMHA
from bigdl_tpu.parallel import ring as JR
from bigdl_tpu.parallel import ulysses as JU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_seq_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_port_seq_worker as SW  # noqa: E402

ATOL = RTOL = 1e-5


def _run_world(tmp_path, world, case):
    store = str(tmp_path / f"store_{case}")
    outs = [str(tmp_path / f"{case}{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), store, outs[r], case],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def attn(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("attn"), 2, "attn")


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return JEngine.build_mesh(shape, devices=jax.devices()[:n])


def _cat(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def _jax_attn(fn, mesh, inp, **kw):
    """JAX's output and the vjp of ``ct``, jitted (one compile beats
    eager shard_map dispatch of every hop, as JAX's own tests note)."""
    def f(q, k, v, ct):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, seq_axis="seq",
                                              **kw), q, k, v)
        return out, vjp(ct)

    out, grads = jax.jit(f)(*(jnp.asarray(inp[c])
                              for c in ("q", "k", "v", "ct")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_and_grads_match_shard_map(attn, kind, causal):
    inp = SW.inputs()
    fn = {"ring": JR.ring_attention_sharded,
          "ulysses": JU.ulysses_attention_sharded}[kind]
    want, grads = _jax_attn(fn, _mesh({"seq": 2}), inp, causal=causal)
    name = f"{kind}_c{int(causal)}"
    np.testing.assert_allclose(_cat(attn, name, 2), want, atol=ATOL,
                               rtol=RTOL)
    for c, g in zip("qkv", grads):
        np.testing.assert_allclose(_cat(attn, f"{name}_d{c}", 2), g,
                                   atol=ATOL, rtol=RTOL, err_msg=f"d{c}")


def test_int8_ring_wire_matches_jax(attn):
    inp = SW.inputs()
    want, grads = _jax_attn(JR.ring_attention_sharded, _mesh({"seq": 2}),
                            inp, causal=True, wire="int8")
    np.testing.assert_allclose(_cat(attn, "ring_int8", 2), want, atol=ATOL,
                               rtol=RTOL)
    for c, g in zip("qkv", grads):
        np.testing.assert_allclose(_cat(attn, f"ring_int8_d{c}", 2), g,
                                   atol=ATOL, rtol=RTOL, err_msg=f"d{c}")
    # the wire is lossy: it is not the f32 ring
    assert not np.allclose(_cat(attn, "ring_int8", 2),
                           _cat(attn, "ring_c1", 2), atol=1e-6)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_modules_and_grads_match_jax(attn, kind):
    inp = SW.inputs()
    cls = {"ring": JR.RingMultiHeadAttention,
           "ulysses": JU.UlyssesMultiHeadAttention}[kind]
    m = cls(SW.DIM, SW.HEADS, _mesh({"seq": 2}), seq_axis="seq",
            causal=True)
    dense = JMHA(SW.DIM, SW.HEADS, causal=True, attn_impl="lax")
    p = {w: jnp.asarray(inp[w]) for w in dense.params()}
    x = jnp.asarray(inp["x"])

    def loss(mod):
        return lambda p: jnp.sum(mod.update_output_pure(p, x) ** 2)

    out = np.asarray(jax.jit(lambda p: m.update_output_pure(p, x))(p))
    grads = jax.jit(jax.grad(loss(m)))(p)
    dense_grads = jax.grad(loss(dense))(p)
    name = f"{kind}_mha"
    np.testing.assert_allclose(_cat(attn, name, 1), out, atol=ATOL,
                               rtol=RTOL)
    for w in p:
        for g in (grads[w], dense_grads[w]):
            np.testing.assert_allclose(attn[0][f"{name}_g_{w}"],
                                       np.asarray(g), atol=ATOL, rtol=RTOL,
                                       err_msg=w)
    assert str(attn[0][f"{name}_repr"]) == repr(m)


def test_heads_must_divide_by_the_axis(attn):
    msg = "ulysses_attention: 3 heads not divisible by axis size 2"
    assert all(str(r["heads_error"]) == msg for r in attn)
    q = jnp.zeros((1, 3, 8, 8))
    with pytest.raises(ValueError, match=msg):
        JU.ulysses_attention_sharded(q, q, q, _mesh({"seq": 2}))


def test_ring_composes_with_a_batch_axis(tmp_path):
    """A {"data": 2, "seq": 2} mesh at world 4: each rank rings its own
    batch row's blocks (JAX ``test_parallel.py:46``)."""
    inp = SW.inputs()
    mesh = _mesh({"data": 2, "seq": 2})
    want = np.asarray(jax.jit(lambda q, k, v: JR.ring_attention_sharded(
        q, k, v, mesh, seq_axis="seq", batch_axis="data", causal=True))(
            *(jnp.asarray(inp[c]) for c in "qkv")))
    t = SW.T // 2
    for r in _run_world(tmp_path, 4, "compose"):
        bi, si = r["coords"]
        np.testing.assert_allclose(
            r["compose"], want[bi:bi + 1, :, si * t:(si + 1) * t],
            atol=ATOL, rtol=RTOL)


# ---- the long-context example ----------------------------------------------
def _jax_example(n_seq, steps=3, seq=64, dim=32, heads=4, layers=2,
                 vocab=64):
    """The JAX example's loop (``examples/longcontext/train_long_lm.py``
    :65-120) on an ``n_seq``-device mesh, from RNG seed 1: per-step
    losses and the final parameters, flattened by dotted name."""
    from bigdl_tpu.models.transformer import build_transformer_lm
    from jax.sharding import NamedSharding, PartitionSpec as P

    JRandom.RNG.set_seed(1)
    mesh = _mesh({"seq": n_seq})
    model = build_transformer_lm(vocab, dim=dim, n_head=heads,
                                 n_layer=layers, max_len=seq, remat=True)
    for i in range(layers):
        blk = model._children[f"h{i}"]
        ul = JU.UlyssesMultiHeadAttention(dim, heads, mesh, seq_axis="seq",
                                          causal=True)
        ul.set_params(blk._children["attn"].params())
        blk._children["attn"] = ul
    params = model.params()
    ids, tgt = SW_LM.synthetic_stream(vocab, seq)
    shard = NamedSharding(mesh, P(None, "seq"))
    x = jax.device_put(jnp.asarray(ids.astype(np.float32)), shard)
    y = jax.device_put(jnp.asarray(tgt.astype(np.int32)), shard)

    def loss_fn(p, x, y):
        logits, _ = model.apply(p, model.state(), x, training=True,
                                rng=jax.random.key(0))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, :, None], 2))

    @jax.jit
    def step(p, x, y):
        loss, g = jax.value_and_grad(loss_fn)(p, x, y)
        return jax.tree.map(lambda w, gw: w - 0.1 * gw, p, g), loss

    losses = []
    for _ in range(steps):
        params, loss = step(params, x, y)
        losses.append(float(loss))
    return losses, _flat(params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


SW_LM = importlib.import_module("bigdl_tpu_torch.examples.train_long_lm")


def _assert_lm(losses, params, want_losses, want_params):
    np.testing.assert_allclose(losses, want_losses, atol=ATOL, rtol=RTOL)
    assert set(params) == set(want_params)
    for name, w in want_params.items():
        np.testing.assert_allclose(params[name], w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_example_matches_jax_at_world_1():
    from bigdl_tpu_torch.common import RandomGenerator as TRandom
    from bigdl_tpu_torch.engine import Engine

    Engine.reset()
    try:
        TRandom.RNG.set_seed(1)
        hist = {}
        SW_LM.main(SW.TINY_LM, device="cpu", history=hist)
    finally:
        Engine.reset()
    params = {n: p.detach().numpy()
              for n, p in hist["model"].named_parameters()}
    _assert_lm(hist["losses"], params, *_jax_example(1))


def test_example_matches_jax_at_world_2(tmp_path):
    ranks = _run_world(tmp_path, 2, "lm")
    want_losses, want_params = _jax_example(2)
    for r in ranks:
        params = {k[2:]: v for k, v in r.items() if k.startswith("p_")}
        _assert_lm(r["losses"], params, want_losses, want_params)

