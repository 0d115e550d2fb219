"""The port's pipeline and MoE against bigdl_tpu.parallel, on the CPU.

``MoE`` at one rank against JAX's on the same weights (JAX's ``reset``
drawn from the same seed, carried over by ``utils/convert``): top-1,
top-2 and a capacity that drops tokens, the output, the aux loss and
the gradients of ``sum(y²) + aux`` with respect to the input and every
parameter, within 1e-4 (JAX's tests, ``tests/test_parallel.py:192-289``),
and per-token routing by index as a second reference.  Then in gloo
processes through ``tests/torch_port_parallel_worker.py`` at worlds 2
and 4: ``pipelined`` over as many stages against JAX's ``pipelined``
on the shapes of ``tests/test_parallel.py:139-188`` (forward 1e-5; the
gradients of ``sum(out²)``, each rank's in its own stage's row, reach
every stage and equal JAX's), and ``MoE`` over an ``expert`` axis of as
many ranks against JAX's mesh ``MoE``: every rank's output, aux loss
and gradients (its own experts' slice), with no wire, the int8 and the
fp8 wires (``tests/test_wire.py:484``), and the ``all_to_all``,
``sharding_constraint``, ``ppermute`` and ``psum`` counters and the
``path="moe"`` gauge equal to JAX's."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import obs as jobs
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.parallel import MoE as JMoE
from bigdl_tpu.parallel import pipelined as j_pipelined
from bigdl_tpu.parallel.wire import WireSpec as JWireSpec
from bigdl_tpu_torch.parallel import MoE
from bigdl_tpu_torch.utils.convert import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__))))
import torch_port_parallel_worker as PW  # noqa: E402

TOL = 1e-4
CASES = {name: (k, cf, wire) for name, k, cf, wire in PW.MOE_CASES}


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return JEngine.build_mesh(shape, devices=jax.devices()[:n])


def _collectives() -> dict:
    out = {}
    metrics = jobs.get_registry().snapshot()["metrics"]
    for name, labels in (("bigdl_collective_bytes_total", ("op", "dtype")),
                         ("bigdl_collective_wire_savings_ratio", ("path",))):
        for s in metrics.get(name, {}).get("samples", []):
            key = "|".join((name,) + tuple(s["labels"][k] for k in labels))
            out[key] = s["value"]
    return out


def _jmoe(name, mesh=None):
    k, cf, wire = CASES[name]
    JRandom.RNG.set_seed(3)
    return JMoE(8, 16, 4, top_k=k, capacity_factor=cf, mesh=mesh,
                wire=None if wire is None else JWireSpec(*wire))


def _jax_moe(m, x):
    """JAX's output, aux loss and the gradients of sum(y²) + aux (input
    first, then the parameters by name), jitted."""
    p = m.params()

    def loss(p, x):
        y, aux = m.forward_with_aux(p, x)
        return jnp.sum(y * y) + aux

    y, aux = jax.jit(m.forward_with_aux)(p, x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    return np.asarray(y), float(aux), np.asarray(gx), jax.tree.map(
        np.asarray, gp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_moe")
    weights = PW.save_weights(str(tmp / "w.npz"), moe=jax.tree.map(
        np.asarray, _jmoe("top2").params()))
    return {w: PW.launch(tmp, w, "pipe_moe", weights) for w in (2, 4)}


# ---- one rank ------------------------------------------------------------
def _by_index(params, x, k):
    """Each token through its top-k experts picked by index, weighted by
    the gates, top-2 renormalized: ample capacity's MoE."""
    p = {n: np.asarray(v, np.float64) for n, v in params.items()}
    xs = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xs @ p["gate"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xs)
    for i, tok in enumerate(xs):
        order = np.argsort(-logits[i])[:k]
        for e in order:
            h = np.maximum(tok @ p["w_in"][e] + p["b_in"][e], 0)
            out[i] += (h @ p["w_out"][e] + p["b_out"][e]) * probs[i, e]
        if k > 1:
            out[i] /= probs[i, order].sum()
    return out.reshape(x.shape)


@pytest.mark.parametrize("name", ["top1", "top2", "drop"])
def test_moe_matches_jax(name):
    jm = _jmoe(name)
    x = PW.moe_input()
    y, aux, gx, gp = _jax_moe(jm, jnp.asarray(x))
    k, cf, _ = CASES[name]
    tm = MoE(8, 16, 4, top_k=k, capacity_factor=cf)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tm.forward_with_aux(xt)
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(ty.square().sum() + taux, (xt,) + params)
    np.testing.assert_allclose(ty.detach().numpy(), y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taux.item(), aux, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(grads[0].numpy(), gx, rtol=TOL, atol=TOL)
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), gp[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    if name == "drop":
        # capacity 8 of 32 tokens an expert: some tokens fall through to 0
        assert (np.abs(y.reshape(-1, 8)).sum(-1) == 0).any()
    else:
        np.testing.assert_allclose(ty.detach().numpy(),
                                   _by_index(jm.params(), x, k), rtol=TOL,
                                   atol=TOL)


def test_moe_reset_draws_jax_weights():
    from bigdl_tpu_torch.common import RandomGenerator as TRandom

    TRandom.RNG.set_seed(3)
    tm = MoE(8, 16, 4, top_k=2, capacity_factor=4.0)
    want = _jmoe("top2").params()
    for n, p in tm.params().items():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want[n]))
    assert repr(tm) == repr(_jmoe("top2"))
    assert tm.get_config() == _jmoe("top2")._config


# ---- the pipeline at worlds 2 and 4 ---------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_pipelined_matches_jax(ranks, world):
    inp = PW.pipe_inputs(world)
    mesh = _mesh({"pipe": world})
    run = j_pipelined(lambda p, a: jnp.tanh(a @ p["w"] + p["b"]), mesh,
                      "pipe")
    stacked = {k: jnp.asarray(inp[k]) for k in ("w", "b")}
    x = jnp.asarray(inp["x"])
    jobs.reset()
    out = np.asarray(jax.jit(run)(stacked, x))
    counters = _collectives()
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(run(p, x) ** 2),
                              argnums=(0, 1)))(stacked, x)
    # the stages in sequence
    ref = inp["x"]
    for w, b in zip(inp["w"], inp["b"]):
        ref = np.tanh(ref @ w + b)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    got = ranks[world]
    for r in got:
        np.testing.assert_allclose(r["pipe_out"], out, rtol=1e-5, atol=1e-5)
        assert json.loads(str(r["c_pipe"])) == counters
    for k, g in (("w", gp["w"]), ("b", gp["b"])):
        for stage, r in enumerate(got):
            row = r[f"pipe_g{k}"]
            # each rank's gradient lands in its own stage's row, nonzero
            assert np.abs(row[stage]).sum() > 0
            assert not np.delete(row, stage, axis=0).any()
        np.testing.assert_allclose(sum(r[f"pipe_g{k}"] for r in got),
                                   np.asarray(g), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(r["pipe_gx"] for r in got),
                               np.asarray(gx), rtol=1e-5, atol=1e-5)


# ---- MoE over an expert axis at worlds 2 and 4 ----------------------------
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [c[0] for c in PW.MOE_CASES])
def test_expert_axis_matches_jax_mesh_moe(ranks, world, name):
    mesh = _mesh({"expert": world})
    jm = _jmoe(name, mesh)
    x = jnp.asarray(PW.moe_input())
    jobs.reset()
    with mesh:
        jax.jit(jm.forward_with_aux)(jm.params(), x)
    counters = _collectives()
    with mesh:
        y, aux, gx, gp = _jax_moe(jm, x)
    e = 4 // world
    for rank, r in enumerate(ranks[world]):
        np.testing.assert_allclose(r[f"moe_{name}_y"], y, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r[f"moe_{name}_aux"], aux, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(r[f"moe_{name}_gx"], gx, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(r[f"moe_{name}_g_gate"], gp["gate"],
                                   rtol=TOL, atol=TOL)
        for n in ("w_in", "b_in", "w_out", "b_out"):
            np.testing.assert_allclose(
                r[f"moe_{name}_g_{n}"], gp[n][rank * e:(rank + 1) * e],
                rtol=TOL, atol=TOL, err_msg=n)
        assert json.loads(str(r[f"c_moe_{name}"])) == counters
    if CASES[name][2] is not None:
        assert counters["bigdl_collective_wire_savings_ratio|moe"] > 3.0
