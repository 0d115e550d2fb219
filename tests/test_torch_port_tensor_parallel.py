"""The port's tensor parallelism against bigdl_tpu.parallel, on the CPU.

``param_specs`` against JAX's, leaf for leaf, on the small
``TransformerLM`` of ``tests/test_parallel.py:99`` (vocab 64, dim 32, 4
heads, 2 layers, max_len 16) over several axis sizes, one that divides
no split dim among them.  Then, at world 2 (``{"model": 2}``) and world
4 (``{"data": 2, "model": 2}``) in gloo processes through
``tests/torch_port_parallel_worker.py``, on JAX's weights: each rank's
``shard_params`` slices equal the addressable shards of JAX's sharded
arrays; the TP forward equals JAX's jitted forward on them (2e-4, JAX's
own tolerance, ``tests/test_parallel.py:130-131``) and its gradients of
``sum(logits · ct)`` equal ``jax.grad`` of the dense forward (1e-5 of
the largest gradient entry);
``gradient_psum`` and ``wire_psum`` with the f32 and int8 wires equal
JAX's (1e-6, the sums' order; the int8 error-feedback residuals, the
quantization error itself, too); and the ``tp_shard_params``, ``psum``
and ``sharding_constraint`` counters and the ``path="tp"`` gauge equal
JAX's."""

import json
import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from bigdl_tpu import obs as jobs
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu.optim.distri_optimizer import _shard_map
from bigdl_tpu.parallel import tensor_parallel as JTP
from bigdl_tpu.parallel import wire as JW
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_build
from bigdl_tpu_torch.parallel import param_specs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__))))
import torch_port_parallel_worker as PW  # noqa: E402

SHAPES = {2: {"model": 2}, 4: {"data": 2, "model": 2}}


def _jmodel():
    JRandom.RNG.set_seed(0)
    return j_build(64, attn_impl="xla", **PW.TP_LM)


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return JEngine.build_mesh(shape, devices=jax.devices()[:n])


def _collectives() -> dict:
    """JAX's collective counters and savings gauges, keyed as the
    worker keys the port's."""
    out = {}
    metrics = jobs.get_registry().snapshot()["metrics"]
    for name, labels in (("bigdl_collective_bytes_total", ("op", "dtype")),
                         ("bigdl_collective_wire_savings_ratio", ("path",))):
        for s in metrics.get(name, {}).get("samples", []):
            key = "|".join((name,) + tuple(s["labels"][k] for k in labels))
            out[key] = s["value"]
    return out


def _leaves(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        elif v is not None:
            out[f"{prefix}/{k}"] = v
    return out


@pytest.fixture(scope="module")
def jmodel():
    return _jmodel()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jmodel):
    tmp = tmp_path_factory.mktemp("tp")
    weights = PW.save_weights(str(tmp / "w.npz"), tp=jax.tree.map(
        np.asarray, jmodel.params()))
    return {w: PW.launch(tmp, w, "tp", weights) for w in (2, 4)}


def _rank_of(mesh, device) -> int:
    return list(mesh.devices.flat).index(device)


@pytest.mark.parametrize("shape", [{"model": 2}, {"data": 2, "model": 2},
                                   {"model": 3}, {"model": 64}],
                         ids=["model2", "data2_model2", "model3", "model64"])
def test_param_specs_equal_jax(jmodel, shape):
    mesh = types.SimpleNamespace(shape=shape)
    want = _leaves(JTP.param_specs(jmodel.params(), mesh), "")
    got = _leaves(param_specs(t_build(64, device="cpu", **PW.TP_LM).params(),
                              mesh), "")
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == tuple(spec), path
    split = {p for p, s in got.items() if any(a is not None for a in s)}
    # 3 divides no split dim; at 64 only the vocab-sized and MLP-sized
    # dims divide, so the attention drops to replicated
    if shape == {"model": 3}:
        assert not split
    if shape == {"model": 64}:
        assert "/head/weight" in split and "/h0/attn/wq" not in split


@pytest.mark.parametrize("world", [2, 4])
def test_shard_params_slices_are_jax_shards(jmodel, ranks, world):
    mesh = _mesh(SHAPES[world])
    jobs.reset()
    sharded = JTP.shard_params(jmodel.params(), mesh)
    counters = _collectives()
    for path, arr in _leaves(sharded, "local").items():
        for shard in arr.addressable_shards:
            r = ranks[world][_rank_of(mesh, shard.device)]
            np.testing.assert_array_equal(r[path], np.asarray(shard.data),
                                          err_msg=path)
    for r in ranks[world]:
        assert json.loads(str(r["c_shard"])) == counters


@pytest.mark.parametrize("world", [2, 4])
def test_tp_forward_matches_jax_sharded_forward(jmodel, ranks, world):
    mesh = _mesh(SHAPES[world])
    inp = PW.tp_inputs()
    sharded = JTP.shard_params(jmodel.params(), mesh)
    state = jmodel.state()

    @jax.jit
    def fwd(p, x):
        return jmodel.apply(p, state, x, training=False, rng=None)[0]

    with mesh:
        want = np.asarray(fwd(sharded, jnp.asarray(inp["tokens"])))
    nd = SHAPES[world].get("data", 1)
    for rank, r in enumerate(ranks[world]):
        di = rank // 2 if nd > 1 else 0
        rows = slice(di * 4 // nd, (di + 1) * 4 // nd)
        np.testing.assert_allclose(r["logits"], want[rows], rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_gradients_match_jax_grad(jmodel, ranks, world):
    mesh = _mesh(SHAPES[world])
    inp = PW.tp_inputs()
    state = jmodel.state()
    x, ct = jnp.asarray(inp["tokens"]), jnp.asarray(inp["ct"])

    def loss(p):
        out = jmodel.apply(p, state, x, training=False, rng=None)[0]
        return jnp.sum(out * ct)

    grads = jax.grad(loss)(jmodel.params())
    # each rank's slice of the dense gradient, cut as its weights were,
    # within 1e-5 of the largest gradient entry (sums in another order;
    # the key biases' true gradient is 0, softmax being shift-invariant,
    # so a bound relative to each leaf would measure rounding noise)
    leaves = _leaves(JTP.shard_params(grads, mesh), "grad")
    scale = max(float(np.abs(np.asarray(a)).max()) for a in leaves.values())
    for path, arr in leaves.items():
        for shard in arr.addressable_shards:
            r = ranks[world][_rank_of(mesh, shard.device)]
            err = np.abs(r[path] - np.asarray(shard.data)).max()
            assert err <= 1e-5 * scale, (path, err, scale)


def _jax_wire_psum(x, ef, spec):
    mesh = _mesh({"model": 2})
    if ef is None:
        f = _shard_map(lambda a: JTP.wire_psum(a[0], "model", spec)[0],
                       mesh, in_specs=(P("model"),), out_specs=P())
        return np.asarray(jax.jit(f)(x)), None

    def body(a, e):
        v, new = JTP.wire_psum(a[0], "model", spec, ef=e[0])
        return v, new[None]

    f = _shard_map(body, mesh, in_specs=(P("model"), P("model")),
                   out_specs=(P(), P("model")))
    v, new = jax.jit(f)(x, ef)
    return np.asarray(v), np.asarray(new)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", ["f32", "int8"])
def test_gradient_psum_and_wire_psum_match_jax(ranks, world, label):
    inp = PW.tp_inputs()
    spec = None if label == "f32" else JW.WireSpec(*PW.WIRE)
    jobs.reset()
    want = JTP.gradient_psum({"w": jnp.asarray(inp["g_w"]),
                              "b": jnp.asarray(inp["g_b"])},
                             _mesh({"model": 2}), axis="model", wire=spec)
    counters = _collectives()
    ef = None
    if spec is not None:
        padded, _ = JW.psum_layout(inp["x"][0].size, spec, 2)
        ef = jnp.zeros((2, 2, padded // 2), jnp.float32)
    v, new_ef = _jax_wire_psum(jnp.asarray(inp["x"]), ef, spec)
    for rank, r in enumerate(ranks[world]):
        for k in ("w", "b"):
            np.testing.assert_allclose(r[f"gpsum_{label}/{k}"],
                                       np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(r[f"wpsum_{label}"], v, rtol=1e-6,
                                   atol=1e-6)
        if new_ef is not None:
            np.testing.assert_allclose(r[f"wpsum_{label}_ef"],
                                       new_ef[rank % 2], rtol=1e-6,
                                       atol=1e-6)
        assert json.loads(str(r[f"c_gpsum_{label}"])) == counters
    if spec is not None:
        # the wire is lossy, and its bytes are fewer
        assert not np.allclose(v, inp["x"].sum(0), atol=1e-6)
        assert counters["bigdl_collective_wire_savings_ratio|tp"] > 3.0


@pytest.mark.parametrize("world", [2, 4])
def test_constrain_counts_what_jax_counts(ranks, world):
    inp = PW.tp_inputs()
    mesh = _mesh(SHAPES[world])
    data = "data" if world == 4 else None
    jobs.reset()
    with mesh:
        jax.jit(lambda a: JTP.constrain(a, mesh, None, None, "model"))(
            jnp.asarray(inp["act"]))
        jax.jit(lambda a: JTP.constrain(a, mesh, data))(
            jnp.asarray(inp["act"]))
    want = _collectives()
    assert want
    for r in ranks[world]:
        assert json.loads(str(r["c_constrain"])) == want


def test_gradient_psum_refuses_leaves_that_differ_across_ranks(ranks):
    for r in ranks[2] + ranks[4]:
        assert "same shapes on every 'model' rank (2)" in str(
            r["shape_error"])
