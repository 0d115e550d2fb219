"""The port's compressed wire (``bigdl_tpu_torch/parallel/wire.py``)
and byte model (``obs/collectives.py``) against the JAX package's.

- ``quantize``/``dequantize``: payloads and scales bit-equal to JAX's
  for the four wire dtypes at blocks 1, 64 and 512, on an odd length
  with zeros, subnormals, values near ``qmax`` and six decades of
  magnitude; the int8 error at most each block's ``amax / 254``.
- The planners and the byte counts equal to JAX's; ``roundtrip``'s
  gradient equal to JAX's ``custom_vjp``.
- The collectives at worlds 2 and 4 (one gloo run of
  ``tests/torch_port_wire_worker.py`` each) against JAX's
  ``shard_map`` over a 2- and 4-device CPU mesh: the staged ring's
  chunks and EF rows over two rounds within 1e-6 of the round's largest
  reduced value, as are the scaled data moves (``all_to_all``, ``ppermute``, their
  gradients, ``psum``): under ``jit`` XLA computes a scale ``amax /
  qmax`` as ``amax * (1 / qmax)``, one ulp from the division the eager
  JAX function and the port do (the eager payloads and scales are
  bit-equal above), and may fuse ``payload * scale + chunk`` into one
  FMA.  The unscaled moves (bf16, plain) are bit-equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.obs import collectives as JC
from bigdl_tpu.optim.distri_optimizer import _shard_map
from bigdl_tpu.parallel import wire as JW
from bigdl_tpu_torch.obs import collectives as TC
from bigdl_tpu_torch.parallel import wire as TW

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_wire_worker as WW  # noqa: E402

RING_TOL = 1e-6
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_wire_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"]


def _bits(a) -> np.ndarray:
    """An array's bytes as unsigned integers of its width (NaN-safe
    bit equality for every wire dtype)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.uint8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy().reshape(-1)
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[
        a.dtype.itemsize]).reshape(-1).astype(
        {1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _operand(dtype: str) -> np.ndarray:
    rs = np.random.RandomState(3)
    n = 1037
    x = (rs.randn(n) * np.exp(rs.randn(n) * 3)).astype(np.float32)
    x[:70] = 0.0
    x[70:80] = 1e-40                            # f32 subnormals
    x[80:90] = -3e-39
    qmax = JW.WIRE_DTYPES[dtype][1] or 1.0
    x[90:100] = qmax * np.linspace(0.99, 1.01, 10)
    x[100:110] = -x[90:100]
    return x


@pytest.mark.parametrize("block", [1, 64, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_bit_equal_to_jax(dtype, block):
    x = _operand(dtype)
    js, ts = JW.WireSpec(dtype, block), TW.WireSpec(dtype, block)
    jp, jsc = JW.quantize(jnp.asarray(x), js)
    tp, tsc = TW.quantize(torch.from_numpy(x), ts)
    assert tp.dtype == {"bfloat16": torch.bfloat16, "int8": torch.int8,
                        "fp8_e4m3": torch.float8_e4m3fn,
                        "fp8_e5m2": torch.float8_e5m2}[dtype]
    assert tuple(tp.shape) == tuple(jp.shape)
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    if dtype == "bfloat16":
        assert jsc is None and tsc is None
    else:
        np.testing.assert_array_equal(_bits(tsc), _bits(jsc))
    jd = JW.dequantize(jp, jsc, js, shape=x.shape)
    td = TW.dequantize(tp, tsc, ts, shape=x.shape)
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    if dtype == "int8":
        # each element within its block's amax / 254
        xb = np.concatenate([x, np.zeros((-x.size) % block, np.float32)])
        amax = np.abs(xb.reshape(-1, block)).max(axis=1)
        err = np.abs(td.numpy() - x)
        lim = np.repeat(amax / 254.0, block)[:x.size]
        assert np.all(err <= lim * (1 + 1e-6) + 1e-38)


def test_spec_and_padding_match_jax():
    for dtype in DTYPES + ["float32", "none"]:
        for ef in (False, True):
            for block, shards, elems in ((512, 2, 1037), (16, 4, 135),
                                         (1, 3, 10)):
                try:
                    js = JW.WireSpec(dtype, block, ef)
                except ValueError as e:
                    with pytest.raises(ValueError, match="error feedback"):
                        TW.WireSpec(dtype, block, ef)
                    assert "error feedback" in str(e)
                    continue
                ts = TW.WireSpec(dtype, block, ef)
                for attr in ("compressed", "scaled", "wire_name", "qmax"):
                    assert getattr(ts, attr) == getattr(js, attr), attr
                assert TW.padded_elems(elems, ts, shards) == \
                    JW.padded_elems(elems, js, shards)
                assert (TW.resolve(ts) is None) == (JW.resolve(js) is None)
    with pytest.raises(ValueError, match="not supported"):
        TW.WireSpec("fp16")


def test_bucket_planners_match_jax():
    rs = np.random.RandomState(0)
    for _ in range(50):
        n = int(rs.randint(1, 9))
        quantum = n * int(rs.choice([1, 8, 16]))
        padded = quantum * int(rs.randint(1, 40))
        target = int(rs.choice([0, -1, 1, quantum - 1, quantum * 3 + 1,
                                padded * 2]))
        jb = JW.plan_buckets(padded, quantum, target)
        tb = TW.plan_buckets(padded, quantum, target)
        assert tb == jb
        np.testing.assert_array_equal(TW.bucket_param_coords(tb, n),
                                      JW.bucket_param_coords(jb, n))
        for other in (None, [[0, padded]], [list(b) for b in jb], jb[:1]):
            assert TW.buckets_equal(tb, other) == JW.buckets_equal(jb, other)
    with pytest.raises(ValueError, match="alignment quantum"):
        TW.plan_buckets(10, 4, 0)


def test_byte_model_matches_jax():
    for n in (1, 2, 4, 8):
        for dt, tdt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16), ("int8", torch.int8)):
            for f in ("all_reduce_bytes", "reduce_scatter_bytes",
                      "all_gather_bytes", "all_to_all_bytes"):
                assert getattr(TC, f)(1000, tdt, n) == \
                    getattr(JC, f)(1000, dt, n)
            assert TC.ppermute_bytes(1000, tdt, n) == \
                JC.ppermute_bytes(1000, dt, n)
        for name in ("int8", "float8_e4m3fn", "float8_e5m2", "bfloat16"):
            assert TC.staged_ring_exchange_bytes(4096 * n, n, 512, name) \
                == JC.staged_ring_exchange_bytes(4096 * n, n, 512, name)
        assert TC.int8_blockwise_exchange_bytes(4096 * n, n, 512) == \
            JC.int8_blockwise_exchange_bytes(4096 * n, n, 512)
        assert TC.fp8_blockwise_exchange_bytes(4096 * n, n, 512) == \
            JC.fp8_blockwise_exchange_bytes(4096 * n, n, 512)
    assert TC.dtype_bytes(torch.float8_e4m3fn) == 1
    for spec in (TW.WireSpec("int8", 16), TW.WireSpec("bfloat16")):
        js = JW.WireSpec(spec.dtype, spec.block)
        assert TW.psum_layout(21, spec, 4) == JW.psum_layout(21, js, 4)
    assert TW.effective_block(30, 16) == JW.effective_block(30, 16) == 15


@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip_gradient_matches_custom_vjp(dtype):
    x = _operand(dtype)[:300] * 0.01
    ct = np.random.RandomState(4).randn(300).astype(np.float32)
    js, ts = JW.WireSpec(dtype, 64), TW.WireSpec(dtype, 64)
    jy, vjp = jax.vjp(lambda v: JW.roundtrip(v, js) * v, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(ct))
    t = torch.from_numpy(x).requires_grad_(True)
    ty = TW.roundtrip(t, ts) * t
    (ty * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(_bits(ty.detach()), _bits(jy))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-30)
    assert TW.roundtrip(t, "float32") is t


# ---- the collectives over gloo against shard_map ---------------------------
def _run_world(tmp_path, world):
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), store, outs[r]],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    return n, _run_world(tmp_path_factory.mktemp(f"w{n}"), n)


def _smap(f, n, n_in, n_out):
    mesh = JEngine.build_mesh({"d": n}, devices=jax.devices()[:n])
    spec = P("d")

    def local(*args):
        outs = f(*[a[0] for a in args])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return tuple(o[None] for o in outs)

    return jax.jit(_shard_map(local, mesh, in_specs=(spec,) * n_in,
                              out_specs=(spec,) * n_out))


def _ring_close(got, want, what, of=None):
    """Within 1e-6 of the largest value of ``of`` (default ``want``):
    an EF row is held to its round's chunk."""
    scale = max(float(np.abs(want if of is None else of).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= RING_TOL * scale, f"{what}: {err:.3e} > 1e-6 x {scale:.3e}"


def _move_equal(got, want, spec, what):
    """Bit-equal for an unscaled wire; within 1e-6 of the largest value
    for a scaled one (the jitted scale's ulp)."""
    if spec is not None and spec.scaled:
        _ring_close(got, want, what)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=what)


def test_staged_ring_matches_shard_map(world):
    n, res = world
    inp = WW.inputs(n)
    for case, dtype, ef_on in WW.RING_CASES:
        spec = JW.WireSpec(dtype, WW.BLOCK, ef_on)

        def two_rounds(g1, g2, ef0):
            c1, ef1 = JW.reduce_scatter(g1, "d", n, spec,
                                        ef=ef0 if ef_on else None)
            c2, ef2 = JW.reduce_scatter(g2, "d", n, spec,
                                        ef=ef1 if ef_on else None)
            if not ef_on:
                ef1 = ef2 = jnp.zeros_like(ef0)
            return c1, c2, ef1, ef2

        ef0 = np.zeros((n, n, inp["g1"].shape[1] // n), np.float32)
        c1, c2, ef1, ef2 = _smap(two_rounds, n, 3, 4)(
            inp["g1"], inp["g2"], ef0)
        for r in range(n):
            _ring_close(res[r][case + "_c1"], c1[r], f"{case} chunk 1 r{r}")
            _ring_close(res[r][case + "_c2"], c2[r], f"{case} chunk 2 r{r}")
            if ef_on:
                _ring_close(res[r][case + "_ef1"], ef1[r], f"{case} ef 1",
                            of=c1[r])
                _ring_close(res[r][case + "_ef2"], ef2[r], f"{case} ef 2",
                            of=c2[r])
                # the own chunk's row stays zero; the others carry error
                assert not np.any(res[r][case + "_ef2"][r])
                assert np.abs(res[r][case + "_ef2"]).max() > 0
        # every rank's chunk is the sum within the wire's error
        full = inp["g1"].sum(axis=0).reshape(n, -1)
        for r in range(n):
            assert np.abs(res[r][case + "_c1"] - full[r]).max() <= \
                0.05 * np.abs(full).max()


def test_psum_matches_shard_map(world):
    n, res = world
    x = WW.inputs(n)["x_psum"]
    spec = JW.WireSpec("int8", WW.BLOCK)
    (want,) = _smap(lambda v: JW.psum(v, "d", n, spec)[0], n, 1, 1)(x)
    (plain,) = _smap(lambda v: JW.psum(v, "d", n, None)[0], n, 1, 1)(x)
    for r in range(n):
        _ring_close(res[r]["psum_int8"], want[r], "psum int8")
        np.testing.assert_allclose(res[r]["psum_plain"], plain[r],
                                   rtol=1e-6)
    # the owners' shards are exchanged quantized: every rank reads the
    # same sum bit for bit
    for r in range(1, n):
        np.testing.assert_array_equal(res[r]["psum_int8"],
                                      res[0]["psum_int8"])


def test_data_moves_and_gradients_bit_equal_to_shard_map(world):
    n, res = world
    inp = WW.inputs(n)
    specs = {"int8": JW.WireSpec("int8", WW.BLOCK),
             "fp8": JW.WireSpec("fp8_e5m2", 4),
             "bf16": JW.WireSpec("bfloat16"), "plain": None}
    for name, spec in specs.items():
        def a2a(x, ct, spec=spec):
            def f(v):
                return JW.all_to_all(v, "d", n, spec, split_axis=0,
                                     concat_axis=0)
            y, vjp = jax.vjp(f, x)
            return y, vjp(ct)[0]

        y, g = _smap(a2a, n, 2, 2)(inp["x_a2a"], inp["ct_a2a"])
        for r in range(n):
            _move_equal(res[r][f"a2a_{name}"], y[r], spec, name)
            _move_equal(res[r][f"a2a_{name}_grad"], g[r], spec, name)
    (yt,) = _smap(lambda v: JW.all_to_all(v, "d", n, specs["int8"],
                                          split_axis=0, concat_axis=1),
                  n, 1, 1)(inp["x_a2a_t"])
    for r in range(n):
        _move_equal(res[r]["a2a_int8_t"], yt[r], specs["int8"], "a2a_t")
    perm = [(j, (j + 1) % n) for j in range(n)]
    for name in ("int8", "plain"):
        spec = specs[name]

        def pp(x, ct, spec=spec):
            y, vjp = jax.vjp(lambda v: JW.ppermute(v, "d", perm, spec), x)
            return y, vjp(ct)[0]

        y, g = _smap(pp, n, 2, 2)(inp["x_pp"], inp["ct_pp"])
        for r in range(n):
            _move_equal(res[r][f"pp_{name}"], y[r], spec, name)
            _move_equal(res[r][f"pp_{name}_grad"], g[r], spec, name)
    (yp,) = _smap(lambda v: JW.ppermute(v, "d", [(0, 1)], specs["int8"]),
                  n, 1, 1)(inp["x_pp"])
    for r in range(n):
        _move_equal(res[r]["pp_partial"], yp[r], specs["int8"], "partial")
    assert not np.any(res[0]["pp_partial"])     # nobody sends to rank 0
