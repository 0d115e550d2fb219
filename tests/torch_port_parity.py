"""Helpers of the port's parity tests: one module of each package on the
same weights and inputs, forward and gradients compared.

Inputs and outputs may be tables: nested tuples of arrays.  The JAX
side runs eagerly (``jax.vjp`` of ``apply``, no jit), the port's
forward and ``backward`` on the CPU; errors are relative to the largest
|JAX value| of each tensor."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

TOL = 1e-5


def tmap(fn, t):
    """``fn`` over the leaves of a nested tuple (a leaf alone too)."""
    if isinstance(t, (tuple, list)):
        return tuple(tmap(fn, u) for u in t)
    return fn(t)


def tleaves(t) -> list:
    if isinstance(t, (tuple, list)):
        return [leaf for u in t for leaf in tleaves(u)]
    return [t]


def to_np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def rel(got, want) -> float:
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want), initial=0.0)) / max(
        float(np.max(np.abs(want), initial=0.0)), 1e-30)


def carry(jm, tm) -> None:
    """The JAX module's parameters and state into the port's."""
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    load_jax_state(tm, jax.tree.map(np.asarray, jm.state()))


def _torch_input(x):
    x = np.asarray(x)
    return torch.tensor(x, requires_grad=x.dtype.kind == "f")


def check_module(jm, tm, xs, seed=0, training=False, exact=False,
                 jit=False):
    """Forward, input gradients and parameter gradients of one module,
    JAX against port, under a random cotangent on every output leaf;
    ``exact`` compares the outputs bit for bit (integer-valued ones);
    ``jit`` traces the JAX side once instead of dispatching it op by op
    (quicker for a module of many small ops).  Returns the JAX module's
    new state."""
    params, state = jm.params(), jm.state()
    jxs = tmap(jnp.asarray, xs)

    def f(p, x):
        return jm.apply(p, state, x, training=training)

    if jit:
        f = jax.jit(f)

    y, vjp, new_state = jax.vjp(f, params, jxs, has_aux=True)
    rs = np.random.RandomState(seed + 100)
    cots = [rs.randn(*np.shape(a)).astype(np.float32) for a in tleaves(y)]
    gp, gx = vjp(jax.tree.unflatten(jax.tree.structure(y),
                                    [jnp.asarray(c) for c in cots]))

    txs = tmap(_torch_input, xs)
    ty = tm(txs)
    touts = tleaves(ty)
    assert len(touts) == len(cots)
    for got, want in zip(touts, tleaves(y)):
        if exact:
            np.testing.assert_array_equal(to_np(got), np.asarray(want))
        else:
            assert rel(got, want) <= TOL, "forward"
    loss = sum((t * torch.from_numpy(c)).sum() for t, c in zip(touts, cots)
               if t.requires_grad)
    if isinstance(loss, torch.Tensor):
        loss.backward()
    for a, b in zip(tleaves(txs), jax.tree.leaves(gx)):
        g = a.grad if a.grad is not None else torch.zeros(a.shape)
        assert rel(g, b) <= TOL, "input gradient"
    by_id = {id(p): p for p in tm.parameters()}
    pairs = T.leaves_with_paths(tm.params())
    jleaves = jax.tree.leaves(gp)
    assert len(pairs) == len(jleaves)
    for (path, p), b in zip(pairs, jleaves):
        g = by_id[id(p)].grad
        g = g if g is not None else torch.zeros(p.shape)
        assert rel(g, b) <= TOL, f"gradient of {path}"
    return new_state


def check_loss(jc, tc, inp, target):
    """A criterion's loss and its input gradient, JAX against port."""
    jin, jt = tmap(jnp.asarray, inp), tmap(jnp.asarray, target)
    want, gwant = jax.value_and_grad(lambda x: jc.loss(x, jt))(jin)
    tin = tmap(_torch_input, inp)
    got = tc.loss(tin, tmap(torch.as_tensor, target))
    assert rel(got, want) <= TOL, "loss"
    got.backward()
    for a, b in zip(tleaves(tin), jax.tree.leaves(gwant)):
        if a.requires_grad:
            g = a.grad if a.grad is not None else torch.zeros(a.shape)
            assert rel(g, b) <= TOL, "input gradient"
    return float(got.detach())


def randomize_params(jm, tm, seed=5) -> None:
    """Both modules onto the same uniform(-1, 1) parameters, off their
    constant initial values (ones, zeros)."""
    rs = np.random.RandomState(seed)
    tree = jax.tree.map(
        lambda v: rs.uniform(-1.0, 1.0, np.shape(v)).astype(np.float32),
        jm.params())
    jm.set_params(jax.tree.map(jnp.asarray, tree))
    load_jax_params(tm, tree)


def assert_trees_equal(t_tree, j_tree) -> None:
    """A port tree and a JAX tree: the same paths, bit-equal leaves."""
    tp = T.leaves_with_paths(t_tree)
    jp = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert len(tp) == len(jp)
    for (path, a), (jpath, b) in zip(tp, jp):
        assert "/".join(path) == "/".join(str(k.key) for k in jpath)
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


def check_spec_and_files(jm, tm, directory) -> None:
    """One module in both packages: the same spec, each package's spec
    rebuilt by both, and its ``.npz`` and ``.bigdl`` files loaded by the
    other package with the same parameters and state."""
    import os

    from bigdl_tpu.utils import serializer as JS
    from bigdl_tpu_torch.utils import serializer as TS

    spec = TS.module_to_spec(tm)
    assert spec == JS.module_to_spec(jm)
    assert TS.module_to_spec(TS.spec_to_module(spec)) == spec
    assert JS.module_to_spec(JS.spec_to_module(spec)) == spec
    for ext in ("", ".bigdl"):
        jpath = JS.save_module(jm, os.path.join(directory, "j" + ext))
        t_from_j = TS.load_module(jpath)
        assert type(t_from_j).__name__ == type(tm).__name__
        assert_trees_equal(t_from_j.params(), jm.params())
        tpath = TS.save_module(tm, os.path.join(directory, "t" + ext))
        j_from_t = JS.load_module(tpath)
        assert type(j_from_t).__name__ == type(jm).__name__
        assert_trees_equal(tm.params(), j_from_t.params())
        if not ext:
            assert TS.module_to_spec(t_from_j) == spec
            assert_trees_equal(t_from_j.state(), jm.state())
