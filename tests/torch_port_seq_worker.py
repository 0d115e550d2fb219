"""One rank of the port's sequence parallelism for
``tests/test_torch_port_seq_parallel.py`` (not a test module itself):

    python tests/torch_port_seq_worker.py RANK WORLD STORE OUT CASE

joins a gloo world of WORLD processes over the ``FileStore`` STORE,
adopted by the port's ``Engine``, runs CASE and writes what it made
to the npz OUT.  CASE is "attn" (ring and Ulysses attention, their
gradients, the int8 ring, both modules, the heads error), "compose"
(ring attention over a {"data": 2, "seq": 2} mesh at world 4) or
"lm" (the long-context example, ``TINY_LM``).  Every input comes from
``inputs()``, made from seed 0 with numpy.  Imports neither JAX nor
the JAX package.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from bigdl_tpu_torch.engine import Engine  # noqa: E402

B, H, T, D = 2, 4, 16, 8          # the attention operands
DIM, HEADS = 16, 4                # the modules
TINY_LM = ["--seq", "64", "--dim", "32", "--heads", "4", "--layers", "2",
           "--vocab", "64", "--steps", "3"]


def inputs() -> dict:
    """The global operands every rank slices its block from."""
    rs = np.random.RandomState(0)
    f = np.float32
    return {
        "q": rs.randn(B, H, T, D).astype(f),
        "k": rs.randn(B, H, T, D).astype(f),
        "v": rs.randn(B, H, T, D).astype(f),
        "ct": rs.randn(B, H, T, D).astype(f),
        "x": rs.randn(B, T, DIM).astype(f),
        "wq": (rs.randn(DIM, DIM) * 0.3).astype(f),
        "wk": (rs.randn(DIM, DIM) * 0.3).astype(f),
        "wv": (rs.randn(DIM, DIM) * 0.3).astype(f),
        "wo": (rs.randn(DIM, DIM) * 0.3).astype(f),
        "bq": (rs.randn(DIM) * 0.1).astype(f),
        "bk": (rs.randn(DIM) * 0.1).astype(f),
        "bv": (rs.randn(DIM) * 0.1).astype(f),
        "bo": (rs.randn(DIM) * 0.1).astype(f),
    }


def _block(a, axis, idx, n):
    t = a.shape[axis] // n
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, range(idx * t, (idx + 1) * t), axis=axis)))


def _attn_case(fn, inp, idx, n, res, name, **kw):
    """``fn`` on this rank's blocks: the output block and the gradient of
    sum(out · ct) over every rank's blocks with respect to this rank's
    q, k and v blocks."""
    q, k, v = (_block(inp[c], 2, idx, n).requires_grad_(True)
               for c in "qkv")
    out = fn(q, k, v, **kw)
    (out * _block(inp["ct"], 2, idx, n)).sum().backward()
    res[name] = out.detach().numpy()
    for c, t in zip("qkv", (q, k, v)):
        res[f"{name}_d{c}"] = t.grad.numpy()


def _module_case(cls, mesh, inp, idx, n, res, name):
    """The module on this rank's (B, T/n, DIM) block: its output and
    the parameter gradients of sum(out²) summed over the ranks."""
    m = cls(DIM, HEADS, mesh, seq_axis="seq", causal=True)
    m.set_params({w: torch.from_numpy(inp[w]) for w in
                  ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")})
    out = m(_block(inp["x"], 1, idx, n))
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(out.square().sum(), params)
    res[name] = out.detach().numpy()
    for w, g in zip(names, grads):
        dist.all_reduce(g)
        res[f"{name}_g_{w}"] = g.numpy()
    res[f"{name}_repr"] = np.array(repr(m))


def run(rank, world, store, out, case):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    Engine.init("cpu")
    from bigdl_tpu_torch.parallel import (RingMultiHeadAttention,
                                          UlyssesMultiHeadAttention,
                                          ring_attention_sharded,
                                          ulysses_attention,
                                          ulysses_attention_sharded)

    inp = inputs()
    res = {}
    if case == "attn":
        mesh = Engine.build_mesh({"seq": world})
        idx, n = mesh.index("seq"), world
        for causal in (False, True):
            _attn_case(ring_attention_sharded, inp, idx, n, res,
                       f"ring_c{int(causal)}", mesh=mesh, causal=causal)
            _attn_case(ulysses_attention_sharded, inp, idx, n, res,
                       f"ulysses_c{int(causal)}", mesh=mesh, causal=causal)
        _attn_case(ring_attention_sharded, inp, idx, n, res, "ring_int8",
                   mesh=mesh, causal=True, wire="int8")
        _module_case(RingMultiHeadAttention, mesh, inp, idx, n, res,
                     "ring_mha")
        _module_case(UlyssesMultiHeadAttention, mesh, inp, idx, n, res,
                     "ulysses_mha")
        q3 = torch.zeros(1, 3, 4, 8)
        try:
            ulysses_attention(q3, q3, q3, mesh.group("seq"))
            res["heads_error"] = np.array("")
        except ValueError as e:
            res["heads_error"] = np.array(str(e))
    elif case == "compose":
        mesh = Engine.build_mesh({"data": 2, "seq": world // 2})
        bi, si, n = mesh.index("data"), mesh.index("seq"), world // 2

        def blk(a):
            return _block(np.ascontiguousarray(
                np.take(a, [bi], axis=0)), 2, si, n)

        o = ring_attention_sharded(blk(inp["q"]), blk(inp["k"]),
                                   blk(inp["v"]), mesh, seq_axis="seq",
                                   batch_axis="data", causal=True)
        res["compose"] = o.numpy()
        res["coords"] = np.array([bi, si])
    elif case == "lm":
        from bigdl_tpu_torch.common import RandomGenerator
        from bigdl_tpu_torch.examples import train_long_lm

        RandomGenerator.RNG.set_seed(1)
        hist = {}
        train_long_lm.main(TINY_LM, device="cpu", history=hist)
        res["losses"] = np.array(hist["losses"])
        for name, p in hist["model"].named_parameters():
            res[f"p_{name}"] = p.detach().numpy()
    np.savez(out, **res)
    Engine.reset()
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5])
