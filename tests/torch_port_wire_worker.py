"""One rank of the port's compressed collectives for
``tests/test_torch_port_wire.py`` (not a test module itself):

    python tests/torch_port_wire_worker.py RANK WORLD STORE OUT

joins a gloo world of WORLD processes over the ``FileStore`` STORE,
runs every case of ``CASES`` on this rank's rows of ``inputs(WORLD)``
and writes each output to the npz OUT.  Imports neither JAX nor the
JAX package.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from bigdl_tpu_torch.parallel import wire as W  # noqa: E402

BLOCK = 16
# (case, wire dtype, error feedback)
RING_CASES = [("rs_int8", "int8", False), ("rs_fp8", "fp8_e4m3", False),
              ("rs_int8_ef", "int8", True), ("rs_bf16_ef", "bfloat16", True)]


def inputs(world: int) -> dict:
    """Every rank's operands, stacked on a leading world axis, from
    seed 0: two rounds of ring operands (magnitudes over six decades,
    a zero block), a (3, 7) psum operand, all_to_all operands of (2n, 6)
    and (2n, 3), a ppermute operand and cotangents."""
    rs = np.random.RandomState(0)
    chunk = 3 * BLOCK
    n = world

    def ring():
        g = rs.randn(n, n * chunk) * np.exp(rs.randn(n, n * chunk) * 2)
        g[:, :BLOCK] = 0.0
        return g.astype(np.float32)

    return {
        "g1": ring(), "g2": ring(),
        "x_psum": rs.randn(n, 3, 7).astype(np.float32),
        "x_a2a": rs.randn(n, 2 * n, 6).astype(np.float32),
        "x_a2a_t": rs.randn(n, 2 * n, 3).astype(np.float32),
        "ct_a2a": rs.randn(n, 2 * n, 6).astype(np.float32),
        "x_pp": rs.randn(n, 5, 8).astype(np.float32),
        "ct_pp": rs.randn(n, 5, 8).astype(np.float32),
    }


def run(rank, world, store, out):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    inp = {k: torch.from_numpy(v[rank]) for k, v in inputs(world).items()}
    res = {}
    n = world
    for case, dtype, ef_on in RING_CASES:
        spec = W.WireSpec(dtype, BLOCK, ef_on)
        ef = torch.zeros(n, inp["g1"].numel() // n) if ef_on else None
        c1, ef = W.reduce_scatter(inp["g1"], None, n, spec, ef=ef)
        c2, ef2 = W.reduce_scatter(inp["g2"], None, n, spec, ef=ef)
        res[case + "_c1"], res[case + "_c2"] = c1.numpy(), c2.numpy()
        if ef_on:
            res[case + "_ef1"], res[case + "_ef2"] = ef.numpy(), ef2.numpy()
    int8 = W.WireSpec("int8", BLOCK)
    res["psum_int8"] = W.psum(inp["x_psum"], None, n, int8)[0].numpy()
    res["psum_plain"] = W.psum(inp["x_psum"], None, n, None)[0].numpy()
    for name, spec in (("int8", int8), ("fp8", W.WireSpec("fp8_e5m2", 4)),
                       ("bf16", W.WireSpec("bfloat16")), ("plain", None)):
        x = inp["x_a2a"].clone().requires_grad_(True)
        y = W.all_to_all(x, None, n, spec, split_axis=0, concat_axis=0)
        (y * inp["ct_a2a"]).sum().backward()
        res[f"a2a_{name}"], res[f"a2a_{name}_grad"] = (y.detach().numpy(),
                                                       x.grad.numpy())
    res["a2a_int8_t"] = W.all_to_all(inp["x_a2a_t"], None, n, int8,
                                     split_axis=0, concat_axis=1).numpy()
    perm = [(j, (j + 1) % n) for j in range(n)]
    for name, spec in (("int8", int8), ("plain", None)):
        x = inp["x_pp"].clone().requires_grad_(True)
        y = W.ppermute(x, None, perm, spec)
        (y * inp["ct_pp"]).sum().backward()
        res[f"pp_{name}"], res[f"pp_{name}_grad"] = (y.detach().numpy(),
                                                     x.grad.numpy())
    # a partial permutation: ranks nobody sends to get zeros
    res["pp_partial"] = W.ppermute(inp["x_pp"], None, [(0, 1)],
                                   int8).numpy()
    np.savez(out, **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
