"""One rank of the port's tensor parallelism, TP-sharded decode, pipeline
and expert parallelism for ``tests/test_torch_port_tensor_parallel.py``,
``tests/test_torch_port_tp_decode.py`` and
``tests/test_torch_port_pipeline_moe.py`` (not a test module itself):

    python tests/torch_port_parallel_worker.py RANK WORLD STORE OUT CASE WEIGHTS

joins a gloo world of WORLD processes over the ``FileStore`` STORE,
adopted by the port's ``Engine``, runs CASE and writes what it made to
the npz OUT.  WEIGHTS is an npz of JAX parameter trees, one key per
leaf (``<model>/<path>``), written by the test; they go into the port's
models through ``utils/convert``.  CASE is "tp" (``shard_params``, the
TP forward and its gradients, ``gradient_psum``, ``wire_psum`` and
``constrain`` over ``{"model": 2}`` at world 2 and ``{"data": 2,
"model": 2}`` at world 4), "decode" (``LMEngine(tp=WORLD)``: tokens with
the dense and fused decode, the int8 wire, the errors, and at world 2
a swap, a drain and the step logits beside ``tp=1``) or "pipe_moe"
(``pipelined`` over WORLD stages and ``MoE`` over WORLD expert ranks,
with the compressed wires).  The other inputs come from numpy seeds
here.  Imports neither JAX nor the JAX package.
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from bigdl_tpu_torch import obs  # noqa: E402
from bigdl_tpu_torch.engine import Engine  # noqa: E402

TP_LM = dict(dim=32, n_head=4, n_layer=2, max_len=16)      # vocab 64
SERVE_LM = dict(dim=32, n_head=4, n_layer=2, max_len=64)   # vocab 48
MOE_CASES = [  # name, top_k, capacity_factor, wire (dtype, block) or None
    ("top1", 1, 4.0, None), ("top2", 2, 4.0, None),
    ("drop", 2, 0.5, None), ("int8", 2, 4.0, ("int8", 32)),
    ("fp8", 2, 4.0, ("fp8_e4m3", 32))]
WIRE = ("int8", 16)                # gradient_psum / wire_psum's scaled wire
PIPE_M, PIPE_MB, PIPE_D = 6, 3, 8


def save_weights(path: str, **trees) -> str:
    """JAX parameter trees (numpy leaves) as one npz, ``<name>/<path>``
    keys, for the workers."""
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            elif v is not None:
                out[f"{prefix}/{k}"] = np.asarray(v)

    for name, t in trees.items():
        walk(t, name)
    np.savez(path, **out)
    return path


def launch(tmp, world: int, case: str, weights: str) -> list:
    """Run CASE at WORLD in as many processes; each rank's npz as a
    dict."""
    import subprocess

    tmp = str(tmp)
    store = os.path.join(tmp, f"store_{case}{world}")
    outs = [os.path.join(tmp, f"{case}{world}_{r}.npz")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         store, outs[r], case, weights], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


def tp_inputs() -> dict:
    rs = np.random.RandomState(0)
    f = np.float32
    return {"tokens": rs.randint(0, 64, (4, 16)).astype(np.int32),
            "ct": rs.randn(4, 16, 64).astype(f),
            # each "model" rank's gradient contribution, stacked
            "g_w": rs.randn(2, 24, 20).astype(f),
            "g_b": rs.randn(2, 20).astype(f),
            "x": rs.randn(2, 3, 40).astype(f),
            "act": rs.randn(4, 16, 32).astype(f)}


def serve_prompts():
    """The prompts of ``tests/test_serving.py:191-201``."""
    rs = np.random.RandomState(3)
    return rs.randint(0, 48, (5,)), rs.randint(0, 48, (9,))


def pipe_inputs(n: int) -> dict:
    rs = np.random.RandomState(0)
    f = np.float32
    return {"w": (rs.randn(n, PIPE_D, PIPE_D) * 0.5).astype(f),
            "b": (rs.randn(n, PIPE_D) * 0.1).astype(f),
            "x": rs.randn(PIPE_M, PIPE_MB, PIPE_D).astype(f)}


def moe_input():
    return np.random.RandomState(0).randn(2, 16, 8).astype(np.float32)


def tree(weights, model: str) -> dict:
    out: dict = {}
    for key, v in weights.items():
        name, *path = key.split("/")
        if name != model:
            continue
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = v
    return out


def flat(t, prefix: str, res: dict) -> None:
    for k, v in t.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}/{k}", res)
        elif v is not None:
            res[f"{prefix}/{k}"] = v.detach().numpy()


def collectives() -> str:
    """The collective byte counters and savings gauges, as JSON."""
    out = {}
    for fam in obs.get_registry().families():
        if fam.name in ("bigdl_collective_bytes_total",
                        "bigdl_collective_wire_savings_ratio"):
            for key, child in fam.child_items():
                out["|".join((fam.name,) + key)] = child.value
    return json.dumps(out)


def _lm(weights, name, vocab, cfg):
    from bigdl_tpu_torch.models.transformer import build_transformer_lm
    from bigdl_tpu_torch.utils.convert import load_jax_params

    m = build_transformer_lm(vocab, attn_impl="reference", device="cpu",
                             **cfg)
    load_jax_params(m, tree(weights, name))
    return m


def case_tp(world, weights, res):
    from bigdl_tpu_torch.parallel import (constrain, gradient_psum,
                                          shard_params, wire_psum)
    from bigdl_tpu_torch.parallel import wire as W
    from bigdl_tpu_torch.parallel.tensor_parallel import (_tree_map,
                                                          tp_lm_forward)

    shape = {"model": 2} if world == 2 else {"data": 2, "model": 2}
    mesh = Engine.build_mesh(shape)
    model = _lm(weights, "tp", 64, TP_LM)
    inp = tp_inputs()
    obs.reset()
    local = shard_params(model.params(), mesh)
    res["c_shard"] = collectives()
    flat(local, "local", res)
    nd = shape.get("data", 1)
    di = mesh.index("data") if nd > 1 else 0
    rows = slice(di * 4 // nd, (di + 1) * 4 // nd)
    leaves = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       local)
    out = tp_lm_forward(model, leaves, torch.from_numpy(inp["tokens"][rows]),
                        mesh)
    (out * torch.from_numpy(inp["ct"][rows])).sum().backward()
    res["logits"] = out.detach().numpy()
    grads = _tree_map(lambda t: t.grad, leaves)
    if nd > 1:
        grads = gradient_psum(grads, mesh, axis="data")
    flat(grads, "grad", res)

    mi = mesh.index("model")
    group = mesh.group("model")
    contrib = {"w": torch.from_numpy(inp["g_w"][mi]),
               "b": torch.from_numpy(inp["g_b"][mi])}
    x = torch.from_numpy(inp["x"][mi])
    for label, spec in (("f32", None), ("int8", W.WireSpec(*WIRE))):
        obs.reset()
        summed = gradient_psum(contrib, mesh, axis="model", wire=spec)
        res[f"c_gpsum_{label}"] = collectives()
        flat(summed, f"gpsum_{label}", res)
        ef = None
        if spec is not None:
            padded, _ = W.psum_layout(x.numel(), spec, 2)
            ef = torch.zeros((2, padded // 2))
        v, new_ef = wire_psum(x, group, spec, ef=ef)
        res[f"wpsum_{label}"] = v.numpy()
        if new_ef is not None:
            res[f"wpsum_{label}_ef"] = new_ef.numpy()
    try:
        gradient_psum({"w": torch.zeros(3 + mi, 4)}, mesh, axis="model")
        res["shape_error"] = np.array("")
    except ValueError as e:
        res["shape_error"] = np.array(str(e))
    obs.reset()
    constrain(torch.from_numpy(inp["act"]), mesh, None, None, "model")
    constrain(torch.from_numpy(inp["act"]), mesh, "data" if nd > 1 else None)
    res["c_constrain"] = collectives()


def _drive(eng, leader, script):
    """The leader runs ``script(eng)`` and closes; a follower follows
    until that close."""
    if leader:
        try:
            return script(eng)
        finally:
            eng.close()
    eng.follow()
    eng.close()
    return None


def _tokens(prompt, req):
    return [int(t) for t in list(prompt) + req.tokens]


def case_decode(world, weights, res):
    import bigdl_tpu_torch.serving.engine as E
    from bigdl_tpu_torch.serving import LMEngine

    mesh = Engine.build_mesh({"model": world})
    leader = mesh.index("model") == 0
    p1, p2 = serve_prompts()

    def engine(tp=world, **kw):
        return LMEngine(_lm(weights, "serve", 48, SERVE_LM), max_batch=2,
                        page_size=8, tp=tp, device="cpu", **kw)

    def two(eng):
        r1, r2 = eng.submit(p1, 6), eng.submit(p2, 3)
        eng.run_until_idle(120)
        return _tokens(p1, r1) + [-1] + _tokens(p2, r2)

    for attn in ("dense", "fused"):
        toks = _drive(engine(decode_attn=attn), leader, two)
        if leader:
            res[f"tokens_{attn}"] = np.array(toks)

    obs.reset()
    eng = engine(wire="int8")
    res["c_int8"] = collectives()

    def short(eng):
        r = eng.submit([5, 6, 7], 6)
        eng.run_until_idle(120)
        return r.tokens

    toks = _drive(eng, leader, short)
    if leader:
        res["tokens_int8"] = np.array(toks)

    for key, kw in (("exclusive", dict(int8=True)), ("divide", dict(tp=3))):
        try:
            engine(**kw)
            res[f"error_{key}"] = np.array("")
        except ValueError as e:
            res[f"error_{key}"] = np.array(str(e))
    if world != 2:
        return

    # a swap the leader flips between two steps; the same at tp=1
    rs = np.random.RandomState(7)
    new = {k: (v + 0.05 * rs.randn(*v.shape)).astype(np.float32)
           for k, v in weights.items() if k.startswith("serve/")}
    new_tree = tree(new, "serve")

    def swap(eng):
        r1 = eng.submit(p1, 10)
        for _ in range(3):
            eng.pump()
        eng.swap_weights(new_tree, version="v1")
        r2 = eng.submit(p2, 6)
        eng.run_until_idle(120)
        st = eng.stats()
        return (_tokens(p1, r1) + [-1] + _tokens(p2, r2)
                + [-2, st["weight_swaps"]])

    def drain(eng):
        eng.submit(p1, 12)
        eng.submit(p2, 12)
        eng.pump()
        eng.pump()
        return json.dumps([r.to_dict() for r in eng.drain(deadline_s=0.0)])

    for name, script in (("swap", swap), ("drain", drain)):
        eng = engine()
        if not leader and name == "swap":
            eng.swap_weights(new_tree, version="v1")   # staged
        got = _drive(eng, leader, script)
        if leader:
            res[f"{name}_tp"] = np.array(got)
            res[f"{name}_tp1"] = np.array(_drive(engine(tp=1), True,
                                                 script))

    # every logit row the engine samples from, at tp=2 and at tp=1
    seen = []
    pick = E._pick

    def recording(logits, temps, generator):
        seen.append(logits.detach().clone())
        return pick(logits, temps, generator)

    E._pick = recording
    try:
        def one(eng):
            r = eng.submit(p2, 6)
            eng.run_until_idle(120)
            return r.tokens

        got = _drive(engine(), leader, one)
        if leader:
            n = len(seen)
            res["logit_tokens_tp"] = np.array(got)
            res["logit_tokens_tp1"] = np.array(_drive(engine(tp=1), True, one))
            res["logits_tp"] = torch.cat(seen[:n]).numpy()
            res["logits_tp1"] = torch.cat(seen[n:]).numpy()
    finally:
        E._pick = pick


def case_pipe_moe(world, weights, res):
    from bigdl_tpu_torch.parallel import MoE, WireSpec, pipelined
    from bigdl_tpu_torch.utils.convert import load_jax_params

    mesh = Engine.build_mesh({"pipe": world})
    inp = pipe_inputs(world)
    stacked = {k: torch.from_numpy(inp[k]).requires_grad_(True)
               for k in ("w", "b")}
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    run = pipelined(lambda p, a: torch.tanh(a @ p["w"] + p["b"]), mesh,
                    "pipe")
    obs.reset()
    out = run(stacked, x)
    res["c_pipe"] = collectives()
    out.square().sum().backward()
    res["pipe_out"] = out.detach().numpy()
    res["pipe_gw"] = stacked["w"].grad.numpy()
    res["pipe_gb"] = stacked["b"].grad.numpy()
    res["pipe_gx"] = x.grad.numpy()

    mesh = Engine.build_mesh({"expert": world})
    for name, k, cf, wire in MOE_CASES:
        m = MoE(8, 16, 4, top_k=k, capacity_factor=cf, mesh=mesh,
                wire=None if wire is None else WireSpec(*wire))
        load_jax_params(m, tree(weights, "moe"))
        xm = torch.from_numpy(moe_input()).requires_grad_(True)
        obs.reset()
        y, aux = m.forward_with_aux(xm)
        res[f"c_moe_{name}"] = collectives()
        names, params = zip(*m.named_parameters())
        grads = torch.autograd.grad(y.square().sum() + aux,
                                    (xm,) + params)
        res[f"moe_{name}_y"] = y.detach().numpy()
        res[f"moe_{name}_aux"] = aux.detach().numpy()
        res[f"moe_{name}_gx"] = grads[0].numpy()
        for n, g in zip(names, grads[1:]):
            res[f"moe_{name}_g_{n}"] = g.numpy()


def run(rank, world, store, out, case, weights_path):
    # the ranks share the machine's cores: one thread each keeps a rank
    # waiting in a collective from being starved by another's threads
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    Engine.init("cpu")
    weights = dict(np.load(weights_path))
    res = {}
    {"tp": case_tp, "decode": case_decode,
     "pipe_moe": case_pipe_moe}[case](world, weights, res)
    np.savez(out, **res)
    Engine.reset()
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6])
