"""The DeepSeek-V3-style model (``models/deepseek_v3.py``): multi-head
latent attention (``nn/mla.py``), the flash kernels' plain versions at
D_qk != D_v (``ops/attention.py``) and the dropless, sigmoid-routed MoE
(``parallel/moe.py`` ``SigmoidMoE``), against ``plain_deepseek_v3.py``
on seeded weights at a small size on the CPU:

- the model's logits, loss and every parameter's gradient, with the
  attention on the flash path and on the reference path;
- the plain flash forward, dq and dkv at (D_qk, D_v) = (24, 16) against
  the gradient of the plain attention;
- selection on score + bias with gates from the unbiased scores,
  normalised over the chosen and scaled; the dispatch plan's groups;
- two held shares of 4 experts of 8 whose outputs, the shared expert
  counted once, add up to the uncut layer;
- one bf16 ``LocalOptimizer`` Adam step: the bias buffers unchanged, the
  routers' weights in f32 in the forward;
- the ``moe.*`` regions and the held-expert counters, recorded only
  while a profiler records.

Marked ``cuda`` (skips without a card): the (192, 128) kernels and every
(D, D) instantiation against the plain versions, and the MoE layer's
forward and backward under ``torch.cuda.set_sync_debug_mode("error")``.
Run them on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_deepseek_v3.py``.
"""

import math

import numpy as np
import pytest
import torch

import plain_deepseek_v3 as P
from bigdl_tpu_torch.ops import attention as A
from bigdl_tpu_torch.parallel.moe import (GROUP_ROWS, MOE_REGIONS,
                                          SigmoidMoE, dispatch_plan)

CFG = {"hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
       "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
       "intermediate_size": 96, "moe_intermediate_size": 24,
       "router_experts": 8, "n_routed_experts": 8, "first_held_expert": 0,
       "num_experts_per_tok": 3, "n_shared_experts": 1,
       "routed_scaling_factor": 2.446, "first_k_dense_replace": 1,
       "num_hidden_layers": 3, "vocab_size": 128, "rope_theta": 50000.0,
       "rms_norm_eps": 1e-5, "kv_norm_eps": 1e-6}
T = 32


def build(cfg=CFG, attn_impl="kernel", seed=0, first=None, count=None,
          device="cpu"):
    from bigdl_tpu_torch.models.deepseek_v3 import DeepseekV3LM

    return DeepseekV3LM(
        cfg["vocab_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
        cfg["first_k_dense_replace"], cfg["num_attention_heads"],
        cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
        cfg["kv_lora_rank"], cfg["intermediate_size"],
        cfg["moe_intermediate_size"], cfg["router_experts"],
        cfg["num_experts_per_tok"], cfg["n_shared_experts"],
        cfg["routed_scaling_factor"],
        cfg["first_held_expert"] if first is None else first,
        cfg["n_routed_experts"] if count is None else count,
        cfg["rope_theta"], cfg["rms_norm_eps"], cfg["kv_norm_eps"],
        std=0.1, attn_impl=attn_impl, seed=seed, device=device)


def set_biases(model, seed=1, std=0.1):
    """Draw each MoE layer's selection bias; returns {layer: bias}."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i in range(model.n_layer):
        mlp = model.child(f"h{i}").mlp
        if isinstance(mlp, SigmoidMoE):
            with torch.no_grad():
                mlp.router.bias.copy_(torch.randn(
                    mlp.router.bias.shape, generator=gen) * std)
            out[i] = mlp.router.bias.detach().clone()
    return out


def batch(seed=0, rows=2):
    rs = np.random.RandomState(seed)
    ids = torch.from_numpy(rs.randint(0, CFG["vocab_size"], (rows, T + 1)))
    return ids[:, :T], ids[:, 1:]


def _close(a, b, rel=1e-4):
    scale = float(b.abs().max()) or 1.0
    torch.testing.assert_close(a, b, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("attn_impl", ["kernel", "reference"])
def test_model_logits_loss_and_gradients_match_the_plain_reference(
        attn_impl):
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion

    model = build(attn_impl=attn_impl)
    biases = set_biases(model)
    w = {n: p.detach().clone() for n, p in model.named_parameters()}
    x, y = batch()
    logits = model(x)
    loss = CrossEntropyCriterion().loss(logits, y + 1)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref_logits = P.forward(w, x, CFG, biases)
    _close(logits.detach(), ref_logits)
    ref_loss, ref_grads = P.grads(w, x, y, CFG, biases)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    assert sorted(names) == sorted(ref_grads)
    for n, g in zip(names, grads):
        _close(g, ref_grads[n], rel=2e-4)


@pytest.mark.parametrize("causal,tq,tk,offset", [(True, 80, 80, 0),
                                                 (False, 72, 136, 0),
                                                 (True, 40, 104, 64)])
def test_plain_flash_at_unequal_widths_matches_plain_attention(
        causal, tq, tk, offset):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(3, tq, 24, generator=gen)
    k = torch.randn(3, tk, 24, generator=gen)
    v = torch.randn(3, tk, 16, generator=gen)
    g = torch.randn(3, tq, 16, generator=gen)
    scale = 1.0 / math.sqrt(24)
    out, lse = A.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                       seq_offset=offset)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = A._reference_attention(*leaves, causal=causal, scale=scale,
                                 seq_offset=offset)
    assert out.shape == (3, tq, 16)
    _close(out, ref.detach())
    dq, dk, dv = torch.autograd.grad(ref, leaves, g)
    delta = (g * out).sum(-1)
    _close(A.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal,
                                scale=scale, seq_offset=offset), dq)
    pk, pv = A.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                   scale=scale, seq_offset=offset)
    _close(pk, dk)
    _close(pv, dv)
    # the autograd path of flash_attention, (B, H, T, D) in and out
    q4, k4, v4 = (t.clone().view(1, 3, -1, t.shape[-1]).requires_grad_(True)
                  for t in (q, k, v))
    o4 = A.flash_attention(q4, k4, v4, causal=causal, scale=scale,
                           seq_offset=offset)
    assert o4.shape == (1, 3, tq, 16)
    for a, b in zip(torch.autograd.grad(o4, (q4, k4, v4), g.view(1, 3, tq,
                                                                 16)),
                    (dq, dk, dv)):
        _close(a.view(b.shape), b)


def test_the_kernels_take_unequal_widths_in_bf16_only():
    q = torch.zeros(1, 64, 192)
    v = torch.zeros(1, 64, 128)
    A._check_kernel_args(q.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="bf16 only"):
        A._check_kernel_args(q, v)
    with pytest.raises(ValueError, match="take"):
        A._check_kernel_args(q[..., :96].bfloat16(), v.bfloat16())


def _moe_layer(first=0, count=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return SigmoidMoE(CFG["hidden_size"], CFG["moe_intermediate_size"],
                      CFG["router_experts"], CFG["num_experts_per_tok"],
                      CFG["n_shared_experts"], CFG["routed_scaling_factor"],
                      first, count, 0.1, gen)


def _moe_weights(layer, prefix="h1."):
    return {prefix + "mlp." + n: p.detach() for n, p in
            layer.named_parameters()}


def test_selection_is_on_score_plus_bias_and_gates_on_the_score():
    layer = _moe_layer()
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(64, CFG["hidden_size"], generator=gen)
    s = torch.sigmoid(x @ layer.router.weight.detach().t())
    # a bias that favours the experts the scores rank lowest
    bias = (-s.mean(0)).argsort().argsort().float() * -0.2
    with torch.no_grad():
        layer.router.bias.copy_(bias)
        idx, w = layer.route(x)
    k = CFG["num_experts_per_tok"]
    assert torch.equal(idx.sort(-1).values,
                       torch.topk(s + bias, k, -1).indices.sort(-1).values)
    assert not torch.equal(idx.sort(-1).values,
                           torch.topk(s, k, -1).indices.sort(-1).values)
    chosen = s.gather(1, idx)
    _close(w, chosen / chosen.sum(-1, keepdim=True)
           * CFG["routed_scaling_factor"])
    ref_idx, ref_w = P.route(x, layer.router.weight.detach(), bias, CFG)
    assert torch.equal(idx, ref_idx)
    _close(w, ref_w)


def test_dispatch_plan_groups_every_held_assignment_once():
    gen = torch.Generator().manual_seed(4)
    idx = torch.stack([torch.randperm(16, generator=gen)[:3]
                       for _ in range(50)])
    src, pos, offs, loads = dispatch_plan(idx, 4, 6)
    held = (idx >= 4) & (idx < 10)
    assert int(loads.sum()) == int(held.sum())
    assert torch.equal(loads, torch.bincount(idx[held] - 4, minlength=6))
    assert all(int(o) % GROUP_ROWS == 0 for o in offs)
    m = src.shape[0]
    assert m == idx.numel() + GROUP_ROWS * 6
    ends = offs.long().tolist()
    starts = [0] + ends[:-1]
    for t, j in zip(*torch.nonzero(held, as_tuple=True)):
        row = int(pos[t, j])
        e = int(idx[t, j]) - 4
        assert starts[e] <= row < ends[e] and int(src[row]) == int(t)
    assert bool((pos[~held] == m).all())
    used = {int(r) for r in pos[held]}
    assert all(int(src[r]) == 50 for r in range(m) if r not in used)


def test_two_held_shares_add_up_to_the_uncut_layer():
    whole = _moe_layer(0, 8, seed=3)
    halves = [_moe_layer(0, 4, seed=3), _moe_layer(4, 4, seed=3)]
    bias = torch.randn(8, generator=torch.Generator().manual_seed(6)) * 0.1
    with torch.no_grad():
        for part in halves:
            part.router.weight.copy_(whole.router.weight)
            part.shared.w_gate_up.copy_(whole.shared.w_gate_up)
            part.shared.w_down.copy_(whole.shared.w_down)
        halves[0].experts.w_gate_up.copy_(whole.experts.w_gate_up[:4])
        halves[0].experts.w_down.copy_(whole.experts.w_down[:4])
        halves[1].experts.w_gate_up.copy_(whole.experts.w_gate_up[4:])
        halves[1].experts.w_down.copy_(whole.experts.w_down[4:])
        for m in (whole, *halves):
            m.router.bias.copy_(bias)
    x = torch.randn(2, T, CFG["hidden_size"],
                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        shared = whole.shared(x)
        parts = [m(x) for m in halves]
        uncut = P.moe(x, _moe_weights(whole), "h1.", bias, CFG)
    _close(parts[0] + parts[1] - shared, uncut)
    _close(whole(x).detach(), uncut)
    # each share is the plain layer's own experts plus the shared one
    cfg4 = dict(CFG, n_routed_experts=4)
    for first, m in zip((0, 4), halves):
        w = _moe_weights(m)
        _close(parts[first // 4], P.moe(x, w, "h1.", bias,
                                        dict(cfg4, first_held_expert=first)))


def test_bf16_local_optimizer_step_keeps_the_bias_and_the_f32_router():
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger

    model = build()
    set_biases(model)
    bias = {n: b.clone() for n, b in model.named_buffers()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = []
    real_route = SigmoidMoE.route

    def route(self, x):
        seen.append((x.dtype, self.router.weight.dtype))
        return real_route(self, x)

    x, y = batch(rows=4)
    opt = LocalOptimizer(model, ArrayDataSet(x.numpy().astype(np.int32),
                                             (y + 1).numpy().astype(np.int32),
                                             4, shuffle=False),
                         CrossEntropyCriterion(), batch_size=4, device="cpu")
    opt.set_optim_method(Adam(learningrate=3e-4))
    opt.set_compute_dtype("bfloat16")
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_end_when(Trigger.max_iteration(1))
    SigmoidMoE.route = route
    try:
        opt.optimize()
    finally:
        SigmoidMoE.route = real_route
    assert seen and all(d == (torch.bfloat16, torch.float32) for d in seen)
    for n, b in model.named_buffers():
        assert torch.equal(b, bias[n]), n
    assert opt.state["nonfinite_skips"] == 0
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert sorted(moved) == sorted(before)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_moe_regions_and_counters_are_recorded_only_while_profiling():
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.obs.metrics import MetricsRegistry
    from bigdl_tpu_torch.obs import names

    model = build()
    set_biases(model)
    x, _ = batch()
    model(x)
    stats = model.moe_stats
    assert int(stats.loads.sum()) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
        model(x)
    events = {e.name for e in prof.events()}
    assert set(MOE_REGIONS) <= events
    read = stats.read()
    # two forwards, every held assignment of each MoE layer counted
    held = []
    with torch.no_grad():
        h = model.embed(x)
    for i in range(model.n_layer):
        layer = model.child(f"h{i}")
        if isinstance(layer.mlp, SigmoidMoE):
            with torch.no_grad():
                hn = layer.mlp_norm(h + layer.attn(layer.attn_norm(h)))
                idx, _ = layer.mlp.route(hn.reshape(-1, CFG["hidden_size"]))
            held.append(2 * idx.numel())
        with torch.no_grad():
            h = layer(h)
    assert read["held"] == held
    assert all(r >= 1.0 for r in read["max_over_mean"])
    reg = MetricsRegistry()
    stats.publish(reg)
    snap = reg.snapshot()["metrics"]
    assert [int(x["value"]) for x in sorted(
        snap[names.MOE_HELD_ASSIGNMENTS_TOTAL]["samples"],
        key=lambda x: int(x["labels"]["layer"]))] == held
    assert len(snap[names.MOE_MAX_LOAD_RATIO]["samples"]) == len(held)


# ------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; on the card: python -m pytest "
                    "--noconftest -m cuda "
                    "tests/test_torch_port_deepseek_v3.py")
    P.no_tf32()
    yield torch.device("cuda")
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dims", A.HEAD_DIM_PAIRS)
@pytest.mark.parametrize("case", [(True, 640, 640, 0), (False, 200, 328, 0),
                                  (True, 256, 512, 256)])
def test_bf16_kernels_match_the_plain_versions(dims, case, card):
    causal, tq, tk, offset = case
    d, dv = dims
    gen = torch.Generator(device=card).manual_seed(11)

    def make(t, width):
        return torch.randn(4, t, width, generator=gen, device=card) \
            .bfloat16()

    q, k, v, g = make(tq, d), make(tk, d), make(tk, dv), make(tq, dv)
    scale = 1.0 / math.sqrt(d)
    out, lse = A._flash_forward(q, k, v, causal=causal, scale=scale,
                                with_lse=True, seq_offset=offset)
    ref, ref_lse = A.flash_attention_plain(q, k, v, causal=causal,
                                           scale=scale, seq_offset=offset)
    torch.cuda.synchronize()
    # one bf16 rounding of O apart (the kernel's and the plain version's
    # f32 sums differ in order)
    _close(out.float(), ref.float(), rel=1e-2)
    _close(lse, ref_lse, rel=1e-5)
    dq, dk, dvv = A.flash_backward(q, k, v, out, lse, g, causal=causal,
                                   scale=scale, seq_offset=offset)
    delta = (g.float() * out.float()).sum(-1)
    rq = A.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal,
                              scale=scale, seq_offset=offset)
    rk, rv = A.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                   scale=scale, seq_offset=offset)
    torch.cuda.synchronize()
    for a, b in ((dq, rq), (dk, rk), (dvv, rv)):
        assert a.shape == b.shape
        _close(a.float(), b.float(), rel=1e-2)


@pytest.mark.cuda
def test_moe_layer_makes_no_host_sync_on_the_card(card):
    gen = torch.Generator(device=card).manual_seed(0)
    layer = SigmoidMoE(256, 128, 64, 6, 2, 2.446, 8, 8, 0.05, gen)
    layer.to(card)
    x = torch.randn(2, 512, 256, device=card, generator=gen) \
        .bfloat16().requires_grad_(True)
    params = {n: p.bfloat16() if not getattr(p, "keep_f32", False) else p
              for n, p in layer.named_parameters()}
    torch.func.functional_call(layer, params, (x,)).float().sum()  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = torch.func.functional_call(layer, params, (x,))
        grads = torch.autograd.grad(out.float().square().mean(),
                                    [x] + list(params.values()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    w = {"h1.mlp." + n: p.detach().float() for n, p in
         layer.named_parameters()}
    cfg = dict(CFG, hidden_size=256, router_experts=64,
               num_experts_per_tok=6, n_shared_experts=2,
               n_routed_experts=8, first_held_expert=8)
    ref = P.moe(x.detach().float().cpu(), {k: v.cpu() for k, v in w.items()},
                "h1.", layer.router.bias.cpu(), cfg)
    _close(out.detach().float().cpu(), ref, rel=3e-2)
