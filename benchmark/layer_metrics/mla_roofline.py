"""Rows 1-3 at (D_qk, D_v) = (192, 128), latent attention in training
(``ops/attention.py``: ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``
of the (192, 128) instantiation): the sum of their launches' bounds over
the sum of their device time in the profiled stretch; each step launches
each once a layer over (batch x heads) causal rows.

Bytes as ``roofline.py`` counts them, each input read once and each
output written once; FLOPs a kept (query, key) pair and head: forward
2(Dqk + Dv), dq 2(2Dqk + Dv), dkv 4(Dqk + Dv).  At Dqk = Dv they are
rows 1-3's 4D, 6D and 8D."""

from benchmark import roofline


def flash_fwd(bh, t, dqk, dv, item):
    """q, k read (Dqk), v read and o written (Dv), the f32 lse written."""
    return (bh * t * (2 * dqk + 2 * dv) * item + bh * t * 4,
            2.0 * (dqk + dv) * bh * roofline.causal_pairs(t))


def flash_bwd_dq(bh, t, dqk, dv, item):
    """q, k read and dq written (Dqk), g and v read (Dv), lse and δ
    read."""
    return (bh * t * (3 * dqk + 2 * dv) * item + 2 * bh * t * 4,
            2.0 * (2 * dqk + dv) * bh * roofline.causal_pairs(t))


def flash_bwd_dkv(bh, t, dqk, dv, item):
    """q, k read and dk written (Dqk), g, v read and dv written (Dv),
    lse and δ read."""
    return (bh * t * (3 * dqk + 3 * dv) * item + 2 * bh * t * 4,
            4.0 * (dqk + dv) * bh * roofline.causal_pairs(t))


KERNELS = {r"flash_fwd_bf16_kernel<192, 128>": flash_fwd,
           r"flash_bwd_dq_bf16_kernel<192, 128>": flash_bwd_dq,
           r"flash_bwd_dkv_bf16_kernel<192, 128>": flash_bwd_dkv}


def read(run):
    p = run.profile
    if p is None or run.config["family"] != "deepseek_v3":
        return None
    cfg, mix = run.config, run.cell["traffic"]
    launches = cfg["num_hidden_layers"] * run.record["profile_steps"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    item = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    bound = seconds = 0.0
    for name, count in KERNELS.items():
        if p.kernel_count(name) != launches:
            return None
        bound += launches * roofline.bound_s(
            *count(mix["batch"] * cfg["num_attention_heads"], mix["seq"],
                   dqk, cfg["v_head_dim"], item), cfg["compute_dtype"])[0]
        seconds += p.kernel_seconds(name)
    return 100.0 * bound / seconds
