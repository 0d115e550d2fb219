"""Rows 1-3 in training (``ops/attention.py``: ``flash_fwd``,
``flash_bwd_dq``, ``flash_bwd_dkv``): the sum of their launches' bounds
over the sum of their device time in the profiled stretch; each step
launches each kernel once a layer over (batch x heads) causal rows."""

from benchmark import roofline

KERNELS = {"flash_fwd_": roofline.flash_fwd,
           "flash_bwd_dq_": roofline.flash_bwd_dq,
           "flash_bwd_dkv_": roofline.flash_bwd_dkv}


def read(run):
    p = run.profile
    if p is None or run.config["family"] != "gpt2":
        return None
    cfg, mix = run.config, run.cell["traffic"]
    steps = run.record["profile_steps"]
    bh = mix["batch"] * cfg["n_head"]
    d = cfg["n_embd"] // cfg["n_head"]
    item = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    bound = seconds = 0.0
    for name, count in KERNELS.items():
        launches = cfg["n_layer"] * steps
        if p.kernel_count(name) != launches:
            return None
        bound += launches * roofline.bound_s(
            *count(bh, mix["seq"], d, item), cfg["compute_dtype"])[0]
        seconds += p.kernel_seconds(name)
    return 100.0 * bound / seconds
