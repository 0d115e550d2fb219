"""Rows 4-5 (``ops/conv_bn.py``: ``conv_bn_1x1``, ``conv_bn_kxk``, the
kxk layout pass and the statistics' second pass): the sum of their
launches' bounds over the sum of their device time in the profiled
stretch.  Each step launches one kernel a fused 1x1 or 3x3 site."""

from benchmark import roofline

KERNELS = r"conv_bn_(1x1|kxk)_|to_nhwc_kernel|stats_reduce_kernel"


def read(run):
    p = run.profile
    if p is None or run.config["family"] != "resnet":
        return None
    cfg, mix = run.config, run.cell["traffic"]
    sites = [s for s in run.reference.convs(cfg)
             if s[3] in cfg["fuse_kernels"]]
    steps = run.record["profile_steps"]
    if p.kernel_count(r"conv_bn_(1x1|kxk)_") != len(sites) * steps:
        return None
    item = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    per_step = sum(roofline.bound_s(*roofline.conv_bn(
        mix["batch"], c, size, size, o, k, stride, item),
        cfg["compute_dtype"])[0] for _, c, o, k, stride, size in sites)
    return 100.0 * per_step * steps / p.kernel_seconds(KERNELS)
