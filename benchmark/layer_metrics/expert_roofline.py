"""The held experts' grouped GEMMs in training (``parallel/moe.py``
``_RoutedExperts``: two products forward, four backward, a layer): the
sum of the bounds of the work the counted assignments need over the
device time of the grouped-GEMM kernels in the profiled stretch.

The work is read from the program's counter, not from the kernels: the
held assignments of each MoE layer and expert over the profiled steps
(``MoEStats``, kept by the adapter as ``STATS``), n a layer and step.
Each of the six products reads its inputs once and writes its output
once, the weights (d x 2F and F x d) of the G experts that took tokens
among them (an expert with no rows is not read): 18·n·d·F FLOPs a layer
and step in all; the rows a group is padded by are not counted.
Whatever runs the GEMMs, the same work is counted."""

from benchmark import roofline

# the kernels of torch._grouped_mm on the card: CUTLASS's grouped GEMM
# (its problem shape is cutlass::gemm::GroupProblemShape) and the small
# kernel that lays out its per-group arguments
GEMMS = r"GroupProblemShape|prepare_grouped_gemm"


def products(n: float, d: int, f: int, g: int):
    """(elements moved, FLOPs) of each product of a layer and step at n
    held assignments."""
    return [(n * d + g * d * 2 * f + n * 2 * f, 2.0 * n * d * 2 * f),
            (n * f + g * f * d + n * d, 2.0 * n * f * d),
            (n * d + g * f * d + n * f, 2.0 * n * d * f),
            (n * f + n * d + g * f * d, 2.0 * n * f * d),
            (n * 2 * f + g * d * 2 * f + n * d, 2.0 * n * 2 * f * d),
            (n * d + n * 2 * f + g * d * 2 * f, 2.0 * n * d * 2 * f)]


def read(run):
    p = run.profile
    stats = getattr(run.family, "STATS", None)
    if p is None or stats is None:
        return None
    seconds = p.kernel_seconds(GEMMS)
    loads = stats.loads.cpu()          # (MoE layers, held experts)
    if seconds <= 0 or not int(loads.sum()):
        return None
    cfg = run.config
    steps = run.record["profile_steps"]
    item = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    bound = sum(steps * roofline.bound_s(elems * item, flops,
                                         cfg["compute_dtype"])[0]
                for layer in loads
                for elems, flops in products(int(layer.sum()) / steps, d, f,
                                             int((layer > 0).sum())))
    return 100.0 * bound / seconds
