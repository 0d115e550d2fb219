"""The whole step's share of the chip's peak: the model's FLOPs from its
shapes (``reference/<family>.py``) over the plain window, against the
published peak of the configuration's compute type (``roofline``)."""

from benchmark import roofline


def read(run):
    flops = run.reference.model_flops(run.config, run.cell["traffic"],
                                      run.record)
    if not flops or run.device.type != "cuda":
        return None
    peak = roofline.PEAK_FLOPS[run.config["compute_dtype"]]
    return 100.0 * flops / run.record["window_s"] / peak
