"""TensorBoard summaries of the port (counterpart of
``bigdl_tpu.visualization``): ``TrainSummary`` (loss, throughput, the
resilience counters, parameter histograms) and ``ValidationSummary``
as TensorBoard event files, each read back by its ``read_scalar`` and
``read_histogram``."""

from bigdl_tpu_torch.visualization.summary import (FileWriter, TrainSummary,
                                                   ValidationSummary)

__all__ = ["FileWriter", "TrainSummary", "ValidationSummary"]
