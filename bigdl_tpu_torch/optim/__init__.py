"""Training of the port (counterpart of ``bigdl_tpu.optim``)."""

from bigdl_tpu_torch.optim.optim_method import (SGD, Default, MultiStep,
                                                OptimMethod,
                                                SequentialSchedule, Warmup)
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer, NonFiniteStepError
from bigdl_tpu_torch.optim.triggers import Trigger

__all__ = ["SGD", "Default", "MultiStep", "OptimMethod", "SequentialSchedule",
           "Warmup", "LocalOptimizer", "NonFiniteStepError", "Trigger"]
