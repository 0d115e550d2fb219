"""Training of the port (counterpart of ``bigdl_tpu.optim``)."""

from bigdl_tpu_torch.optim.evaluator import (Evaluator, LocalValidator,
                                             Predictor, Validator,
                                             evaluate_dataset, predict,
                                             predict_class)
from bigdl_tpu_torch.optim.optim_method import (SGD, Default, MultiStep,
                                                OptimMethod, Plateau, Poly,
                                                SequentialSchedule, Warmup)
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer,
                                             NonFiniteStepError, Optimizer)
from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (MAE, Loss, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)

__all__ = ["SGD", "Default", "MultiStep", "OptimMethod", "Plateau", "Poly",
           "SequentialSchedule", "Warmup", "LocalOptimizer",
           "DistriOptimizer",
           "NonFiniteStepError", "Optimizer", "Trigger", "Evaluator",
           "LocalValidator", "Predictor", "Validator", "evaluate_dataset",
           "predict", "predict_class", "MAE", "Loss", "Top1Accuracy",
           "Top5Accuracy", "ValidationMethod", "ValidationResult"]
