"""Training of the port (counterpart of ``bigdl_tpu.optim``)."""

from bigdl_tpu_torch.optim.evaluator import (Evaluator, LocalValidator,
                                             Predictor, Validator,
                                             evaluate_dataset, predict,
                                             predict_class, predict_image)
from bigdl_tpu_torch.optim.optim_method import (
    LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, Default, EpochDecay,
    Exponential, Ftrl, LarsSGD, MultiStep, OptimMethod, Plateau, Poly,
    RMSprop, SequentialSchedule, Step, Warmup)
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer)
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer,
                                             NonFiniteStepError, Optimizer)
from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (MAE, NDCG, HitRatio, Loss,
                                              Top1Accuracy, Top5Accuracy,
                                              TreeNNAccuracy,
                                              ValidationMethod,
                                              ValidationResult)

# the JAX package's ``__all__``, in its order, then the port's extras
__all__ = [
    "OptimMethod", "SGD", "Adam", "Adagrad", "Adadelta", "Adamax", "RMSprop",
    "Ftrl", "LBFGS", "LarsSGD",
    "Default", "Poly", "Step", "MultiStep", "Exponential", "EpochDecay",
    "Warmup", "SequentialSchedule", "Plateau",
    "L1Regularizer", "L2Regularizer", "L1L2Regularizer",
    "Trigger",
    "ValidationMethod", "ValidationResult", "Top1Accuracy", "Top5Accuracy",
    "Loss", "MAE", "TreeNNAccuracy", "HitRatio", "NDCG",
    "Optimizer", "LocalOptimizer", "DistriOptimizer", "Metrics",
    "Evaluator", "Predictor", "Validator", "LocalValidator",
    "NonFiniteStepError", "evaluate_dataset", "predict", "predict_class",
    "predict_image",
]
