"""«py»/optim/optimizer.py shim — Optimizer, optim methods, triggers,
summaries under their Python-BigDL names.

Python-BigDL spells triggers as constructors (``MaxEpoch(n)``,
``EveryEpoch()``); the core Trigger factory provides them.
``Optimizer`` takes ``device=`` (the card by default).
"""

from bigdl_tpu_torch.optim import (  # noqa: F401
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    Ftrl,
    LBFGS,
    LarsSGD,
    LocalOptimizer,
    Loss,
    Optimizer,
    RMSprop,
    SGD,
    Top1Accuracy,
    Top5Accuracy,
    Trigger,
)
from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer  # noqa: F401
from bigdl_tpu_torch.optim.optim_method import (  # noqa: F401
    Default,
    EpochDecay,
    Exponential,
    MultiStep,
    Plateau,
    Poly,
    SequentialSchedule,
    Step,
    Warmup,
)
from bigdl_tpu_torch.visualization import (  # noqa: F401
    TrainSummary,
    ValidationSummary,
)


# Python-BigDL trigger spellings are plain constructors
def MaxEpoch(n):  # noqa: N802 - reference spelling
    return Trigger.max_epoch(n)


def MaxIteration(n):  # noqa: N802
    return Trigger.max_iteration(n)


def EveryEpoch():  # noqa: N802
    return Trigger.every_epoch()


def SeveralIteration(n):  # noqa: N802
    return Trigger.several_iteration(n)


def MinLoss(v):  # noqa: N802
    return Trigger.min_loss(v)


def MaxScore(v):  # noqa: N802
    return Trigger.max_score(v)


def TriggerAnd(*ts):  # noqa: N802
    return Trigger.and_(*ts)


def TriggerOr(*ts):  # noqa: N802
    return Trigger.or_(*ts)
