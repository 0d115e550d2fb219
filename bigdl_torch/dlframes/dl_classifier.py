"""⟦«py»/dlframes/dl_classifier.py⟧ — DLEstimator/DLClassifier/DLModel."""
from bigdl_tpu_torch.dlframes.dl_estimator import (  # noqa: F401
    DLClassifier,
    DLClassifierModel,
    DLEstimator,
    DLModel,
)
