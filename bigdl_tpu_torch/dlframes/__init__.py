"""DataFrame ML-pipeline API of the port (counterpart of
``bigdl_tpu.dlframes``): DLEstimator / DLClassifier / DLModel."""

from bigdl_tpu_torch.dlframes.dl_estimator import (DLClassifier,
                                                   DLClassifierModel,
                                                   DLEstimator, DLModel)

__all__ = ["DLEstimator", "DLClassifier", "DLModel", "DLClassifierModel"]
