"""«py»/util/common.py shim — engine bootstrap + data containers.

The reference's file bootstraps the Py4J gateway (``JavaCreator``,
``callBigDlFunc``) and converts numpy <-> JTensor.  Here there is no
JVM: ``init_engine`` initialises the port's ``Engine`` (on the card
unless ``device="cpu"``), ``create_spark_conf`` returns a plain dict of
the conf the reference would require, and ``JTensor``/``Sample`` wrap
numpy directly.
"""

from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample  # noqa: F401
from bigdl_tpu_torch.engine import Engine


def init_engine(bigdl_type: str = "float", device="cuda"):
    """Reference: ``init_engine()`` -> ``Engine.init``."""
    Engine.init(device=device)


def init_executor_gateway(sc=None):  # pragma: no cover - spark-only shim
    """No JVM gateway exists; kept for import compatibility."""


def create_spark_conf():
    """Reference: Engine.createSparkConf — returns the required conf as
    a dict (usable as ``SparkConf().setAll(conf.items())`` when pyspark
    is present)."""
    return {
        "spark.shuffle.reduceLocality.enabled": "false",
        "spark.scheduler.minRegisteredResourcesRatio": "1.0",
        "spark.speculation": "false",
    }


def get_node_and_core_number(device="cuda"):
    """(processes, devices a process) of the port's world: one GPU a
    process."""
    if not Engine.is_initialized():
        Engine.init(device=device)
    return Engine.node_number(), 1


class JTensor:
    """numpy carrier (reference: JTensor ndarray<->Tensor bridge)."""

    def __init__(self, storage, shape, bigdl_type="float"):
        self.storage = np.asarray(storage, np.float32)
        self.shape = tuple(int(s) for s in shape)

    @classmethod
    def from_ndarray(cls, a):
        a = np.asarray(a, np.float32)
        return cls(a.reshape(-1), a.shape)

    def to_ndarray(self):
        return self.storage.reshape(self.shape)


class JavaValue:  # pragma: no cover - import-compat only
    """Placeholder for reference code that subclasses JavaValue; the
    constructor is a no-op (there is no JVM to call into)."""

    def __init__(self, *args, **kwargs):
        self.value = self
