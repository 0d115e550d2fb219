"""``bigdl_torch`` — the classic Python-BigDL import surface over the
PyTorch/CUDA port (``bigdl_tpu_torch``), as ``bigdl`` is over
``bigdl_tpu``.

The classic program keeps its imports with the package name changed::

    from bigdl_torch.nn.layer import Sequential, Linear, SpatialConvolution
    from bigdl_torch.nn.criterion import ClassNLLCriterion
    from bigdl_torch.optim.optimizer import Optimizer, SGD, MaxEpoch
    from bigdl_torch.util.common import init_engine, Sample

Every entry point runs on the card unless it is given ``device="cpu"``
(``init_engine(device="cpu")``, ``Optimizer(..., device="cpu")``).  The
Spark plumbing (the JVM gateway, ``JavaValue``) is a no-op.  The shim
imports ``bigdl_tpu_torch`` only.
"""

__version__ = "0.1.0+torch"
