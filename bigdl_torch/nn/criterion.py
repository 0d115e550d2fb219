"""«py»/nn/criterion.py shim — criterions under their classic names."""

from bigdl_tpu_torch.nn.criterion import *  # noqa: F401,F403
