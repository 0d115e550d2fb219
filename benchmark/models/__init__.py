"""Adapters from a configuration to the program: one module a family."""

import torch


def kernels(device) -> None:
    """Build (or, once built in this checkout, load) every CUDA kernel
    of the program at set-up, all at once."""
    if torch.device(device).type == "cuda":
        from bigdl_tpu_torch.ops import _cuda

        _cuda.build()
