"""bigdl_tpu_torch: the PyTorch/CUDA port of bigdl_tpu for NVIDIA Hopper.

It sits beside the JAX package and imports nothing from it (nor JAX).
Layout and names mirror ``bigdl_tpu`` so that each module's
counterpart is easy to find.  Entry points take ``device=`` and run on
the card unless the caller asks for ``"cpu"``; the attention kernels
are hand-written CUDA under ``csrc/``, built with ``nvcc`` at first use
(``ops/_cuda.py``).
"""

__version__ = "0.1.0"
