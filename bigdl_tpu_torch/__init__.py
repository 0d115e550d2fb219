"""bigdl_tpu_torch: the PyTorch/CUDA port of bigdl_tpu for NVIDIA Hopper.

It sits beside the JAX package and imports nothing from it (nor JAX).
Layout and names mirror ``bigdl_tpu`` so that each module's
counterpart is easy to find, and the package exports what JAX's does
(``Engine``, ``RandomGenerator``, ``config``, ``configure``, ``Tensor``
and ``obs``).  Entry points take ``device=`` and run on the card unless
the caller asks for ``"cpu"``.  It serves ``TransformerLM`` through the
paged ``LMEngine`` and trains ResNet, the ``TransformerLM``, the PTB
LSTM language model, LeNet-5, Inception, VGG, NCF, Wide & Deep, the
tree-LSTM and AlexNet through its trainers; its kernels (flash and
paged-decode attention, fused conv + BN statistics) are hand-written
CUDA under ``csrc/``, built with ``nvcc`` at first use
(``ops/_cuda.py``).
"""

from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.config import config, configure
from bigdl_tpu_torch.tensor import Tensor
from bigdl_tpu_torch import obs  # noqa: F401

__version__ = "0.1.0"

__all__ = ["Engine", "RandomGenerator", "config", "configure", "Tensor",
           "obs"]
