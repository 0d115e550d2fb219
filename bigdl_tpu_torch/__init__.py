"""bigdl_tpu_torch: the PyTorch/CUDA port of bigdl_tpu for NVIDIA Hopper.

It sits beside the JAX package and imports nothing from it (nor JAX).
Layout and names mirror ``bigdl_tpu`` so that each module's
counterpart is easy to find.  Entry points take ``device=`` and run on
the card unless the caller asks for ``"cpu"``.  It serves
``TransformerLM`` through the paged ``LMEngine`` and trains ResNet,
the ``TransformerLM``, the PTB LSTM language model and LeNet-5 (with
validation) through ``LocalOptimizer``; its kernels (flash and paged-decode
attention, fused conv + BN statistics) are hand-written CUDA under
``csrc/``, built with ``nvcc`` at first use (``ops/_cuda.py``).
"""

__version__ = "0.1.0"
