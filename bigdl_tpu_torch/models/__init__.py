"""Models of the PyTorch/CUDA port (counterpart of ``bigdl_tpu.models``)."""

from bigdl_tpu_torch.models.transformer import (TransformerLM,
                                                build_transformer_lm)

__all__ = ["TransformerLM", "build_transformer_lm"]
