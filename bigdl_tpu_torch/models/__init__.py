"""Models of the PyTorch/CUDA port (counterpart of ``bigdl_tpu.models``)."""

from bigdl_tpu_torch.models.lenet import build_lenet5, train_lenet
from bigdl_tpu_torch.models.resnet import (build_resnet_cifar,
                                           build_resnet_imagenet,
                                           imagenet_recipe_optim)
from bigdl_tpu_torch.models.rnn import build_ptb_lm, perplexity, train_ptb
from bigdl_tpu_torch.models.transformer import (TransformerLM,
                                                build_transformer_lm)

__all__ = ["TransformerLM", "build_transformer_lm", "build_resnet_cifar",
           "build_resnet_imagenet", "imagenet_recipe_optim", "build_lenet5",
           "train_lenet", "build_ptb_lm", "perplexity", "train_ptb"]
