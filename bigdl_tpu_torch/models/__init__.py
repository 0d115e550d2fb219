"""Models of the PyTorch/CUDA port (counterpart of ``bigdl_tpu.models``)."""

from bigdl_tpu_torch.models.alexnet import (build_alexnet,
                                            build_alexnet_original)
from bigdl_tpu_torch.models.autoencoder import (build_autoencoder,
                                                train_autoencoder)
from bigdl_tpu_torch.models.inception import (build_inception_v1,
                                              build_inception_v2,
                                              inception_layer_v1,
                                              inception_layer_v2,
                                              inception_recipe_optim)
from bigdl_tpu_torch.models.lenet import build_lenet5, train_lenet
from bigdl_tpu_torch.models.ncf import build_ncf
from bigdl_tpu_torch.models.resnet import (build_resnet_cifar,
                                           build_resnet_imagenet,
                                           imagenet_recipe_optim)
from bigdl_tpu_torch.models.rnn import build_ptb_lm, perplexity, train_ptb
from bigdl_tpu_torch.models.transformer import (TransformerLM,
                                                build_transformer_lm)
from bigdl_tpu_torch.models.vgg import (build_vgg16, build_vgg19,
                                        build_vgg_cifar)
from bigdl_tpu_torch.models.wide_and_deep import (build_wide_and_deep,
                                                  pack_batch)

__all__ = ["TransformerLM", "build_transformer_lm", "build_resnet_cifar",
           "build_resnet_imagenet", "imagenet_recipe_optim", "build_lenet5",
           "train_lenet", "build_ptb_lm", "perplexity", "train_ptb",
           "build_inception_v1", "build_inception_v2", "inception_layer_v1",
           "inception_layer_v2", "inception_recipe_optim", "build_vgg16",
           "build_vgg19", "build_vgg_cifar", "build_ncf",
           "build_autoencoder", "train_autoencoder", "build_alexnet",
           "build_alexnet_original", "build_wide_and_deep", "pack_batch"]
