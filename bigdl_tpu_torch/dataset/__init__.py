"""Datasets of the port (counterpart of ``bigdl_tpu.dataset``)."""

from bigdl_tpu_torch.dataset.dataset import (ArrayDataSet, DataSet,
                                             DistributedDataSet,
                                             PartitionStreamDataSet,
                                             iter_process_batches,
                                             to_dataset)
from bigdl_tpu_torch.dataset.mnist import load_mnist, synthetic_mnist
from bigdl_tpu_torch.dataset.movielens import (get_id_ratings, latent_scores,
                                               synthetic_movielens)
from bigdl_tpu_torch.dataset.text import (Dictionary, LabeledSentence,
                                          ptb_bptt_batches,
                                          synthetic_ptb_stream)

__all__ = ["ArrayDataSet", "DataSet", "DistributedDataSet",
           "PartitionStreamDataSet", "iter_process_batches", "to_dataset", "load_mnist",
           "synthetic_mnist", "Dictionary", "LabeledSentence",
           "ptb_bptt_batches", "synthetic_ptb_stream", "get_id_ratings",
           "latent_scores", "synthetic_movielens"]
