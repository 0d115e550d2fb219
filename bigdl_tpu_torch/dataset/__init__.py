"""Datasets of the port (counterpart of ``bigdl_tpu.dataset``)."""

from bigdl_tpu_torch.dataset.dataset import (ArrayDataSet, DataSet,
                                             DistributedDataSet,
                                             LocalDataSet,
                                             PartitionStreamDataSet,
                                             SampleDataSet,
                                             iter_process_batches,
                                             to_dataset)
from bigdl_tpu_torch.dataset.sample import (MiniBatch, Sample,
                                            samples_to_minibatch)
from bigdl_tpu_torch.dataset.stream import (BoundedBuffer, StreamDataSet,
                                            StreamRecord, StreamSource,
                                            SyntheticStream)
from bigdl_tpu_torch.dataset.transformer import (Normalizer,
                                                 SampleToMiniBatch, Shuffle,
                                                 Transformer)
from bigdl_tpu_torch.dataset.mnist import load_mnist, synthetic_mnist
from bigdl_tpu_torch.dataset.movielens import (get_id_ratings, latent_scores,
                                               synthetic_movielens)
from bigdl_tpu_torch.dataset.text import (Dictionary, LabeledSentence,
                                          ptb_bptt_batches,
                                          synthetic_ptb_stream)

__all__ = ["ArrayDataSet", "DataSet", "DistributedDataSet", "LocalDataSet",
           "SampleDataSet", "Sample", "MiniBatch", "samples_to_minibatch",
           "StreamDataSet", "StreamSource", "StreamRecord", "SyntheticStream",
           "BoundedBuffer",
           "Transformer", "SampleToMiniBatch", "Shuffle", "Normalizer",
           "PartitionStreamDataSet", "iter_process_batches", "to_dataset", "load_mnist",
           "synthetic_mnist", "Dictionary", "LabeledSentence",
           "ptb_bptt_batches", "synthetic_ptb_stream", "get_id_ratings",
           "latent_scores", "synthetic_movielens"]
