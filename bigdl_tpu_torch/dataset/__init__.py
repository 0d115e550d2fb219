"""Datasets of the port (counterpart of ``bigdl_tpu.dataset``)."""

from bigdl_tpu_torch.dataset.dataset import ArrayDataSet, DataSet, to_dataset

__all__ = ["ArrayDataSet", "DataSet", "to_dataset"]
