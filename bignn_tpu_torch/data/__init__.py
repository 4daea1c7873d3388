"""Datasets (counterpart of ``bignn_tpu/data``): the host schema, the
synthetic generator and the registry."""

from bignn_tpu_torch.data.datasets import load_dataset, load_npz_cache
from bignn_tpu_torch.data.schema import (
    DDIDataset,
    DeviceData,
    prepare_device_data,
    random_split,
)
from bignn_tpu_torch.data.synthetic import make_synthetic_ddi

__all__ = [
    "DDIDataset",
    "DeviceData",
    "load_dataset",
    "load_npz_cache",
    "make_synthetic_ddi",
    "prepare_device_data",
    "random_split",
]
