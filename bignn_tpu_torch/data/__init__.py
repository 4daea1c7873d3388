"""Datasets and samplers (counterpart of ``bignn_tpu/data``): the host
schema, the synthetic generator, the registry, and the hierarchical
samplers of configs 3-4 (``hierarchical`` on the host, ``device_sampler``
on the card)."""

from bignn_tpu_torch.data.datasets import (
    load_dataset,
    load_npz_cache,
    save_npz_cache,
)
from bignn_tpu_torch.data.device_sampler import DeviceSampler
from bignn_tpu_torch.data.hierarchical import (
    CompactBatch,
    HierarchicalBatch,
    HierarchicalSampler,
)
from bignn_tpu_torch.data.schema import (
    DDIDataset,
    DeviceData,
    prepare_device_data,
    random_split,
)
from bignn_tpu_torch.data.synthetic import make_synthetic_ddi

__all__ = [
    "CompactBatch",
    "DDIDataset",
    "DeviceSampler",
    "DeviceData",
    "HierarchicalBatch",
    "HierarchicalSampler",
    "load_dataset",
    "load_npz_cache",
    "make_synthetic_ddi",
    "prepare_device_data",
    "random_split",
    "save_npz_cache",
]
