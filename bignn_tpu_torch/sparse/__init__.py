"""Padded graph layouts and bucketing (counterpart of ``bignn_tpu/sparse``)."""

from bignn_tpu_torch.sparse.bucketing import Bucketing, bucket_graphs, plan_buckets
from bignn_tpu_torch.sparse.formats import (
    COOGraph,
    OuterGraph,
    PaddedGraphBatch,
    build_outer_graph,
    build_padded_batch,
    gcn_normalize,
    pad_to,
    src_sort_arrays,
    symmetrize,
)

__all__ = [
    "Bucketing",
    "COOGraph",
    "OuterGraph",
    "PaddedGraphBatch",
    "bucket_graphs",
    "build_outer_graph",
    "build_padded_batch",
    "gcn_normalize",
    "pad_to",
    "plan_buckets",
    "src_sort_arrays",
    "symmetrize",
]
