"""GNN modules of the port (counterpart of ``bignn_tpu/models``)."""

from bignn_tpu_torch.models.bignn import BiGNN, BiGNNConfig, upload_buckets
from bignn_tpu_torch.models.convs import (
    DotAttnConv,
    GATConv,
    GCNConv,
    GINConv,
    parse_conv,
)
from bignn_tpu_torch.models.modules import MLP, Dense, glorot, parse_activation
from bignn_tpu_torch.models.readout import (
    AttentionReadout,
    MaxReadout,
    MeanReadout,
    SumReadout,
    parse_readout,
)
from bignn_tpu_torch.models.scorer import DotScorer, MLPScorer, parse_scorer

__all__ = [
    "AttentionReadout",
    "BiGNN",
    "BiGNNConfig",
    "Dense",
    "DotScorer",
    "DotAttnConv",
    "GATConv",
    "GCNConv",
    "GINConv",
    "MLP",
    "MLPScorer",
    "MaxReadout",
    "MeanReadout",
    "SumReadout",
    "glorot",
    "parse_activation",
    "parse_conv",
    "parse_readout",
    "parse_scorer",
    "upload_buckets",
]
