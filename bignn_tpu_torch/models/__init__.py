"""GNN modules of the port (counterpart of ``bignn_tpu/models``)."""

from bignn_tpu_torch.models.bignn import BiGNN, BiGNNConfig
from bignn_tpu_torch.models.convs import GATConv, GCNConv, GINConv, parse_conv
from bignn_tpu_torch.models.modules import MLP, Dense, glorot_, parse_activation
from bignn_tpu_torch.models.readout import SumReadout, parse_readout
from bignn_tpu_torch.models.scorer import DotScorer, MLPScorer, parse_scorer

__all__ = [
    "BiGNN",
    "BiGNNConfig",
    "Dense",
    "DotScorer",
    "GATConv",
    "GCNConv",
    "GINConv",
    "MLP",
    "MLPScorer",
    "SumReadout",
    "glorot_",
    "parse_activation",
    "parse_conv",
    "parse_readout",
    "parse_scorer",
]
