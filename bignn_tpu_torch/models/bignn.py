"""BiGNN, the bi-level graph-of-graphs model (counterpart of
``bignn_tpu/models/bignn.py``).

  1. INNER: each bucket's padded union of molecules runs through the inner
     convs; the readout pools node states into one embedding per molecule,
     and the bucket embeddings are placed into one ``[num_drugs, d]`` matrix.
  2. OUTER: the outer convs propagate drug embeddings over the DDI graph.
  3. SCORING: the pair scorer turns two drug embeddings into a logit.

Batches and outer graphs are the containers of ``sparse/formats.py`` after
``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from bignn_tpu_torch import ops
from bignn_tpu_torch.models.convs import parse_conv
from bignn_tpu_torch.models.readout import parse_readout
from bignn_tpu_torch.models.scorer import parse_scorer
from bignn_tpu_torch.sparse.formats import OuterGraph, PaddedGraphBatch


@dataclasses.dataclass(frozen=True)
class BiGNNConfig:
    """The model as per-layer spec strings, e.g. inner ``("gin:64",
    "gin:64")``, outer ``("gat:64:4",)``, readout ``"sum"``, scorer
    ``"dot"``. ``dtype`` is the compute precision; the port runs float32."""

    feat_dim: int
    inner_layers: tuple[str, ...] = ("gcn:64", "gcn:64")
    readout: str = "sum"
    outer_layers: tuple[str, ...] = ("gcn:64",)
    scorer: str = "dot"
    dtype: str = "float32"  # "float32" | "bfloat16"

    @staticmethod
    def config1(feat_dim: int) -> "BiGNNConfig":
        """2-layer GCN inner + 1 linear GCN outer layer."""
        return BiGNNConfig(feat_dim=feat_dim, outer_layers=("gcn:64:identity",))

    @staticmethod
    def full_bignn(feat_dim: int, dim: int = 64, heads: int = 4) -> "BiGNNConfig":
        """Full BI-GNN: GIN inner, GAT outer, MLP pair scorer."""
        return BiGNNConfig(
            feat_dim=feat_dim,
            inner_layers=(f"gin:{dim}", f"gin:{dim}"),
            readout="sum",
            outer_layers=(f"gat:{dim}:{heads}:identity",),
            scorer="mlp:64",
        )


class BiGNN(nn.Module):
    """Parameters are named ``inner.<i>.*``, ``outer.<i>.*`` and
    ``scorer.*`` (``bridge.py`` maps the JAX tree onto them); init draws
    from ``generator``."""

    def __init__(self, config: BiGNNConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if config.dtype != "float32":
            raise NotImplementedError(
                f"dtype {config.dtype!r}: the port runs float32; bf16 comes "
                "with config4 (ROADMAP Queue 1)")
        self.config = config
        dim = config.feat_dim
        inner = []
        for spec in config.inner_layers:
            inner.append(parse_conv(spec, dim, generator))
            dim = inner[-1].out_dim
        self.inner = nn.ModuleList(inner)
        self.readout = parse_readout(config.readout, dim)
        outer = []
        for spec in config.outer_layers:
            outer.append(parse_conv(spec, dim, generator))
            dim = outer[-1].out_dim
        self.outer = nn.ModuleList(outer)
        self.embed_dim = dim
        self.scorer = parse_scorer(config.scorer, dim, generator)

    def encode_inner(self, batch: PaddedGraphBatch) -> torch.Tensor:
        """Inner convs + readout on one bucket -> ``[num_graphs, d]``."""
        block_dense = None
        if batch.block_cnt is not None:
            block_dense = (batch.block_adj, batch.block_cnt)
        x = batch.node_feat
        for conv in self.inner:
            x = conv(x, block_dense=block_dense)
        return self.readout(x, batch.graph_ids, batch.num_graphs)

    def embed_drugs(self, buckets: Sequence[PaddedGraphBatch],
                    graph_index: Sequence[torch.Tensor],
                    num_drugs: int) -> torch.Tensor:
        """All buckets through the inner level, placed into
        ``[num_drugs, d]``. The buckets partition the drugs, so the
        placement is a permutation gather."""
        embs = [self.encode_inner(b) for b in buckets]
        idx = torch.cat([torch.as_tensor(i) for i in graph_index]).to(
            embs[0].device)
        if idx.numel() != num_drugs:
            raise ValueError(
                f"buckets hold {idx.numel()} drugs, expected {num_drugs}")
        return ops.permutation_scatter_rows(torch.cat(embs), idx)

    def propagate_outer(self, emb: torch.Tensor,
                        outer: OuterGraph) -> torch.Tensor:
        dense = None
        if outer.dense_cnt is not None:
            dense = (outer.dense_adj, outer.dense_cnt)
        for conv in self.outer:
            emb = conv(emb, dense=dense)
        return emb

    def score_pairs(self, emb: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
        return self.scorer(emb, pairs)

    def score_one_vs_all(self, emb: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Logits of (u, v) for every v; u is one id or a ``[B]`` batch."""
        return self.scorer.apply_one_vs_all(emb, u)

    def forward(self, buckets: Sequence[PaddedGraphBatch],
                graph_index: Sequence[torch.Tensor], outer: OuterGraph,
                pairs: torch.Tensor) -> torch.Tensor:
        """Molecules + DDI graph + ``[P, 2]`` pairs -> logits (the JAX
        package's ``BiGNN.apply``)."""
        emb = self.embed_drugs(buckets, graph_index, outer.num_nodes)
        emb = self.propagate_outer(emb, outer)
        return self.score_pairs(emb, pairs)
