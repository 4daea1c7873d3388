"""BiGNN, the bi-level graph-of-graphs model (counterpart of
``bignn_tpu/models/bignn.py``).

  1. INNER: each bucket's padded union of molecules runs through the inner
     convs; the readout pools node states into one embedding per molecule,
     and the bucket embeddings are placed into one ``[num_drugs, d]`` matrix.
  2. OUTER: the outer convs propagate drug embeddings over the DDI graph.
  3. SCORING: the pair scorer turns two drug embeddings into a logit.

Batches and outer graphs are the containers of ``sparse/formats.py`` after
``.to(device)``; ``upload_buckets`` puts a bucketing on the device, the one
way ``Scorer`` and ``Trainer`` both take.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from bignn_tpu_torch import ops, prng
from bignn_tpu_torch.models.convs import parse_conv
from bignn_tpu_torch.models.modules import prefixed
from bignn_tpu_torch.models.readout import parse_readout
from bignn_tpu_torch.models.scorer import parse_scorer
from bignn_tpu_torch.sparse.bucketing import Bucketing
from bignn_tpu_torch.sparse.formats import OuterGraph, PaddedGraphBatch


@dataclasses.dataclass(frozen=True)
class BiGNNConfig:
    """The model as per-layer spec strings, e.g. inner ``("gin:64",
    "gin:64")``, outer ``("gat:64:4",)``, readout ``"sum"``, scorer
    ``"dot"``. ``dtype`` is the compute precision, ``"float32"`` or
    ``"bfloat16"``: parameters stay float32 either way."""

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


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BiGNN(nn.Module):
    """Parameters are named ``inner.<i>.*``, ``readout.*`` (the attention
    readout's), ``outer.<i>.*`` and ``scorer.*`` (``bridge.py`` maps the JAX tree onto them). Construction
    loads :meth:`init_params` of ``seed``: the JAX package's initial
    parameters for ``jax.random.key(seed)``.

    ``config.dtype`` is the compute type, as in the JAX package
    (``bignn_tpu/models/bignn.py:135-242``): every level casts its input to
    it and every layer casts its float32 parameters to it, so gradients
    reach the float32 masters through the casts; ``embed_drugs`` and
    ``score_pairs`` return float32."""

    def __init__(self, config: BiGNNConfig, *, seed: int = 0):
        super().__init__()
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype {config.dtype!r}: want one of "
                             f"{sorted(_DTYPES)}")
        self.config = config
        self.compute_dtype = _DTYPES[config.dtype]
        dim = config.feat_dim
        inner = []
        for spec in config.inner_layers:
            inner.append(parse_conv(spec, dim))
            dim = inner[-1].out_dim
        self.inner = nn.ModuleList(inner)
        self.readout = parse_readout(config.readout, dim)
        outer = []
        for spec in config.outer_layers:
            outer.append(parse_conv(spec, dim))
            dim = outer[-1].out_dim
        self.outer = nn.ModuleList(outer)
        self.embed_dim = dim
        self.scorer = parse_scorer(config.scorer, dim)
        self.load_state_dict(self.init_params(seed))

    def init_params(self, seed: int) -> dict[str, torch.Tensor]:
        """The JAX package's ``BiGNN.init(jax.random.key(seed))`` as a
        state dict for this model, bit for bit: the same threefry keys
        (``prng.py``), handed out in the same order (inner layers, readout,
        outer layers, scorer)."""
        keys = prng.split(prng.key(seed),
                          len(self.inner) + len(self.outer) + 2)
        state = {}
        for i, conv in enumerate(self.inner):
            state.update(prefixed(f"inner.{i}.", conv.init_params(keys.pop())))
        state.update(prefixed("readout.",
                              self.readout.init_params(keys.pop())))
        for i, conv in enumerate(self.outer):
            state.update(prefixed(f"outer.{i}.", conv.init_params(keys.pop())))
        state.update(prefixed("scorer.", self.scorer.init_params(keys.pop())))
        return state

    def encode_inner(self, batch: PaddedGraphBatch) -> torch.Tensor:
        """Inner convs + readout on one bucket -> ``[num_graphs, d]`` (the
        compute type; float32 from the attention readout). Every conv gets
        the bucket's edge list, GCN weights and source-sort arrays, its
        block-local plan where the layout has one, and the dense blocks
        where the bucket has them (``node_cap <= BLOCK_DENSE_MAX_NODES``),
        which it then prefers (JAX ``bignn.py:135-164``)."""
        block_dense = block_plan = None
        if batch.block_cnt is not None:
            block_dense = (batch.block_adj, batch.block_cnt)
        if batch.block_estarts is not None and batch.edge_tsrc is not None:
            block_plan = (batch.block_estarts, batch.edge_tsrc,
                          batch.edge_tdst, batch.edge_tweight,
                          batch.block_tstarts)
        x = batch.node_feat.to(self.compute_dtype)
        for conv in self.inner:
            x = conv(x, batch.edge_src, batch.edge_dst, batch.node_cap,
                     src_perm=batch.edge_src_perm,
                     src_sorted=batch.edge_src_sorted,
                     edge_weight=batch.edge_weight, block_plan=block_plan,
                     block_dense=block_dense)
        return self.readout(x, batch.graph_ids, batch.num_graphs,
                            batch.graph_n_nodes)

    def embed_drugs(self, buckets: Sequence[PaddedGraphBatch],
                    graph_index: Sequence[torch.Tensor],
                    num_drugs: int) -> torch.Tensor:
        """All buckets through the inner level, placed into
        ``[num_drugs, d]`` float32. The buckets partition the drugs, so the
        placement is a permutation gather."""
        embs = [self.encode_inner(b) for b in buckets]
        idx = torch.cat([torch.as_tensor(i) for i in graph_index]).to(
            embs[0].device)
        if idx.numel() != num_drugs:
            raise ValueError(
                f"buckets hold {idx.numel()} drugs, expected {num_drugs}")
        return ops.permutation_scatter_rows(torch.cat(embs), idx).float()

    def propagate_outer(self, emb: torch.Tensor,
                        outer: OuterGraph) -> torch.Tensor:
        """The outer convs over the DDI graph: every conv gets its edge list,
        GCN weights and source-sort arrays, and the dense masks where the
        graph has them (``num_nodes <= dense_max_nodes``), which it then
        prefers."""
        dense = None
        if outer.dense_cnt is not None:
            dense = (outer.dense_adj, outer.dense_cnt)
        emb = emb.to(self.compute_dtype)
        for conv in self.outer:
            emb = conv(emb, outer.edge_src, outer.edge_dst, outer.num_nodes,
                       src_perm=outer.edge_src_perm,
                       src_sorted=outer.edge_src_sorted, dense=dense,
                       edge_weight=outer.edge_weight)
        return emb

    def score_pairs(self, emb: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
        """float32 logits of ``[P, 2]`` pairs, scored in the compute type."""
        return self.scorer(emb.to(self.compute_dtype), pairs).float()

    def score_one_vs_all(self, emb: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """float32 logits of (u, v) for every v; u is one id or a ``[B]``
        batch."""
        return self.scorer.apply_one_vs_all(emb.to(self.compute_dtype),
                                            u).float()

    def forward(self, buckets: Sequence[PaddedGraphBatch],
                graph_index: Sequence[torch.Tensor], outer: OuterGraph,
                pairs: torch.Tensor) -> torch.Tensor:
        """Molecules + DDI graph + ``[P, 2]`` pairs -> logits (the JAX
        package's ``BiGNN.apply``)."""
        emb = self.embed_drugs(buckets, graph_index, outer.num_nodes)
        emb = self.propagate_outer(emb, outer)
        return self.score_pairs(emb, pairs)


def upload_buckets(bucketing: Bucketing, inner_layers: Sequence[str],
                   device) -> tuple[list[PaddedGraphBatch], list[torch.Tensor]]:
    """``(buckets, graph_index)`` on ``device``, as ``build_padded_batch``
    lays them out (JAX ``sparse/formats.py:259``, ``:365``).

    Each bucket goes up without its host-built adjacencies. A bucket that
    had them (block-local, at most ``BLOCK_DENSE_MAX_NODES`` rows) gets them
    built on the device by ``ops.block_adjacency``: the multiplicity always
    (GIN sum, attention mask), the GCN weights when an inner layer
    (``inner_layers``, spec strings) is a GCN. A larger block-local bucket
    keeps only its block plan (the convs take ``ops.block_spmm``), and a
    bucket that is not block-local (molecules over 128 atoms) its edge list
    and source-sort arrays (``ops.spmm_sorted_coo``)."""
    buckets = [upload_batch(batch, inner_layers, device)
               for batch in bucketing.batches]
    graph_index = [torch.as_tensor(i, device=device)
                   for i in bucketing.graph_index]
    return buckets, graph_index


def upload_batch(batch: PaddedGraphBatch, inner_layers: Sequence[str],
                 device) -> PaddedGraphBatch:
    """One host batch on ``device`` without its host-built adjacencies,
    which are built there where the host batch had them (see
    ``upload_buckets``)."""
    dev = dataclasses.replace(batch, block_adj=None, block_cnt=None).to(device)
    if batch.block_cnt is not None:
        dev.block_cnt = ops.block_adjacency(
            dev.edge_src, dev.edge_dst, None, dev.block_estarts, dev.node_cap)
        if any(s.split(":")[0] == "gcn" for s in inner_layers):
            dev.block_adj = ops.block_adjacency(
                dev.edge_src, dev.edge_dst, dev.edge_weight,
                dev.block_estarts, dev.node_cap)
    return dev
