"""Padded, destination-sorted graph containers (counterpart of
``bignn_tpu/sparse/formats.py``).

The layout is the JAX package's, array for array: edges of a disjoint union
sorted by destination, padding edges with ``dst == node_cap`` and weight 0,
padding rows with graph id ``num_graphs``, GCN weights precomputed on the
host. The build functions are NumPy; the containers are plain dataclasses whose
``.to(device)`` copies every array to a torch tensor on that device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from bignn_tpu_torch import native

BLOCK_ROWS = 128
# node_cap up to which block-local batches also carry dense [nblk, 128, 128]
# host adjacencies (block_adj / block_cnt), as in the JAX package
BLOCK_DENSE_MAX_NODES = 131072


@dataclasses.dataclass
class COOGraph:
    """One inner graph (a molecule): ``node_feat [n, F]`` and directed edges
    ``src``/``dst`` (both directions for an undirected graph)."""

    node_feat: np.ndarray
    src: np.ndarray
    dst: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def symmetrize(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return both directions of an undirected edge list, deduplicated."""
    s = np.asarray(np.concatenate([src, dst]), np.int64)
    d = np.asarray(np.concatenate([dst, src]), np.int64)
    n = int(max(s.max(), d.max())) + 1 if len(s) else 0
    if n and n <= np.iinfo(np.int64).max // (n + 1):
        # one composite-key sort, then a mask of first occurrences: on the
        # H100 machine's host, NumPy 2.3.5's np.unique took 28 s on the 16M
        # keys of the 100K-drug graph, and this about 1 s
        keys = np.sort(s * np.int64(n) + d)
        uk = keys[np.concatenate([[True], keys[1:] != keys[:-1]])]
        return uk // n, uk % n
    uniq = np.unique(np.stack([s, d], axis=1), axis=0)
    return uniq[:, 0], uniq[:, 1]


def _to_device(obj, device) -> dict:
    """Array fields of a container (NumPy arrays or tensors) as tensors on
    ``device``."""
    moved = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            moved[f.name] = v.to(device)
    return moved


@dataclasses.dataclass
class PaddedGraphBatch:
    """Disjoint union of ``num_graphs`` inner graphs, padded to caps.

    * ``node_feat [node_cap, F]``, zero past the real rows; ``node_mask``.
    * ``edge_src``/``edge_dst``/``edge_weight [edge_cap]``, sorted by dst;
      padding edges have src 0, dst ``node_cap`` and weight 0.
    * ``graph_ids [node_cap]``: molecule per row, ``num_graphs`` on padding
      rows. In the block-local layout padding rows also sit between
      molecules, so the ids are sorted only among the valid rows.
    * ``graph_n_nodes [num_graphs]``.
    * ``edge_src_perm``/``edge_src_sorted``: the source-sort permutation.
    * block-local plan (every graph inside one 128-row block):
      ``block_estarts [node_cap/128 + 1]``, the transposed edge list
      ``edge_tsrc``/``edge_tdst``/``edge_tweight``/``block_tstarts``, and for
      ``node_cap <= BLOCK_DENSE_MAX_NODES`` the host-built dense blocks
      ``block_adj`` (weights) and ``block_cnt`` (multiplicity).
    """

    node_feat: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_weight: np.ndarray
    graph_ids: np.ndarray
    graph_n_nodes: np.ndarray
    num_graphs: int
    node_cap: int
    edge_cap: int
    edge_src_perm: np.ndarray | None = None
    edge_src_sorted: np.ndarray | None = None
    block_estarts: np.ndarray | None = None
    edge_tsrc: np.ndarray | None = None
    edge_tdst: np.ndarray | None = None
    edge_tweight: np.ndarray | None = None
    block_tstarts: np.ndarray | None = None
    block_adj: np.ndarray | None = None
    block_cnt: np.ndarray | None = None

    def to(self, device) -> "PaddedGraphBatch":
        """A copy whose arrays are torch tensors on ``device``."""
        return dataclasses.replace(self, **_to_device(self, device))


@dataclasses.dataclass
class OuterGraph:
    """The outer (drug-drug) graph, destination-sorted and padded, with the
    dense ``[N, N]`` weights (``dense_adj``) and multiplicities
    (``dense_cnt[d, s]``) when ``num_nodes`` is small enough."""

    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_weight: np.ndarray
    num_nodes: int
    edge_cap: int
    edge_src_perm: np.ndarray | None = None
    edge_src_sorted: np.ndarray | None = None
    dense_adj: np.ndarray | None = None
    dense_cnt: np.ndarray | None = None

    def to(self, device) -> "OuterGraph":
        """A copy whose arrays are torch tensors on ``device``."""
        return dataclasses.replace(self, **_to_device(self, device))


def pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``x`` to length ``n`` with ``fill``."""
    if x.shape[0] > n:
        raise ValueError(f"cannot pad length {x.shape[0]} down to {n}")
    pad_width = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)


def gcn_normalize(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    add_self_loops: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric GCN normalization: ``(src, dst, w)`` with
    ``w[e] = 1/sqrt(d_src * d_dst)``, degrees counting self-loops."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if add_self_loops:
        loop = np.arange(num_nodes, dtype=np.int64)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float64)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)
    w = inv_sqrt[src] * inv_sqrt[dst]
    return src, dst, w.astype(np.float32)


def src_sort_arrays(edge_src: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(argsort(src), src[argsort]) over the padded edge array, stable."""
    perm = np.argsort(edge_src, kind="stable").astype(np.int32)
    return perm, edge_src[perm].astype(np.int32)


def _build_sorted(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    normalize: bool,
    add_self_loops: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dst-sorted edges (+ self loops, + GCN weights), int64 ids."""
    s, d, w = native.build_sorted_graph(
        src, dst, num_nodes, add_self_loops=add_self_loops,
        normalize=normalize)
    return s.astype(np.int64), d.astype(np.int64), w


def build_padded_batch(
    graphs: Sequence[COOGraph],
    node_cap: int,
    edge_cap: int,
    *,
    normalize: bool = True,
    add_self_loops: bool = True,
    block_local: bool = False,
    graph_slots: Sequence[int] | None = None,
    num_graphs_override: int | None = None,
) -> PaddedGraphBatch:
    """Build the padded disjoint union of ``graphs``.

    ``edge_cap`` must count the self-loops when ``add_self_loops`` is set.
    ``block_local=True`` places graphs at greedily packed 128-row block
    offsets (no graph straddles a block; every graph <= 128 nodes,
    ``node_cap`` a multiple of 128) and attaches the block-local plan.

    ``graph_slots`` (the edge-partitioned inner level,
    ``parallel/partition.py``) gives the readout graph id of each position,
    strictly increasing, so a subset of a shard's drugs reads out into its
    own rows; ``num_graphs_override`` widens the readout to that many
    graphs (empty slots read out zero).
    """
    num_graphs = len(graphs)
    if num_graphs == 0:
        raise ValueError("empty graph list")
    feat_dim = graphs[0].node_feat.shape[1]
    if graph_slots is not None:
        graph_slots = np.asarray(graph_slots, np.int32)
        if len(graph_slots) != num_graphs:
            raise ValueError("graph_slots must match len(graphs)")
        if num_graphs > 1 and not np.all(np.diff(graph_slots) > 0):
            raise ValueError("graph_slots must be strictly increasing")
    if num_graphs_override is not None:
        if num_graphs_override < num_graphs:
            raise ValueError("num_graphs_override < len(graphs)")
        if graph_slots is not None and len(graph_slots) and (
                int(graph_slots[-1]) >= num_graphs_override):
            raise ValueError("graph_slots exceed num_graphs_override")
    out_graphs = (num_graphs if num_graphs_override is None
                  else int(num_graphs_override))
    sizes = np.asarray([g.num_nodes for g in graphs], np.int32)
    if block_local:
        if node_cap % BLOCK_ROWS:
            raise ValueError("block_local needs node_cap % 128 == 0")
        offsets, extent = native.greedy_pack_blocks(sizes, BLOCK_ROWS)
        if extent > node_cap:
            raise ValueError(f"packed extent {extent} > node_cap {node_cap}")
    else:
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        extent = int(sizes.sum())
        if extent > node_cap:
            raise ValueError(f"total nodes {extent} > node_cap {node_cap}")

    node_feat = np.zeros((node_cap, feat_dim), np.float32)
    node_mask = np.zeros(node_cap, np.float32)
    graph_ids = np.full(node_cap, out_graphs, np.int32)
    srcs, dsts = [], []
    for gi, g in enumerate(graphs):
        n, off = int(sizes[gi]), int(offsets[gi])
        node_feat[off : off + n] = g.node_feat
        node_mask[off : off + n] = 1.0
        graph_ids[off : off + n] = (
            gi if graph_slots is None else int(graph_slots[gi]))
        srcs.append(np.asarray(g.src, np.int64) + off)
        dsts.append(np.asarray(g.dst, np.int64) + off)
        if add_self_loops:
            # per-graph loops: packing-gap rows get none, but the
            # normalization still counts every real row's loop
            loop = np.arange(off, off + n, dtype=np.int64)
            srcs.append(loop)
            dsts.append(loop)

    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    src, dst, w = _build_sorted(src, dst, extent, normalize, False)
    if src.shape[0] > edge_cap:
        raise ValueError(f"total edges {src.shape[0]} > edge_cap {edge_cap}")

    edge_src = pad_to(src.astype(np.int32), edge_cap, fill=0)
    edge_dst = pad_to(dst.astype(np.int32), edge_cap, fill=node_cap)
    edge_weight = pad_to(w, edge_cap, fill=0.0).astype(np.float32)
    sperm, ssorted = src_sort_arrays(edge_src)
    block = {}
    if block_local:
        nblocks = node_cap // BLOCK_ROWS
        bounds = np.arange(nblocks + 1, dtype=np.int64) * BLOCK_ROWS
        order = np.argsort(src, kind="stable")
        tdst = src[order].astype(np.int32)
        block = dict(
            block_estarts=np.searchsorted(dst, bounds).astype(np.int32),
            edge_tsrc=pad_to(dst[order].astype(np.int32), edge_cap, fill=0),
            edge_tdst=pad_to(tdst, edge_cap, fill=node_cap),
            edge_tweight=pad_to(w[order], edge_cap, fill=0.0).astype(
                np.float32),
            block_tstarts=np.searchsorted(tdst, bounds).astype(np.int32),
        )
        if node_cap <= BLOCK_DENSE_MAX_NODES:
            block_adj = np.zeros((nblocks, BLOCK_ROWS, BLOCK_ROWS), np.float32)
            block_cnt = np.zeros((nblocks, BLOCK_ROWS, BLOCK_ROWS), np.float32)
            b = dst // BLOCK_ROWS  # block locality: src // 128 == dst // 128
            np.add.at(block_adj, (b, dst % BLOCK_ROWS, src - b * BLOCK_ROWS), w)
            np.add.at(block_cnt, (b, dst % BLOCK_ROWS, src - b * BLOCK_ROWS),
                      1.0)
            block.update(block_adj=block_adj, block_cnt=block_cnt)

    n_nodes = np.zeros(out_graphs, np.float32)
    n_nodes[np.arange(num_graphs) if graph_slots is None
            else graph_slots] = sizes
    return PaddedGraphBatch(
        node_feat=node_feat,
        node_mask=node_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_weight=edge_weight,
        graph_ids=graph_ids,
        graph_n_nodes=n_nodes,
        num_graphs=out_graphs,
        node_cap=int(node_cap),
        edge_cap=int(edge_cap),
        edge_src_perm=sperm,
        edge_src_sorted=ssorted,
        **block,
    )


def build_outer_graph(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    edge_cap: int | None = None,
    *,
    normalize: bool = True,
    add_self_loops: bool = True,
    symmetrize_edges: bool = True,
    dense_max_nodes: int = 4096,
) -> OuterGraph:
    """Build the padded outer graph from an undirected edge list (both
    directions stored). For ``num_nodes <= dense_max_nodes`` it is also
    materialized densely (``dense_adj``/``dense_cnt``); 0 disables."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if symmetrize_edges:
        src, dst = symmetrize(src, dst)
    src, dst, w = _build_sorted(src, dst, num_nodes, normalize, add_self_loops)
    dense_adj = dense_cnt = None
    if 0 < num_nodes <= dense_max_nodes:
        dense_adj = np.zeros((num_nodes, num_nodes), np.float32)
        np.add.at(dense_adj, (dst, src), w)
        dense_cnt = np.zeros((num_nodes, num_nodes), np.float32)
        np.add.at(dense_cnt, (dst, src), 1.0)
    n_edges = src.shape[0]
    if edge_cap is None:
        edge_cap = ((n_edges + 127) // 128) * 128
    if n_edges > edge_cap:
        raise ValueError(f"edges {n_edges} > edge_cap {edge_cap}")
    edge_src = pad_to(src.astype(np.int32), edge_cap, fill=0)
    sperm, ssorted = src_sort_arrays(edge_src)
    return OuterGraph(
        edge_src=edge_src,
        edge_dst=pad_to(dst.astype(np.int32), edge_cap, fill=num_nodes),
        edge_weight=pad_to(w, edge_cap, fill=0.0),
        num_nodes=int(num_nodes),
        edge_cap=int(edge_cap),
        edge_src_perm=sperm,
        edge_src_sorted=ssorted,
        dense_adj=dense_adj,
        dense_cnt=dense_cnt,
    )
