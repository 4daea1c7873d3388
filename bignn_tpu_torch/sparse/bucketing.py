"""Size-bucketing of variable-size inner graphs (counterpart of
``bignn_tpu/sparse/bucketing.py``): molecules are grouped by node count into
a few buckets with fixed caps, one padded batch each."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from bignn_tpu_torch import native
from bignn_tpu_torch.sparse.formats import (
    BLOCK_ROWS,
    COOGraph,
    PaddedGraphBatch,
    build_padded_batch,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Bucketing:
    """``batches[i]`` holds bucket i; ``graph_index[i]`` maps its local
    graph slot to the original graph id."""

    batches: list[PaddedGraphBatch]
    graph_index: list[np.ndarray]
    num_graphs: int

    @property
    def num_buckets(self) -> int:
        return len(self.batches)


def plan_buckets(
    node_counts: Sequence[int],
    max_buckets: int = 4,
    waste_target: float = 0.25,
) -> list[int]:
    """Ascending per-graph node-count bounds: equal-count quantiles, merged
    while a bound is within ``waste_target`` of the previous one."""
    sizes = np.sort(np.asarray(node_counts, np.int64))
    if len(sizes) == 0:
        return []
    if max_buckets <= 1:
        return [int(sizes[-1])]
    qs = np.linspace(0, 1, max_buckets + 1)[1:]
    bounds = sorted({int(np.quantile(sizes, q, method="higher")) for q in qs})
    merged: list[int] = []
    for b in bounds:
        if merged and b <= merged[-1] * (1.0 + waste_target):
            merged[-1] = b
        else:
            merged.append(b)
    merged[-1] = int(sizes[-1])
    return merged


def bucket_graphs(
    graphs: Sequence[COOGraph],
    bounds: Sequence[int] | None = None,
    *,
    max_buckets: int = 4,
    normalize: bool = True,
    add_self_loops: bool = True,
    block_local: bool | None = None,
) -> Bucketing:
    """Partition ``graphs`` into size buckets and build one padded batch
    each. ``block_local`` defaults to on when every graph has <= 128 nodes;
    caps are the bucket's packed extent (128-aligned) and edge total
    (128-aligned)."""
    n_counts = [g.num_nodes for g in graphs]
    if block_local is None:
        block_local = max(n_counts, default=0) <= BLOCK_ROWS
    if bounds is None:
        bounds = plan_buckets(n_counts, max_buckets=max_buckets)
    bounds = list(bounds)
    if not bounds:
        raise ValueError("no graphs")

    assignments: list[list[int]] = [[] for _ in bounds]
    for gi, n in enumerate(n_counts):
        for bi, b in enumerate(bounds):
            if n <= b:
                assignments[bi].append(gi)
                break
        else:
            raise ValueError(
                f"graph {gi} with {n} nodes exceeds max bound {bounds[-1]}")

    batches, graph_index = [], []
    for members in assignments:
        if not members:
            continue
        gs = [graphs[i] for i in members]
        if block_local:
            _, extent = native.greedy_pack_blocks(
                np.asarray([g.num_nodes for g in gs], np.int32), BLOCK_ROWS)
            node_cap = _round_up(max(extent, BLOCK_ROWS), BLOCK_ROWS)
        else:
            node_cap = _round_up(sum(g.num_nodes for g in gs), 8)
        e_total = sum(g.num_edges for g in gs)
        if add_self_loops:
            e_total += sum(g.num_nodes for g in gs)
        edge_cap = _round_up(max(e_total, 128), 128)
        batches.append(
            build_padded_batch(
                gs,
                node_cap=node_cap,
                edge_cap=edge_cap,
                normalize=normalize,
                add_self_loops=add_self_loops,
                block_local=block_local,
            )
        )
        graph_index.append(np.asarray(members, np.int32))
    return Bucketing(batches=batches, graph_index=graph_index,
                     num_graphs=len(graphs))
