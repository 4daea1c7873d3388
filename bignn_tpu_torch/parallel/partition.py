"""Outer-graph edge partition (a NumPy copy of
``bignn_tpu/parallel/partition.py``; its arrays equal the JAX package's,
array for array).

Owner-computes over contiguous node blocks:

  * drugs split into G blocks of B = ceil(N / G); shard g owns
    [g*B, (g+1)*B), so the concatenated ``[G*B, d]`` shard outputs are
    indexed by drug id;
  * each directed edge s -> d lives on owner(d), so a node's incoming edges
    (and GAT's softmax over them) stay on one shard, and the shard's edges
    are a contiguous, still destination-sorted slice of the global list;
  * every remote source is a boundary node: ``send_idx[h, g]`` lists the
    local rows shard h sends to g, one all-to-all per outer layer
    (``parallel/halo.py``);
  * edge sources are remapped into the shard's extended array: [0, B) the
    owned rows, B + h*S + k the k-th row received from shard h.

GCN weights are normalized globally before the partition.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bignn_tpu_torch import native
from bignn_tpu_torch.sparse.formats import (
    COOGraph,
    PaddedGraphBatch,
    _build_sorted,
    build_padded_batch,
    symmetrize,
)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclasses.dataclass
class OuterPartitionPlan:
    """Static halo-exchange plan for one outer graph on G shards; every
    array has a leading G axis:
      send_idx    [G, G, S]  local rows shard g sends to shard h (pad 0)
      edge_src    [G, E_cap] sources in the extended array (pad 0)
      edge_dst    [G, E_cap] local destinations, sorted (pad B)
      edge_weight [G, E_cap] GCN weights (pad 0)
      src_perm, src_sorted   the stable source sort of edge_src per shard,
                             so no backward sorts at run time
      local_*, remote_*      the overlap split: edges whose source is owned
                             (no halo dependency) and edges that read halo
                             rows (ext ids), both destination-sorted."""

    num_nodes: int
    n_shards: int
    node_block: int  # B
    halo_size: int  # S
    edge_cap: int
    send_idx: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_weight: np.ndarray
    src_perm: np.ndarray | None = None
    src_sorted: np.ndarray | None = None
    local_src: np.ndarray | None = None
    local_dst: np.ndarray | None = None
    local_weight: np.ndarray | None = None
    remote_src: np.ndarray | None = None
    remote_dst: np.ndarray | None = None
    remote_weight: np.ndarray | None = None

    @property
    def ext_size(self) -> int:
        return self.node_block + self.n_shards * self.halo_size

    def owner(self, node: np.ndarray) -> np.ndarray:
        return np.asarray(node) // self.node_block

    def stats(self) -> dict:
        real_edges = (self.edge_dst < self.node_block).sum(axis=1)
        return {
            "edges_per_shard": real_edges.tolist(),
            "halo_slots": int(self.halo_size),
            "edge_cap": int(self.edge_cap),
            "replication_factor": float(
                1.0 + self.n_shards * self.halo_size / max(self.num_nodes, 1)
            ),
        }


def boundary_drugs(plan: OuterPartitionPlan) -> list[np.ndarray]:
    """Per shard: the local drug slots some peer needs (any entry of
    ``send_idx``; the pad 0 over-approximates harmlessly: a boundary drug
    merely encodes in the first union)."""
    out = []
    for g in range(plan.n_shards):
        slots = set()
        for h in range(plan.n_shards):
            if h != g:
                slots.update(int(x) for x in plan.send_idx[g, h])
        out.append(np.asarray(sorted(slots), np.int64))
    return out


def _empty_like_batch(template: PaddedGraphBatch) -> PaddedGraphBatch:
    """An all-padding batch with ``template``'s caps and fields, for a shard
    whose molecule subset is empty: zero arrays, padding edges past
    ``node_cap``, padding graph ids, an identity source sort."""
    rep = {f.name: np.zeros_like(getattr(template, f.name))
           for f in dataclasses.fields(template)
           if isinstance(getattr(template, f.name), np.ndarray)}
    nc, ng, ec = template.node_cap, template.num_graphs, template.edge_cap
    rep["edge_dst"] = np.full(ec, nc, np.int32)
    if template.edge_tdst is not None:
        rep["edge_tdst"] = np.full(ec, nc, np.int32)
    rep["graph_ids"] = np.full(nc, ng, np.int32)
    rep["edge_src_perm"] = np.arange(ec, dtype=np.int32)
    return dataclasses.replace(template, **rep)


def _stack_batches(batches) -> PaddedGraphBatch:
    """One batch whose arrays stack ``batches``' on a leading axis (the
    JAX package's ``jax.tree.map(np.stack, ...)``)."""
    first = batches[0]
    rep = {f.name: np.stack([getattr(b, f.name) for b in batches])
           for f in dataclasses.fields(first)
           if isinstance(getattr(first, f.name), np.ndarray)}
    return dataclasses.replace(first, **rep)


def unstack_batch(batch: PaddedGraphBatch, g: int) -> PaddedGraphBatch:
    """Shard ``g``'s batch of a stacked one."""
    rep = {f.name: getattr(batch, f.name)[g]
           for f in dataclasses.fields(batch)
           if isinstance(getattr(batch, f.name), np.ndarray)}
    return dataclasses.replace(batch, **rep)


def _build_shard_batches(groups, B, normalize, add_self_loops, block_local,
                         feat_dim) -> PaddedGraphBatch:
    """One stacked batch from per-shard ``(graphs, slots)`` groups: shared
    caps (the largest shard's, 128-aligned edges), the given local drug
    slots as graph ids, every shard read out into ``[B, d]``."""
    if block_local:
        extents = [native.greedy_pack_blocks(
            np.asarray([m.num_nodes for m in gs], np.int32), 128)[1]
            if gs else 0 for gs, _ in groups]
        node_cap = _round_up(max(max(extents), 128), 128)
    else:
        node_cap = _round_up(
            max(max((sum(m.num_nodes for m in gs) for gs, _ in groups),
                    default=8), 8), 8)
    e_tot = max(
        max((sum(m.num_edges for m in gs)
             + (sum(m.num_nodes for m in gs) if add_self_loops else 0)
             for gs, _ in groups), default=128), 128)
    edge_cap = _round_up(e_tot, 128)

    def build(gs, slots):
        return build_padded_batch(
            gs, node_cap=node_cap, edge_cap=edge_cap, normalize=normalize,
            add_self_loops=add_self_loops, block_local=block_local,
            graph_slots=slots, num_graphs_override=B)

    batches = [build(gs, slots) if gs else None for gs, slots in groups]
    template = next((b for b in batches if b is not None), None)
    if template is None:
        # every subset is empty (an interior union when all drugs are
        # boundary): the fields of a 1-node dummy, wiped to padding
        dummy = COOGraph(node_feat=np.zeros((1, feat_dim), np.float32),
                         src=np.zeros(0, np.int64), dst=np.zeros(0, np.int64))
        template = _empty_like_batch(build([dummy], [0]))
    return _stack_batches([
        b if b is not None else _empty_like_batch(template) for b in batches])


def build_sharded_inner(molecules, plan: OuterPartitionPlan, *,
                        normalize: bool = True, add_self_loops: bool = True,
                        split_boundary: bool = False,
                        block_local: bool | None = None):
    """Per-shard padded molecule unions, stacked on a leading G axis.

    Shard g encodes the molecules of its drugs [g*B, (g+1)*B) with local
    drug slots as graph ids, so the inner level needs no exchange.
    ``block_local`` (default: every molecule has at most 128 atoms, the
    rule of ``sparse/bucketing.py``) packs each union into 128-row blocks
    with the block-local plan. With ``split_boundary`` (the overlap path)
    returns two stacked batches ``(boundary, interior)``: the boundary
    drugs encode first so their rows can enter the exchange while the
    interior ones encode; each drug is in one union under its own slot, so
    the two readouts add."""
    G, B = plan.n_shards, plan.node_block
    n = len(molecules)
    feat_dim = molecules[0].node_feat.shape[1]
    if block_local is None:
        block_local = max(m.num_nodes for m in molecules) <= 128

    def owned(g):
        return list(range(g * B, min((g + 1) * B, n)))

    def group(g, ids):
        return [molecules[i] for i in ids], [i - g * B for i in ids]

    build = lambda groups: _build_shard_batches(  # noqa: E731
        groups, B, normalize, add_self_loops, block_local, feat_dim)
    if not split_boundary:
        return build([group(g, owned(g)) for g in range(G)])
    bnd = boundary_drugs(plan)
    bnd_groups, int_groups = [], []
    for g in range(G):
        ids = owned(g)
        bset = {int(s) for s in bnd[g] if s < len(ids)}
        bnd_groups.append(group(g, [g * B + s for s in sorted(bset)]))
        int_groups.append(group(g, [i for i in ids if i - g * B not in bset]))
    return build(bnd_groups), build(int_groups)


def build_outer_partition(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                          n_shards: int, *, normalize: bool = True,
                          add_self_loops: bool = True,
                          symmetrize_edges: bool = True) -> OuterPartitionPlan:
    """The plan of an undirected edge list (the input of
    ``sparse.formats.build_outer_graph``). Vectorized: a few array passes,
    no per-edge Python."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if symmetrize_edges:
        src, dst = symmetrize(src, dst)
    s, d, w = _build_sorted(src, dst, num_nodes, normalize, add_self_loops)

    B = -(-num_nodes // n_shards)
    owner_d = d // B
    owner_s = s // B

    # unique (dst shard g, remote src) pairs; sorted by (g, src), which is
    # also (g, source shard h, src) since h = src // B is monotone in src
    rem = owner_s != owner_d
    key = owner_d[rem] * np.int64(num_nodes) + s[rem]
    uk = np.unique(key)
    g_of = uk // num_nodes
    s_glob = uk % num_nodes
    h_of = s_glob // B
    cnt_hg = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(cnt_hg, (h_of, g_of), 1)
    S = int(cnt_hg.max()) if len(uk) else 0
    S = max(_round_up(max(S, 1), 8), 8)

    # send_idx[h, g, :k]: ascending local ids shard h sends to g; groups of
    # the (h, g, src) order start at an exclusive cumsum of their counts
    send_idx = np.zeros((n_shards, n_shards, S), np.int32)
    order_hg = np.lexsort((s_glob, g_of, h_of))
    h_o, g_o, s_o = h_of[order_hg], g_of[order_hg], s_glob[order_hg]
    grp = h_o * n_shards + g_o
    starts = np.concatenate(
        [[0], np.cumsum(np.bincount(grp, minlength=n_shards * n_shards))])
    rank = np.arange(len(grp)) - starts[grp]
    send_idx[h_o, g_o, rank] = (s_o - h_o * B).astype(np.int32)

    # ext slot of each unique (g, src): B + h*S + its rank in the (g, h)
    # group, which uk's own order gives
    grp2 = g_of * n_shards + h_of
    starts2 = np.concatenate(
        [[0], np.cumsum(np.bincount(grp2, minlength=n_shards * n_shards))])
    ext_of_uk = B + h_of * S + (np.arange(len(uk)) - starts2[grp2])
    g_starts = np.concatenate(
        [[0], np.cumsum(np.bincount(g_of, minlength=n_shards))])

    # per-shard slices (d is sorted) with sources remapped
    bounds = np.searchsorted(d, np.arange(n_shards + 1) * B)
    edge_cap = max(_round_up(int(np.diff(bounds).max()), 128), 128)
    edge_src = np.zeros((n_shards, edge_cap), np.int32)
    edge_dst = np.full((n_shards, edge_cap), B, np.int32)
    edge_w = np.zeros((n_shards, edge_cap), np.float32)
    per_shard = []
    for g in range(n_shards):
        sl = slice(bounds[g], bounds[g + 1])
        sg, dg, wg = s[sl], d[sl], w[sl]
        is_local = sg // B == g
        keys_g = s_glob[g_starts[g]: g_starts[g + 1]]
        ext_g = ext_of_uk[g_starts[g]: g_starts[g + 1]]
        src_l = sg - g * B
        if len(keys_g):
            src_l[~is_local] = ext_g[np.searchsorted(keys_g, sg[~is_local])]
        n_e = len(sg)
        edge_src[g, :n_e] = src_l
        edge_dst[g, :n_e] = dg - g * B
        edge_w[g, :n_e] = wg
        per_shard.append((src_l, dg - g * B, wg, is_local))

    # the overlap split, order kept from the sorted slice
    loc_cap = max(_round_up(max(int(p[3].sum()) for p in per_shard), 128), 128)
    rem_cap = max(
        _round_up(max(int((~p[3]).sum()) for p in per_shard), 128), 128)
    local_src = np.zeros((n_shards, loc_cap), np.int32)
    local_dst = np.full((n_shards, loc_cap), B, np.int32)
    local_w = np.zeros((n_shards, loc_cap), np.float32)
    remote_src = np.zeros((n_shards, rem_cap), np.int32)
    remote_dst = np.full((n_shards, rem_cap), B, np.int32)
    remote_w = np.zeros((n_shards, rem_cap), np.float32)
    for g, (src_l, dst_l, wg, is_local) in enumerate(per_shard):
        nl = int(is_local.sum())
        nr = len(src_l) - nl
        local_src[g, :nl] = src_l[is_local]
        local_dst[g, :nl] = dst_l[is_local]
        local_w[g, :nl] = wg[is_local]
        remote_src[g, :nr] = src_l[~is_local]
        remote_dst[g, :nr] = dst_l[~is_local]
        remote_w[g, :nr] = wg[~is_local]

    # padding edges (src 0, weight 0, dst B) sort harmlessly: every
    # backward drops them by weight or destination
    src_perm = np.argsort(edge_src, axis=1, kind="stable").astype(np.int32)
    src_sorted = np.take_along_axis(edge_src, src_perm, axis=1)

    return OuterPartitionPlan(
        num_nodes=num_nodes, n_shards=n_shards, node_block=B, halo_size=S,
        edge_cap=edge_cap, send_idx=send_idx, edge_src=edge_src,
        edge_dst=edge_dst, edge_weight=edge_w, src_perm=src_perm,
        src_sorted=src_sorted, local_src=local_src, local_dst=local_dst,
        local_weight=local_w, remote_src=remote_src, remote_dst=remote_dst,
        remote_weight=remote_w)
