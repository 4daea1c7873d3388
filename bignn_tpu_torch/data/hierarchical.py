"""Hierarchical mini-batch + neighbor sampling (counterpart of
``bignn_tpu/data/hierarchical.py``; configs #3-4).

Host NumPy code, kept a copy of the JAX package's, array for array: the same
seed gives the same caps, tables and batches. The containers are plain
dataclasses whose ``.to(device)`` turns every array into a torch tensor on
that device (as ``sparse/formats.py`` does).

For datasets where encoding every molecule every step is wasteful (BioSNAP
mini-batching, BASELINE.json:9) or impossible (100K-subgraph synthetic,
BASELINE.json:10), each training step samples:

  1. a minibatch of positive DDI edges + host-sampled negative corruptions;
  2. the L-hop sampled neighborhood of all pair endpoints over the outer
     train graph (per-hop fanout, GraphSAGE-style) — the outer convs run on
     this subgraph only, with GCN weights from **global** degrees so
     minibatch aggregation is an unbiased-scaled version of the full pass;
  3. the molecule graphs of exactly the sampled drugs, packed into one
     padded union with **fixed caps** so the train step compiles once.

All shapes are static: node/edge budgets are caps, shortfall is padding
(dropped via the usual one-past-the-end segment ids), overflow is truncated
by the sampler (never at trace time).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from bignn_tpu_torch import native
from bignn_tpu_torch.data.schema import DDIDataset
from bignn_tpu_torch.sparse.formats import (
    _build_sorted,
    _to_device,
    src_sort_arrays,
)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (vectorized)."""
    total = int(counts.sum())
    out = np.arange(total, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return out - np.repeat(offsets, counts)


class _Container:
    """``.to(device)``: a copy whose arrays (NumPy or torch) are torch
    tensors on ``device``; other fields are kept."""

    def to(self, device):
        return dataclasses.replace(self, **_to_device(self, device))


@dataclasses.dataclass
class CompactBatch(_Container):
    """Index-only minibatch for the device-resident-table path.

    Per-step host->device traffic is just the sampled drug ids + the outer
    subgraph + pairs (~a few MB); molecule features/edges are expanded ON
    DEVICE by ragged gathers from tables uploaded once
    (MinibatchTrainer with resident=True). Crucial invariant: per-molecule
    edges are pre-sorted by local dst at sampler init, so any concatenation
    of molecule blocks with increasing offsets is globally dst-sorted — no
    per-step sort anywhere.
    """

    nodes: np.ndarray  # [drug_budget] int32 sampled drug ids; pad 0 (masked)
    n_real: np.ndarray  # [] int32 number of real sampled drugs
    # block-local layout (host greedy packing; zeros when not block-local):
    pack_off: np.ndarray  # [drug_budget] int32 packed row offset per slot
    block_slot0: np.ndarray  # [node_cap/128 + 1] int32 first slot of block b
    # Outer subgraph, with little to upload: slot ids ship as int16 when
    # drug_budget fits, and the three derivable arrays (weight =
    # invdeg[src]*invdeg[dst], src-sort perm + sorted) are None here — the
    # trainer derives them on the device from src/dst + the resident
    # inv_sqrt_deg table (MinibatchTrainer._derive_outer; a stable device
    # sort == the host's np.argsort(kind='stable')).
    outer_src: np.ndarray  # [outer_edge_cap] int16 when D <= 32767
    outer_dst: np.ndarray  # [outer_edge_cap] sorted; pad -> drug_budget
    outer_weight: np.ndarray | None  # None => derive on device
    outer_src_perm: np.ndarray | None  # [outer_edge_cap] argsort(outer_src)
    outer_src_sorted: np.ndarray | None  # [outer_edge_cap] outer_src[perm]
    pairs: np.ndarray  # [pair_cap, 2] local slots (int16 when D <= 32767)
    labels: np.ndarray
    mask: np.ndarray
    drug_budget: int
    node_cap: int
    edge_cap: int
    outer_edge_cap: int


@dataclasses.dataclass
class MoleculeTables(_Container):
    """Device-resident per-molecule arrays (uploaded once).

    All seven per-edge fields live in ONE int32 row table (``edge_packed``),
    so the expansion makes one row gather where it would make seven. In the
    QUANTIZED (superrow) layout each molecule's edge block is padded to a
    multiple of r_edge rows (zeros) and the table ships pre-reshaped to
    [sum_e_q/r_edge, r_edge*8] so the expansion gathers 1KB superrows (the
    JAX package chose this layout for the TPU's gathers; the port keeps it,
    so both packages lay out the same batch). ``feat`` likewise:
    [sum_n_q/r_node, r_node*F]. Logical columns of a packed edge row:

      0  src      molecule-local src id (edges dst-sorted per molecule)
      1  dst      molecule-local dst id
      2  w        GCN weight, float32 bits
      3  sperm    local position (within the molecule's edge block) of the
                  j-th smallest local src in that block — expansion turns
                  this into the GLOBAL src-sort permutation of the batch
                  edge list, so the SpMM backward scatter needs no device
                  sort (ops/pallas/spmm.py)
      4  ssorted  local src value at src-sorted position j (transposed dst)
      5  tdst     local dst value at src-sorted position j (transposed src)
      6  tw       weight at src-sorted position j, float32 bits
      7  padding
    """

    mol_ptr: np.ndarray  # [D_total+1] QUANTIZED node offsets (r_node mult.)
    mol_eptr: np.ndarray  # [D_total+1] QUANTIZED edge offsets (incl loops)
    mol_ncnt: np.ndarray  # [D_total] int32 exact node counts
    mol_ecnt: np.ndarray  # [D_total] int32 exact edge counts
    feat: np.ndarray  # [sum_n_q/r_node, r_node*F]
    edge_packed: np.ndarray  # [sum_e_q/r_edge, r_edge*8] int32 — see above
    # [num_drugs] 1/sqrt(max(outer degree, 1)) — lets the trainer derive
    # outer GCN edge weights on device instead of shipping them per step
    inv_sqrt_deg: np.ndarray | None = None


@dataclasses.dataclass
class HierarchicalBatch(_Container):
    """One step's sampled data; every field has static shape."""

    # molecule union of the sampled drugs (local drug slot = graph id)
    node_feat: np.ndarray  # [node_cap, F]
    edge_src: np.ndarray  # [edge_cap]
    edge_dst: np.ndarray  # [edge_cap] sorted; pad -> node_cap
    edge_weight: np.ndarray  # [edge_cap]
    graph_ids: np.ndarray  # [node_cap]; pad -> drug_budget
    graph_n_nodes: np.ndarray  # [drug_budget]
    edge_src_perm: np.ndarray  # [edge_cap] argsort(edge_src)
    edge_src_sorted: np.ndarray  # [edge_cap]
    # sampled outer subgraph (local drug slots)
    outer_src: np.ndarray  # [outer_edge_cap]
    outer_dst: np.ndarray  # [outer_edge_cap] sorted; pad -> drug_budget
    outer_weight: np.ndarray  # [outer_edge_cap]
    outer_src_perm: np.ndarray  # [outer_edge_cap]
    outer_src_sorted: np.ndarray  # [outer_edge_cap]
    # scoring pairs (local slots) + labels
    pairs: np.ndarray  # [pair_cap, 2]
    labels: np.ndarray  # [pair_cap]
    mask: np.ndarray  # [pair_cap]
    drug_budget: int
    node_cap: int
    edge_cap: int
    outer_edge_cap: int


class HierarchicalSampler:
    """Host-side sampler producing fixed-shape HierarchicalBatch records."""

    def __init__(
        self,
        ds: DDIDataset,
        batch_size: int = 256,
        neg_ratio: int = 1,
        fanouts: tuple[int, ...] = (10,),
        seed: int = 0,
        max_drugs: int | None = None,
        calibrate_caps: int = 8,
        quantize: bool = True,
        superrows: tuple[int, int] | None = None,
    ):
        """``max_drugs`` caps the per-batch drug budget (and with it every
        derived cap); beyond it the BFS node list is truncated — seeds come
        first, so scoring pairs are never dropped, only far neighbors. The
        default (None) uses the worst-case fanout expansion, which saturates
        at num_drugs for deep fanouts on large graphs — set a budget there
        (config #4 does).

        Static caps are STATISTICAL, not worst-case: per-batch node/edge
        totals are sums over thousands of sampled molecules, so they
        concentrate tightly (CLT) — the edge cap tracks mean + 8 sigma
        instead of drug_budget * max_molecule_edges (2.4x smaller at
        config-#4 scale, and every EC-proportional device cost shrinks with
        it). Overflow is handled by seed-preserving prefix truncation in
        _subgraph_from_pairs: far neighbors are dropped, scoring pairs
        never. ``calibrate_caps`` > 0 additionally draws that many throwaway
        batches at init to bound the outer-subgraph edge cap empirically
        (its dedup/filter pipeline has no tight closed form); 0 keeps the
        worst-case outer cap."""
        self.ds = ds
        self.batch_size = batch_size
        self.neg_ratio = neg_ratio
        self.fanouts = tuple(fanouts)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self.num_nodes = ds.num_drugs

        train = ds.split_edges("train").astype(np.int64)
        # undirected CSR over train edges (host adjacency for sampling)
        u = np.concatenate([train[:, 0], train[:, 1]])
        v = np.concatenate([train[:, 1], train[:, 0]])
        order = np.argsort(u, kind="stable")
        self._adj_dst = v[order].astype(np.int32)
        self._adj_ptr = np.zeros(self.num_nodes + 1, np.int64)
        np.add.at(self._adj_ptr, u + 1, 1)
        self._adj_ptr = np.cumsum(self._adj_ptr)
        self.train_pairs = train

        # pre-concatenated molecule arrays: per-batch unions become ragged
        # gathers instead of per-molecule Python work (critical-path at
        # config-#4 scale)
        self._mol_ptr = np.cumsum(
            [0] + [m.num_nodes for m in ds.molecules]
        ).astype(np.int64)
        self._mol_eptr = np.cumsum(
            [0] + [m.num_edges for m in ds.molecules]
        ).astype(np.int64)
        self._all_feat = np.concatenate(
            [m.node_feat for m in ds.molecules]
        ).astype(np.float32)
        # edge endpoints are molecule-local ids
        self._all_src = np.concatenate(
            [np.asarray(m.src, np.int64) for m in ds.molecules]
        )
        self._all_dst = np.concatenate(
            [np.asarray(m.dst, np.int64) for m in ds.molecules]
        )

        # per-molecule dst-sorted edges + self-loops + GCN weights, built as
        # ONE disjoint union (molecules are disconnected, so degrees — and
        # thus weights — are molecule-local). Because the union is globally
        # dst-sorted and molecules occupy contiguous id ranges, each
        # molecule's block is a contiguous slice, recoverable by one
        # searchsorted. These tables live on device in the resident path.
        e_counts = np.diff(self._mol_eptr)
        g_src = self._all_src + np.repeat(self._mol_ptr[:-1], e_counts)
        g_dst = self._all_dst + np.repeat(self._mol_ptr[:-1], e_counts)
        s_g, d_g, w_g = _build_sorted(
            g_src, g_dst, int(self._mol_ptr[-1]), True, True
        )
        tbl_eptr_x = np.searchsorted(d_g, self._mol_ptr).astype(np.int64)
        owner = np.repeat(
            np.arange(self.num_nodes, dtype=np.int64), np.diff(tbl_eptr_x)
        )
        tbl_src = (s_g - self._mol_ptr[owner]).astype(np.int32)
        tbl_dst = (d_g - self._mol_ptr[owner]).astype(np.int32)
        tbl_w = w_g.astype(np.float32)
        # per-molecule source-sort tables (see MoleculeTables): sort edges by
        # (owner, local src) in one pass; owner grouping is preserved, so each
        # block's slice is its local src-sorted order.
        key = owner * np.int64(self._mol_ptr[-1] + 1) + tbl_src
        order = np.argsort(key, kind="stable")
        tbl_sperm = (order - tbl_eptr_x[owner]).astype(np.int32)
        tbl_ssorted = tbl_src[order].astype(np.int32)

        # --- superrow quantization (MoleculeTables doc) -------------------
        # every molecule's table block is padded to a multiple of R rows, so
        # the expansion gathers [R*width]-wide superrows. Quantized layouts
        # put masked padding edges BETWEEN molecules, which breaks global
        # dst-sortedness — only valid when every inner conv consumes the
        # block-local plan; other models pass quantize=False.
        max_atoms = max(m.num_nodes for m in ds.molecules)
        self.block_local = max_atoms <= 128
        self.quantized = bool(quantize) and self.block_local
        # superrow granularity (MoleculeTables doc): wider superrows mean
        # fewer rows to gather but more padding; (4, 32) is the JAX
        # package's choice for config4, kept so the layouts agree
        r_n, r_e = superrows if superrows is not None else (4, 32)
        self.r_node = r_n if self.quantized else 1
        self.r_edge = r_e if self.quantized else 1

        def _quantize_ptr(ptr, r):
            cnt = np.diff(ptr)
            qcnt = -(-cnt // r) * r
            qptr = np.zeros_like(ptr)
            np.cumsum(qcnt, out=qptr[1:])
            return qptr, cnt.astype(np.int32)

        self._tbl_eptr, self.mol_edge_counts = _quantize_ptr(
            tbl_eptr_x, self.r_edge)
        new_e = self._tbl_eptr[owner] + (
            np.arange(len(tbl_src), dtype=np.int64) - tbl_eptr_x[owner])
        # one packed row table for all per-edge fields, padding rows zero
        self._tbl_packed = np.zeros((int(self._tbl_eptr[-1]), 8), np.int32)
        self._tbl_packed[new_e, 0] = tbl_src
        self._tbl_packed[new_e, 1] = tbl_dst
        self._tbl_packed[new_e, 2] = tbl_w.view(np.int32)
        self._tbl_packed[new_e, 3] = tbl_sperm
        self._tbl_packed[new_e, 4] = tbl_ssorted
        self._tbl_packed[new_e, 5] = tbl_dst[order]
        self._tbl_packed[new_e, 6] = tbl_w[order].view(np.int32)
        # quantized node table (exact _mol_ptr/_all_feat stay, for the
        # non-resident host-gather path)
        self._mol_qptr, self.mol_node_counts = _quantize_ptr(
            self._mol_ptr, self.r_node)
        if self.quantized:
            new_n = self._mol_qptr[owner_n := np.repeat(
                np.arange(self.num_nodes, dtype=np.int64),
                self.mol_node_counts)] + (
                np.arange(len(self._all_feat), dtype=np.int64)
                - self._mol_ptr[owner_n])
            self._feat_tbl = np.zeros(
                (int(self._mol_qptr[-1]), self._all_feat.shape[1]), np.float32)
            self._feat_tbl[new_n] = self._all_feat
        else:
            self._feat_tbl = self._all_feat
        # global degrees for GCN weights (self-loops counted, matching
        # formats.gcn_normalize on the full train graph)
        deg = np.bincount(np.concatenate([u, np.arange(self.num_nodes)]),
                          minlength=self.num_nodes).astype(np.float64)
        self._inv_sqrt_deg = (1.0 / np.sqrt(np.maximum(deg, 1.0))).astype(np.float32)

        # truncation observability: every cap-overflow drop in
        # _subgraph_from_pairs is counted here so a too-tight statistical cap
        # can never degrade accuracy invisibly ("no silent caps"). Counters
        # are reset after cap calibration and surfaced per-epoch by
        # MinibatchTrainer via truncation_stats().
        self._trunc_lock = threading.Lock()
        self.truncation = {
            "trunc_batches": 0,
            "trunc_nodes_dropped": 0,
            "trunc_outer_edges_dropped": 0,
            "batches_sampled": 0,
        }

        # ---- static caps -------------------------------------------------
        seeds = batch_size * 2 * (1 + neg_ratio)
        budget = seeds
        frontier = seeds
        tree_edges = 0
        for f in self.fanouts:
            tree_edges += frontier * f
            frontier = frontier * f
            budget += frontier
        if max_drugs is not None:
            budget = min(budget, max_drugs)
        self.drug_budget = max(min(budget, self.num_nodes), seeds)
        # block-local layout (ops/pallas/block_spmm.py): molecules <= 128
        # atoms are packed whole into 128-row blocks by the resident
        # expansion, so the fused in-VMEM SpMM kernel applies. node_cap must
        # absorb the packing gaps: at least floor(128/max_qatoms) molecules
        # always fit per block. All sizes here are r_node/r_edge-QUANTIZED
        # (superrow layout) — exact for r = 1.
        max_qatoms = int(np.diff(self._mol_qptr).max())
        max_qe = int(np.diff(self._tbl_eptr).max())
        if self.block_local:
            per_block = max(128 // max_qatoms, 1)
            self.mols_per_block = per_block
            self.node_cap = _round_up(-(-self.drug_budget // per_block) * 128, 8)
        else:
            self.node_cap = _round_up(self.drug_budget * max_qatoms, 8)
        self.edge_cap = _round_up(self.drug_budget * max_qe, 128)
        # statistical edge cap (class doc): min with the dense worst case so
        # small datasets keep exact bounds and never truncate
        e_per_all = np.diff(self._tbl_eptr)
        stat_e = int(
            self.drug_budget * float(e_per_all.mean())
            + 8.0 * float(e_per_all.std()) * np.sqrt(self.drug_budget)
            + float(e_per_all.max())
        )
        self.edge_cap = min(self.edge_cap, _round_up(stat_e, 128))
        if not self.block_local:
            n_per_all = np.diff(self._mol_qptr)
            stat_n = int(
                self.drug_budget * float(n_per_all.mean())
                + 8.0 * float(n_per_all.std()) * np.sqrt(self.drug_budget)
                + float(n_per_all.max())
            )
            self.node_cap = min(self.node_cap, _round_up(stat_n, 8))
        # sampled tree edges (both directions) + self loops
        self.outer_edge_cap = _round_up(2 * tree_edges + self.drug_budget, 128)
        if calibrate_caps:
            rng_c = np.random.default_rng(seed + 0xC0FFEE)
            max_oe, max_ext = 0, 0
            for _ in range(calibrate_caps):
                pairs, labels = self._draw_pairs(rng_c)
                nodes_c, su, _, _, _, _, _, off_c = self._subgraph_from_pairs(
                    pairs, labels)
                max_oe = max(max_oe, len(su))
                if off_c is not None and len(off_c):
                    last_n = int(
                        self._mol_qptr[nodes_c[-1] + 1]
                        - self._mol_qptr[nodes_c[-1]])
                    max_ext = max(max_ext, int(off_c[-1]) + last_n)
            self.outer_edge_cap = min(
                self.outer_edge_cap,
                _round_up(int(max_oe * 1.15) + 2 * self.batch_size + 128, 128),
            )
            if self.block_local and max_ext:
                # greedy-packed node extent concentrates like the edge total;
                # keep a multiple of 128 (the block grid granule)
                self.node_cap = min(
                    self.node_cap, _round_up(int(max_ext * 1.08) + 256, 128))
            self.reset_truncation_stats()  # calibration draws don't count

    def reseed(self, epoch_idx: int) -> None:
        """Make all draws from now on a pure function of (seed, epoch_idx).

        Called by MinibatchTrainer at each epoch start so the sampled
        trajectory is reproducible from (seed, epoch) alone — exact
        checkpoint-resume then needs no host-RNG state serialization, and
        eval-time draws (which advance the rng) can't perturb training."""
        self._rng = np.random.default_rng((self.seed, epoch_idx))

    def _count(self, key: str, val: int) -> None:
        """Thread-safe truncation-counter increment (batches may be sampled
        concurrently on prefetch workers)."""
        with self._trunc_lock:
            self.truncation[key] += val

    def truncation_stats(self, reset: bool = False) -> dict:
        """Per-epoch truncation counters (copy); ``reset`` zeroes them."""
        with self._trunc_lock:
            out = dict(self.truncation)
            if reset:
                self.truncation = {k: 0 for k in self.truncation}
        return out

    def reset_truncation_stats(self) -> None:
        self.truncation = {k: 0 for k in self.truncation}

    def __len__(self) -> int:
        return -(-len(self.train_pairs) // self.batch_size)

    # ------------------------------------------------------------------
    def _sample_neighbors(self, seeds: np.ndarray, rng=None):
        """Per-hop fanout sampling; returns (nodes, edges (global u->v)).

        Fully vectorized (no per-node Python loop — at config-#4 scale the
        host sampler sits in the training step's critical path): each hop
        draws ``fanout`` neighbors per frontier node with replacement when
        the degree exceeds the fanout, and takes the whole neighborhood
        otherwise (deduplicated via the canonical-pair dedup downstream).
        """
        rng = rng if rng is not None else self._rng
        budget = self.drug_budget
        nodes = np.unique(seeds)
        seen = np.zeros(self.num_nodes, bool)
        seen[nodes] = True
        order = [nodes]
        frontier = nodes[:budget]
        total = len(frontier)
        dropped = max(len(nodes) - budget, 0)
        es_all, ed_all = [], []
        for fanout in self.fanouts:
            if len(frontier) == 0:
                break
            lo = self._adj_ptr[frontier]
            deg = self._adj_ptr[frontier + 1] - lo
            has = deg > 0
            f, lo_f, deg_f = frontier[has], lo[has], deg[has]
            if len(f) == 0:
                break
            # small-degree nodes contribute full neighborhoods
            small = deg_f <= fanout
            es_parts, ed_parts = [], []
            if small.any():
                reps = deg_f[small].astype(np.int64)
                ed_parts.append(np.repeat(f[small], reps))
                idx = (
                    np.repeat(lo_f[small], reps)
                    + _ragged_arange(reps)
                )
                es_parts.append(self._adj_dst[idx].astype(np.int64))
            big = ~small
            if big.any():
                nb = int(big.sum())
                draw = rng.integers(0, deg_f[big][:, None], (nb, fanout))
                idx = (lo_f[big][:, None] + draw).reshape(-1)
                es_parts.append(self._adj_dst[idx].astype(np.int64))
                ed_parts.append(np.repeat(f[big], fanout))
            es = np.concatenate(es_parts)
            ed = np.concatenate(ed_parts)
            es_all.append(es)
            ed_all.append(ed)
            new = np.unique(es[~seen[es]])
            # Budget-aware frontier: drug_budget prefix-truncates the node
            # list downstream anyway (seed-preserving, BFS order), and an
            # edge both of whose endpoints aren't kept is filtered there
            # too — so expanding a beyond-budget node is provably wasted
            # host work (its edges can never survive: one endpoint is the
            # truncated node itself). Capping here keeps the node set
            # bit-identical to post-hoc truncation (np.unique order == the
            # prefix order) and roughly halves sampling cost at config-#4
            # scale. Dropped counts still feed the truncation counters.
            # COUNTER SEMANTICS: once the budget is exhausted the frontier
            # empties and later hops are never expanded, so n_sampled /
            # trunc_nodes_dropped are LOWER BOUNDS relative to a full
            # expansion — don't compare truncation stats across versions
            # that expanded every hop before truncating.
            keep = min(len(new), budget - total)
            dropped += len(new) - keep
            new = new[:keep]
            total += keep
            seen[new] = True
            order.append(new)
            frontier = new
        nodes_out = np.concatenate(order)
        es = np.concatenate(es_all) if es_all else np.zeros(0, np.int64)
        ed = np.concatenate(ed_all) if ed_all else np.zeros(0, np.int64)
        return nodes_out, es, ed, dropped

    @property
    def pair_cap(self) -> int:
        return self.batch_size * (1 + self.neg_ratio)

    def _draw_pairs(self, rng=None) -> tuple[np.ndarray, np.ndarray]:
        """Positive minibatch + host-sampled negative corruptions."""
        rng = rng if rng is not None else self._rng
        bs = self.batch_size
        idx = rng.choice(len(self.train_pairs), bs, replace=len(self.train_pairs) < bs)
        pos = self.train_pairs[idx]
        negs = []
        for _ in range(self.neg_ratio):
            corrupt_right = rng.random(bs) < 0.5
            rand = rng.integers(0, self.num_nodes, bs)
            nu = np.where(corrupt_right, pos[:, 0], rand)
            nv = np.where(corrupt_right, rand, pos[:, 1])
            negs.append(np.stack([nu, nv], 1))
        all_pairs = np.concatenate([pos] + negs, axis=0)
        labels = np.concatenate(
            [np.ones(bs, np.float32), np.zeros(bs * self.neg_ratio, np.float32)]
        )
        return all_pairs, labels

    def sample(self) -> HierarchicalBatch:
        return self.batch_from_pairs(*self._draw_pairs())

    def sample_at(self, epoch: int, idx: int) -> HierarchicalBatch:
        """Batch ``idx`` of epoch ``epoch`` — a pure function of
        (seed, epoch, idx), independent of call order, so batches can be
        drawn CONCURRENTLY on worker threads (data/prefetch.py) with a
        deterministic, resumable trajectory."""
        rng = np.random.default_rng((self.seed, epoch, idx))
        return self.batch_from_pairs(*self._draw_pairs(rng), rng=rng)

    def sample_compact_at(self, epoch: int, idx: int) -> CompactBatch:
        """Indexed (order-independent) variant of sample_compact; see
        sample_at."""
        rng = np.random.default_rng((self.seed, epoch, idx))
        return self.compact_from_pairs(*self._draw_pairs(rng), rng=rng)

    def _subgraph_from_pairs(self, all_pairs: np.ndarray, labels: np.ndarray,
                             rng=None):
        """Shared front half: pad pairs, sample the neighborhood, build the
        (deduped, dst-sorted) outer subgraph and localized pairs."""
        p = all_pairs.shape[0]
        if p > self.pair_cap:
            raise ValueError(f"{p} pairs > pair_cap {self.pair_cap}")
        pad_mask = np.zeros(self.pair_cap, np.float32)
        pad_mask[:p] = 1.0
        if p < self.pair_cap:
            all_pairs = np.concatenate(
                [all_pairs, np.zeros((self.pair_cap - p, 2), all_pairs.dtype)]
            )
            labels = np.concatenate([labels, np.zeros(self.pair_cap - p, np.float32)])

        seeds = np.unique(all_pairs.reshape(-1))
        nodes, es, ed, hop_dropped = self._sample_neighbors(seeds, rng)
        n_sampled = len(nodes) + hop_dropped
        self._count("batches_sampled", 1)
        if len(nodes) > self.drug_budget:  # cap overflow: keep seeds first
            nodes = nodes[: self.drug_budget]
        # seed-preserving prefix truncation against the statistical caps:
        # BFS order puts seeds first, so only far neighbors are dropped
        e_cum = np.cumsum(self._tbl_eptr[nodes + 1] - self._tbl_eptr[nodes])
        keep = int(np.searchsorted(e_cum, self.edge_cap, side="right"))
        off = None
        if self.block_local:
            # host greedy packing of (quantized) molecules into 128-row
            # blocks (the block-local SpMM layout); node truncation = the
            # longest packed prefix whose extent fits node_cap (end offsets
            # are monotone)
            sizes = (self._mol_qptr[nodes + 1] - self._mol_qptr[nodes])
            off, _ = native.greedy_pack_blocks(sizes.astype(np.int32), 128)
            ends = off + sizes.astype(np.int32)
            keep = min(keep, int(np.searchsorted(ends, self.node_cap,
                                                 side="right")))
        else:
            n_cum = np.cumsum(self._mol_qptr[nodes + 1] - self._mol_qptr[nodes])
            keep = min(keep, int(np.searchsorted(n_cum, self.node_cap,
                                                 side="right")))
        if keep < len(nodes):
            if keep < len(seeds):
                raise ValueError(
                    f"node/edge caps too small for the {len(seeds)}-seed set")
            nodes = nodes[:keep]
            if off is not None:
                off = off[:keep]
        if len(nodes) < n_sampled:
            self._count("trunc_nodes_dropped", n_sampled - len(nodes))
            self._count("trunc_batches", 1)
        n_loc = len(nodes)
        local_arr = np.full(self.num_nodes, -1, np.int64)
        local_arr[nodes] = np.arange(n_loc)

        # outer subgraph edges (sampled tree, both directions, + self loops),
        # weights from global degrees. Deduplicate as undirected pairs first:
        # an edge collected from both endpoints' frontiers (or in two hops)
        # must not aggregate twice. Fully vectorized.
        la, lb = local_arr[es], local_arr[ed]
        ok = (la >= 0) & (lb >= 0) & (la != lb)
        lo_p = np.minimum(la[ok], lb[ok])
        hi_p = np.maximum(la[ok], lb[ok])
        key = np.unique(lo_p * n_loc + hi_p)
        p0, p1 = key // n_loc, key % n_loc
        loops = np.arange(n_loc, dtype=np.int64)
        su = np.concatenate([p0, p1, loops])
        sv = np.concatenate([p1, p0, loops])
        gw = self._inv_sqrt_deg[nodes]
        w = gw[su] * gw[sv]
        order = np.argsort(sv, kind="stable")
        su, sv, w = su[order], sv[order], w[order].astype(np.float32)
        oe_cap = self.outer_edge_cap
        if len(su) > oe_cap:
            self._count("trunc_outer_edges_dropped", len(su) - oe_cap)
            self._count("trunc_batches", 1)
            su, sv, w = su[:oe_cap], sv[:oe_cap], w[:oe_cap]

        pa = local_arr[all_pairs[:, 0]]
        pb = local_arr[all_pairs[:, 1]]
        valid = ((pa >= 0) & (pb >= 0)).astype(np.float32) * pad_mask
        pairs_local = np.stack(
            [np.maximum(pa, 0), np.maximum(pb, 0)], axis=1
        ).astype(np.int32)
        return nodes, su, sv, w, pairs_local, labels, valid, off

    def batch_from_pairs(
        self, all_pairs: np.ndarray, labels: np.ndarray, rng=None
    ) -> HierarchicalBatch:
        """Fixed-shape batch with host-gathered molecule arrays — used where
        the data is small or device tables are not set up; see
        compact_from_pairs for the device-resident path."""
        nodes, su, sv, w, pairs_local, labels, valid, _ = (
            self._subgraph_from_pairs(all_pairs, labels, rng))
        n_loc = len(nodes)
        oe_cap = self.outer_edge_cap

        # molecule union of sampled drugs (ragged gathers from the
        # pre-concatenated arrays)
        n_per = (self._mol_ptr[nodes + 1] - self._mol_ptr[nodes]).astype(np.int64)
        node_rows = np.repeat(self._mol_ptr[nodes], n_per) + _ragged_arange(n_per)
        feats = self._all_feat[node_rows]
        gids_v = np.repeat(np.arange(n_loc, dtype=np.int32), n_per)
        node_off = np.concatenate([[0], np.cumsum(n_per)[:-1]])
        e_per = (self._mol_eptr[nodes + 1] - self._mol_eptr[nodes]).astype(np.int64)
        edge_rows = np.repeat(self._mol_eptr[nodes], e_per) + _ragged_arange(e_per)
        edge_off = np.repeat(node_off, e_per)
        msrc = self._all_src[edge_rows] + edge_off
        mdst = self._all_dst[edge_rows] + edge_off
        off = int(n_per.sum())
        ms, md, mw = _build_sorted(msrc, mdst, off, True, True)

        D, NC, EC = self.drug_budget, self.node_cap, self.edge_cap

        def pad(x, cap, fill, dtype=None):
            out = np.full((cap,) + x.shape[1:], fill, dtype or x.dtype)
            out[: len(x)] = x
            return out

        edge_src_p = pad(ms.astype(np.int32), EC, 0)
        sperm, ssorted = src_sort_arrays(edge_src_p)
        outer_src_p = pad(su.astype(np.int32), oe_cap, 0)
        osperm, ossorted = src_sort_arrays(outer_src_p)
        return HierarchicalBatch(
            node_feat=pad(feats.astype(np.float32), NC, 0.0),
            edge_src=edge_src_p,
            edge_dst=pad(md.astype(np.int32), EC, NC),
            edge_weight=pad(mw, EC, 0.0),
            edge_src_perm=sperm,
            edge_src_sorted=ssorted,
            graph_ids=pad(gids_v, NC, D),
            graph_n_nodes=pad(n_per.astype(np.float32), D, 0.0),
            outer_src=outer_src_p,
            outer_dst=pad(sv.astype(np.int32), oe_cap, D),
            outer_weight=pad(w, oe_cap, 0.0),
            outer_src_perm=osperm,
            outer_src_sorted=ossorted,
            pairs=pairs_local,
            labels=labels,
            mask=valid,
            drug_budget=D,
            node_cap=NC,
            edge_cap=EC,
            outer_edge_cap=oe_cap,
        )

    # ------------------------------------------------------------------
    # device-resident-table path
    # ------------------------------------------------------------------
    def tables(self) -> MoleculeTables:
        """The static per-molecule tables (upload once, device-resident)."""
        f = self._feat_tbl.shape[1]
        return MoleculeTables(
            mol_ptr=self._mol_qptr,
            mol_eptr=self._tbl_eptr,
            mol_ncnt=self.mol_node_counts,
            mol_ecnt=self.mol_edge_counts,
            feat=self._feat_tbl.reshape(-1, self.r_node * f),
            # FIELD-MAJOR within each superrow: [32 src][32 dst][32 w]... —
            # device-side field extraction becomes a contiguous slice
            # instead of a stride-8 column read (a [EC,8] transpose that
            # cost ~8 ms/step at config-#4 scale when the unpacked columns
            # materialized for the SpMM kernel).
            inv_sqrt_deg=self._inv_sqrt_deg,
            edge_packed=self._tbl_packed.reshape(-1, self.r_edge, 8)
            .transpose(0, 2, 1)
            .reshape(-1, 8 * self.r_edge),
        )

    def compact_from_pairs(
        self, all_pairs: np.ndarray, labels: np.ndarray, rng=None
    ) -> CompactBatch:
        """Index-only batch: per-step H2D is nodes + outer subgraph + pairs."""
        nodes, su, sv, w, pairs_local, labels, valid, off = (
            self._subgraph_from_pairs(all_pairs, labels, rng))
        return self._compact_assemble(
            nodes, su, sv, w, pairs_local, labels, valid, off)

    def _compact_assemble(
        self, nodes, su, sv, w, pairs_local, labels, valid, off
    ) -> CompactBatch:
        D, oe_cap = self.drug_budget, self.outer_edge_cap

        def pad(x, cap, fill, dtype=None):
            out = np.full((cap,) + x.shape[1:], fill, dtype or x.dtype)
            out[: len(x)] = x
            return out

        # int16 slot ids + device-derived weight/perm/sorted: see the
        # CompactBatch field comments (H2D minimization)
        idt = np.int16 if D <= np.iinfo(np.int16).max else np.int32
        if off is not None:
            # block b's first slot (for block edge ranges on device); blocks
            # past the packed extent map to n_loc -> empty edge ranges
            nblocks = self.node_cap // 128
            blk_of_slot = off.astype(np.int64) // 128
            block_slot0 = np.searchsorted(
                blk_of_slot, np.arange(nblocks + 1), side="left"
            ).astype(np.int32)
            pack_off = pad(off, D, int(off[-1]) if len(off) else 0)
        else:
            pack_off = np.zeros(D, np.int32)
            block_slot0 = np.zeros(1, np.int32)
        return CompactBatch(
            nodes=pad(nodes.astype(np.int32), D, 0),
            n_real=np.asarray(len(nodes), np.int32),
            pack_off=pack_off,
            block_slot0=block_slot0,
            outer_src=pad(su.astype(idt), oe_cap, 0),
            outer_dst=pad(sv.astype(idt), oe_cap, D),
            outer_weight=None,
            outer_src_perm=None,
            outer_src_sorted=None,
            pairs=pairs_local.astype(idt),
            labels=labels,
            mask=valid,
            drug_budget=D,
            node_cap=self.node_cap,
            edge_cap=self.edge_cap,
            outer_edge_cap=oe_cap,
        )

    def sample_compact(self) -> CompactBatch:
        return self.compact_from_pairs(*self._draw_pairs())

    def compact_chunks_all_nodes(self):
        """Yield (CompactBatch, global drug ids) covering EVERY drug exactly
        once, in id order, with empty outer subgraph and pair slots.

        These are the inner-encode chunks of the exact (full-propagation)
        evaluation path (MinibatchTrainer.evaluate(exact=True)): unlike
        training batches, chunk membership is deterministic — each chunk is
        the longest id-order prefix that fits the sampler's static caps, so
        every chunk reuses the one compiled expansion/encode computation.
        """
        D = self.drug_budget
        all_nodes = np.arange(self.num_nodes, dtype=np.int64)
        empty_i = np.zeros(0, np.int64)
        empty_f = np.zeros(0, np.float32)
        pairs0 = np.zeros((self.pair_cap, 2), np.int32)
        zeros_p = np.zeros(self.pair_cap, np.float32)
        start = 0
        while start < self.num_nodes:
            cand = all_nodes[start : start + D]
            e_cum = np.cumsum(self._tbl_eptr[cand + 1] - self._tbl_eptr[cand])
            keep = int(np.searchsorted(e_cum, self.edge_cap, side="right"))
            off = None
            if self.block_local:
                sizes = self._mol_qptr[cand + 1] - self._mol_qptr[cand]
                off, _ = native.greedy_pack_blocks(sizes.astype(np.int32), 128)
                ends = off + sizes.astype(np.int32)
                keep = min(keep, int(np.searchsorted(
                    ends, self.node_cap, side="right")))
            else:
                n_cum = np.cumsum(
                    self._mol_qptr[cand + 1] - self._mol_qptr[cand])
                keep = min(keep, int(np.searchsorted(
                    n_cum, self.node_cap, side="right")))
            if keep == 0:
                raise ValueError(
                    f"caps too small to encode drug {start} on its own")
            nodes = cand[:keep]
            if off is not None:
                off = off[:keep]
            cb = self._compact_assemble(
                nodes, empty_i, empty_i, empty_f, pairs0, zeros_p, zeros_p,
                off)
            yield cb, nodes
            start += keep
