"""Synthetic graph-of-graphs generator (counterpart of
``bignn_tpu/data/synthetic.py``; the same NumPy draws, so the same seed
gives the same dataset bit for bit).

Each drug gets a latent vector z; DDI edges are the highest-scoring random
pairs by z_u . z_v, and each molecule's atom types are tilted by its z, so
an inner GNN that pools atom types can recover z.
"""

from __future__ import annotations

import numpy as np

from bignn_tpu_torch.data.schema import DDIDataset, random_split
from bignn_tpu_torch.sparse.formats import COOGraph

_TYPE_PROJ_CACHE: dict[tuple[int, int], np.ndarray] = {}


def _type_projection(feat_dim: int, k: int) -> np.ndarray:
    key = (feat_dim, k)
    if key not in _TYPE_PROJ_CACHE:
        rng = np.random.default_rng(12345)
        _TYPE_PROJ_CACHE[key] = (
            rng.normal(size=(feat_dim, k)).astype(np.float64) * 2.0)
    return _TYPE_PROJ_CACHE[key]


def _ragged_local_index(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    out = np.arange(total, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return out - np.repeat(offsets, counts)


def _random_molecules_vectorized(
    rng: np.random.Generator,
    z: np.ndarray,  # [D, k]
    feat_dim: int,
    min_atoms: int,
    max_atoms: int,
    extra_edge_frac: float = 0.3,
) -> list[COOGraph]:
    """All drugs' molecules in one vectorized pass: a random spanning tree
    plus extra edges each, atom types by Gumbel-max over softmax(W z)."""
    num_drugs = z.shape[0]
    ns = rng.integers(min_atoms, max_atoms + 1, num_drugs).astype(np.int64)
    total_atoms = int(ns.sum())
    owner = np.repeat(np.arange(num_drugs, dtype=np.int64), ns)
    local = _ragged_local_index(ns)

    # spanning tree: local atom i >= 1 attaches to a uniform earlier atom
    tree_mask = local >= 1
    parent = np.floor(rng.random(total_atoms) * np.maximum(local, 1)).astype(
        np.int64)
    t_owner = owner[tree_mask]
    t_src = local[tree_mask]
    t_dst = parent[tree_mask]

    # extra edges: floor(n * frac) per drug, uniform endpoint pairs, es != ed
    n_extra = (ns * extra_edge_frac).astype(np.int64)
    e_owner = np.repeat(np.arange(num_drugs, dtype=np.int64), n_extra)
    n_of = ns[e_owner]
    es = np.floor(rng.random(len(e_owner)) * n_of).astype(np.int64)
    ed = np.floor(rng.random(len(e_owner)) * n_of).astype(np.int64)
    keep = es != ed
    e_owner, es, ed = e_owner[keep], es[keep], ed[keep]

    # both directions, grouped by owner (stable sort keeps determinism)
    all_owner = np.concatenate([t_owner, e_owner, t_owner, e_owner])
    all_src = np.concatenate([t_src, es, t_dst, ed])
    all_dst = np.concatenate([t_dst, ed, t_src, es])
    order = np.argsort(all_owner, kind="stable")
    all_owner = all_owner[order]
    all_src = all_src[order]
    all_dst = all_dst[order]
    e_counts = np.bincount(all_owner, minlength=num_drugs).astype(np.int64)
    e_off = np.concatenate([[0], np.cumsum(e_counts)])

    k = z.shape[1]
    w = _type_projection(feat_dim, k)
    logits = z @ w.T  # [D, feat_dim]
    gumbel = -np.log(-np.log(rng.random((total_atoms, feat_dim)) + 1e-12)
                     + 1e-12)
    types = np.argmax(logits[owner] + gumbel, axis=1)
    feat = np.zeros((total_atoms, feat_dim), np.float32)
    feat[np.arange(total_atoms), types] = 1.0
    n_off = np.concatenate([[0], np.cumsum(ns)])

    return [
        COOGraph(
            node_feat=feat[n_off[i]:n_off[i + 1]],
            src=all_src[e_off[i]:e_off[i + 1]],
            dst=all_dst[e_off[i]:e_off[i + 1]],
        )
        for i in range(num_drugs)
    ]


def make_synthetic_ddi(
    num_drugs: int = 500,
    feat_dim: int = 16,
    latent_dim: int = 4,
    avg_degree: float = 8.0,
    min_atoms: int = 6,
    max_atoms: int = 24,
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 0,
    name: str = "synthetic",
) -> DDIDataset:
    """Generate a planted-signal DDI dataset: of ~3x oversampled random
    candidate pairs, keep the top ``num_drugs * avg_degree / 2`` by
    z_u . z_v + noise, deduplicated."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(num_drugs, latent_dim)) / np.sqrt(latent_dim)
    z32 = z.astype(np.float32)

    target_edges = int(num_drugs * avg_degree / 2)
    max_pairs = num_drugs * (num_drugs - 1) // 2
    n_cand = min(target_edges * 3, max_pairs)
    cu = rng.integers(0, num_drugs, n_cand, dtype=np.int32)
    cv = rng.integers(0, num_drugs, n_cand, dtype=np.int32)
    lo = np.minimum(cu, cv)
    hi = np.maximum(cu, cv)
    self_loop = lo == hi
    hi[self_loop] = (lo[self_loop] + 1) % num_drugs
    cu, cv = np.minimum(lo, hi), np.maximum(lo, hi)
    scores = np.empty(n_cand, np.float32)
    chunk = 8_000_000
    for s0 in range(0, n_cand, chunk):
        s1 = min(s0 + chunk, n_cand)
        scores[s0:s1] = np.einsum("ij,ij->i", z32[cu[s0:s1]], z32[cv[s0:s1]])
    scores += 0.1 * rng.standard_normal(n_cand, dtype=np.float32)
    k = min(int(target_edges * 1.02), n_cand)  # small margin for dup loss
    top = np.argpartition(-scores, k - 1)[:k]
    top = top[np.argsort(-scores[top], kind="stable")]  # best first
    pair_key = cu[top].astype(np.int64) * num_drugs + cv[top]
    first = np.zeros(len(top), bool)
    first[np.unique(pair_key, return_index=True)[1]] = True
    top = top[first][:target_edges]
    edges = np.stack([cu[top], cv[top]], axis=1).astype(np.int64)

    molecules = _random_molecules_vectorized(
        rng, z, feat_dim, min_atoms, max_atoms)
    train_idx, val_idx, test_idx = random_split(
        edges.shape[0], val_frac, test_frac, seed)
    return DDIDataset(
        name=name,
        molecules=molecules,
        edges=edges,
        train_idx=train_idx,
        val_idx=val_idx,
        test_idx=test_idx,
    )
