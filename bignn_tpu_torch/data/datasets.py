"""Dataset registry and ``.npz`` cache (counterpart of
``bignn_tpu/data/datasets.py``).

  * ``synthetic-small`` / ``synthetic`` — ~500 generated drugs (config1).
  * ``ddi-sample`` — the in-repo real drugs and interactions
    (``data/real_sample.py``; config2-real).
  * ``synthetic-large`` — 100K generated drugs (config4; scale via kwargs).
  * ``drugbank`` / ``biosnap`` — ``<root>/<name>.npz`` when present; else a
    raw reference cache at ``<root>/<name>{.pkl,.pickle,/}``, converted to
    ``<root>/<name>.npz`` once (``data/convert.py``); else a generated
    stand-in with the dataset's size (~1.7K / ~1.5K drugs).

The ``.npz`` schema is the JAX package's (``edges``, ``mol_ptr``,
``mol_feat``, ``mol_edge_ptr``, ``mol_src``, ``mol_dst``, optional split
indices).
"""

from __future__ import annotations

import os

import numpy as np

from bignn_tpu_torch.data.schema import DDIDataset, random_split
from bignn_tpu_torch.data.synthetic import make_synthetic_ddi
from bignn_tpu_torch.sparse.formats import COOGraph

_STANDIN_SPECS = {
    "drugbank": dict(num_drugs=1704, avg_degree=222.0, feat_dim=64,
                     min_atoms=8, max_atoms=48, latent_dim=8),
    "biosnap": dict(num_drugs=1514, avg_degree=63.0, feat_dim=64,
                    min_atoms=8, max_atoms=48, latent_dim=8),
}


def load_npz_cache(path: str, name: str, seed: int = 0) -> DDIDataset:
    with np.load(path) as f:
        edges = f["edges"]
        mol_ptr = f["mol_ptr"]
        mol_feat = f["mol_feat"]
        mol_edge_ptr = f["mol_edge_ptr"]
        mol_src = f["mol_src"]
        mol_dst = f["mol_dst"]
        molecules = [
            COOGraph(
                node_feat=mol_feat[mol_ptr[i]:mol_ptr[i + 1]],
                src=mol_src[mol_edge_ptr[i]:mol_edge_ptr[i + 1]],
                dst=mol_dst[mol_edge_ptr[i]:mol_edge_ptr[i + 1]],
            )
            for i in range(len(mol_ptr) - 1)
        ]
        if "train_idx" in f:
            tr, va, te = f["train_idx"], f["val_idx"], f["test_idx"]
        else:
            tr, va, te = random_split(edges.shape[0], 0.1, 0.1, seed)
    return DDIDataset(name=name, molecules=molecules, edges=edges,
                      train_idx=tr, val_idx=va, test_idx=te)


def save_npz_cache(ds: DDIDataset, path: str) -> None:
    mol_ptr = np.cumsum([0] + [m.num_nodes for m in ds.molecules])
    mol_edge_ptr = np.cumsum([0] + [m.num_edges for m in ds.molecules])
    np.savez_compressed(
        path,
        edges=ds.edges,
        mol_ptr=mol_ptr.astype(np.int64),
        mol_feat=np.concatenate([m.node_feat for m in ds.molecules], axis=0),
        mol_edge_ptr=mol_edge_ptr.astype(np.int64),
        mol_src=np.concatenate([m.src for m in ds.molecules]),
        mol_dst=np.concatenate([m.dst for m in ds.molecules]),
        train_idx=ds.train_idx,
        val_idx=ds.val_idx,
        test_idx=ds.test_idx,
    )


def load_dataset(
    name: str,
    data_root: str | None = None,
    seed: int = 0,
    **overrides,
) -> DDIDataset:
    """Load a registered dataset by name (see module docstring)."""
    name = name.lower()
    data_root = data_root or os.environ.get("BIGNN_DATA_ROOT", "data")
    if name == "ddi-sample":
        from bignn_tpu_torch.data.real_sample import load_real_sample

        return load_real_sample(seed=seed, **overrides)
    if name in ("synthetic-small", "synthetic"):
        kw = dict(num_drugs=500, feat_dim=16, seed=seed, name="synthetic-small")
        kw.update(overrides)
        return make_synthetic_ddi(**kw)
    if name == "synthetic-large":
        kw = dict(
            num_drugs=100_000, feat_dim=32, avg_degree=200.0,
            min_atoms=8, max_atoms=40, latent_dim=8, seed=seed,
            name="synthetic-large",
        )
        kw.update(overrides)
        return make_synthetic_ddi(**kw)
    if name in _STANDIN_SPECS:
        path = os.path.join(data_root, f"{name}.npz")
        if os.path.exists(path):
            return load_npz_cache(path, name, seed)
        for raw in (os.path.join(data_root, f"{name}.pkl"),
                    os.path.join(data_root, f"{name}.pickle"),
                    os.path.join(data_root, name)):
            if os.path.exists(raw):
                from bignn_tpu_torch.data.convert import (
                    convert_reference_cache)

                return convert_reference_cache(raw, path, name, seed)
        kw = dict(_STANDIN_SPECS[name])
        kw.update(overrides)
        return make_synthetic_ddi(seed=seed, name=f"{name}-standin", **kw)
    raise ValueError(
        f"unknown dataset {name!r}; known: ddi-sample, synthetic-small, "
        f"synthetic-large, {sorted(_STANDIN_SPECS)}")
