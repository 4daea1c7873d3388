"""Raw reference cache -> ``.npz`` cache (counterpart of
``bignn_tpu/data/convert.py``, the same accepted layouts and output).

Accepted inputs:
  * a pickle file holding a dict (or an object with those attributes) with
    - molecule graphs under one of ``graphs`` / ``molecule_graphs`` /
      ``drug_graphs`` / ``mol_graphs``: a dict id -> graph, or a list;
    - interactions under one of ``interactions`` / ``edges`` /
      ``ddi_edges`` / ``interaction_edges``: ``[E, 2]`` ids into the
      graph set;
    - optionally ``smiles`` (dict id -> SMILES), used for featurization
      when the graphs carry no feature vectors;
  * a klepto ``dir_archive`` directory: every pickle in it is loaded and
    merged into one dict before the same key search.

The graphs are duck-typed, networkx-like (``nodes()``, ``nodes(data=True)``,
``edges()``); nothing here imports networkx. Node features, in priority
order: a per-node vector attribute (``feat`` / ``features`` / ``x``), else
SMILES featurization (``data/molecules.py``), else a one-hot of a per-node
``type`` / ``symbol`` / ``label`` / ``atom_type`` attribute over the
vocabulary of the whole cache.

Output: the ``.npz`` schema of ``data/datasets.py`` (``load_npz_cache``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from bignn_tpu_torch.data.schema import DDIDataset, random_split
from bignn_tpu_torch.sparse.formats import COOGraph

_GRAPH_KEYS = ("graphs", "molecule_graphs", "drug_graphs", "mol_graphs")
_EDGE_KEYS = ("interactions", "edges", "ddi_edges", "interaction_edges")
_FEAT_ATTRS = ("feat", "features", "x")
_TYPE_ATTRS = ("type", "symbol", "label", "atom_type")


def _load_any(path: str) -> dict:
    """A pickle file or a klepto ``dir_archive`` directory -> one dict."""
    if os.path.isdir(path):
        merged: dict = {}
        for root, _dirs, files in os.walk(path):
            for fn in sorted(files):
                if not (fn.endswith((".pkl", ".pickle"))
                        or fn.startswith(("K_", "I_"))):
                    continue
                try:
                    with open(os.path.join(root, fn), "rb") as f:
                        obj = pickle.load(f)
                except Exception:
                    continue
                # dir_archive: one object per key; the key is the directory
                # or file name after its K_ / I_ prefix
                key = os.path.basename(root)
                for prefix in ("K_", "I_"):
                    if key.startswith(prefix):
                        key = key[len(prefix):]
                    if fn.startswith(prefix):
                        key = fn[len(prefix):].split(".")[0]
                if isinstance(obj, dict) and not key:
                    merged.update(obj)
                else:
                    merged[key] = obj
        if not merged:
            raise ValueError(f"no loadable pickles under {path!r}")
        return merged
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict):
        return obj
    return {k: getattr(obj, k) for k in dir(obj) if not k.startswith("_")}


def _find(d: dict, keys):
    for k in keys:
        if k in d and d[k] is not None:
            return d[k]
    low = {str(k).lower(): v for k, v in d.items()}
    for k in keys:
        if k in low and low[k] is not None:
            return low[k]
    return None


def _graph_to_coo(g, smiles: str | None, type_vocab: dict) -> COOGraph:
    """A networkx-like graph -> COOGraph (both bond directions). Type-only
    graphs come back with ``[n]`` vocabulary indices as features, made
    one-hot by the caller once the whole vocabulary is known."""
    nodes = sorted(g.nodes())
    idx = {n: i for i, n in enumerate(nodes)}
    data = dict(g.nodes(data=True))
    feat = None
    for attr in _FEAT_ATTRS:
        if nodes and attr in data[nodes[0]]:
            feat = np.asarray(
                [np.asarray(data[n][attr], np.float32).ravel() for n in nodes])
            break
    if feat is None and smiles is not None:
        from bignn_tpu_torch.data.molecules import smiles_to_graph

        return smiles_to_graph(smiles)
    if feat is None:
        attr = next(
            (a for a in _TYPE_ATTRS if nodes and a in data[nodes[0]]), None)
        if attr is None:
            raise ValueError(
                "graph nodes carry neither a feature vector nor a type "
                f"attribute (looked for {_FEAT_ATTRS + _TYPE_ATTRS})")
        for n in nodes:  # grow the shared vocabulary deterministically
            type_vocab.setdefault(data[n][attr], len(type_vocab))
        feat = np.asarray([type_vocab[data[n][attr]] for n in nodes],
                          np.int64)
    src, dst = [], []
    for u, v in g.edges():
        src += [idx[u], idx[v]]
        dst += [idx[v], idx[u]]
    return COOGraph(node_feat=feat, src=np.asarray(src, np.int64),
                    dst=np.asarray(dst, np.int64))


def convert_reference_cache(src_path: str, out_path: str,
                            name: str = "converted",
                            seed: int = 0) -> DDIDataset:
    """Convert a klepto/pickle reference cache to the ``.npz`` schema at
    ``out_path``; returns the dataset (an 80/10/10 split of ``seed``)."""
    from bignn_tpu_torch.data.datasets import save_npz_cache

    d = _load_any(src_path)
    graphs = _find(d, _GRAPH_KEYS)
    edges = _find(d, _EDGE_KEYS)
    if graphs is None or edges is None:
        raise ValueError(
            f"cache at {src_path!r} lacks molecule graphs "
            f"({_GRAPH_KEYS}) or interactions ({_EDGE_KEYS}); "
            f"found keys: {sorted(map(str, d))}")
    smiles = _find(d, ("smiles", "drug_smiles")) or {}

    if isinstance(graphs, dict):
        ids = sorted(graphs)
        glist = [graphs[i] for i in ids]
        id_map = {i: j for j, i in enumerate(ids)}
    else:
        glist = list(graphs)
        id_map = {i: i for i in range(len(glist))}

    type_vocab: dict = {}
    mols = [_graph_to_coo(
        g, smiles.get(i) if isinstance(smiles, dict) else None, type_vocab)
        for g, i in zip(glist, list(id_map))]
    # type-featurized graphs become one-hots over the whole vocabulary
    # (one width across molecules)
    if type_vocab:
        width = len(type_vocab)
        fixed = []
        for m in mols:
            if m.node_feat.ndim == 1:
                oh = np.zeros((len(m.node_feat), width), np.float32)
                oh[np.arange(len(m.node_feat)), m.node_feat] = 1.0
                m = COOGraph(node_feat=oh, src=m.src, dst=m.dst)
            fixed.append(m)
        mols = fixed

    e = np.asarray([[id_map[u], id_map[v]] for u, v in np.asarray(list(edges))],
                   np.int64)
    tr, va, te = random_split(e.shape[0], 0.1, 0.1, seed)
    ds = DDIDataset(name=name, molecules=mols, edges=e,
                    train_idx=tr, val_idx=va, test_idx=te)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    save_npz_cache(ds, out_path)
    return ds
