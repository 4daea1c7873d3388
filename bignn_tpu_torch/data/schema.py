"""Dataset schema (counterpart of ``bignn_tpu/data/schema.py``).

``DDIDataset`` is the host record; ``prepare_device_data`` buckets the
molecules and builds the outer graph from training edges only, so no
val/test edge carries messages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bignn_tpu_torch.sparse.bucketing import Bucketing, bucket_graphs
from bignn_tpu_torch.sparse.formats import COOGraph, OuterGraph, build_outer_graph


@dataclasses.dataclass
class DDIDataset:
    """Outer DDI edges ``[E, 2]`` (undirected) + one molecule per drug +
    edge splits indexing rows of ``edges``."""

    name: str
    molecules: list[COOGraph]
    edges: np.ndarray
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def num_drugs(self) -> int:
        return len(self.molecules)

    @property
    def feat_dim(self) -> int:
        return int(self.molecules[0].node_feat.shape[1])

    def split_edges(self, split: str) -> np.ndarray:
        idx = {"train": self.train_idx, "val": self.val_idx,
               "test": self.test_idx}[split]
        return self.edges[idx]

    def stats(self) -> dict:
        n_nodes = [m.num_nodes for m in self.molecules]
        n_edges = [m.num_edges for m in self.molecules]
        return {
            "num_drugs": self.num_drugs,
            "num_ddi_edges": int(self.edges.shape[0]),
            "feat_dim": self.feat_dim,
            "inner_nodes_total": int(np.sum(n_nodes)),
            "inner_edges_total": int(np.sum(n_edges)),
            "inner_nodes_max": int(np.max(n_nodes)),
            "train/val/test": (len(self.train_idx), len(self.val_idx),
                               len(self.test_idx)),
        }


@dataclasses.dataclass
class DeviceData:
    """Bucketed molecules, the train-edge outer graph and the pair splits
    (host arrays; ``.to(device)`` on each batch uploads it)."""

    bucketing: Bucketing
    outer: OuterGraph
    train_pairs: np.ndarray  # [E_train, 2] int32
    val_pairs: np.ndarray
    test_pairs: np.ndarray
    num_drugs: int
    feat_dim: int


def random_split(
    num_edges: int, val_frac: float, test_frac: float, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_edges)
    n_val = int(num_edges * val_frac)
    n_test = int(num_edges * test_frac)
    return (
        np.sort(perm[n_val + n_test :]),
        np.sort(perm[:n_val]),
        np.sort(perm[n_val : n_val + n_test]),
    )


def prepare_device_data(
    ds: DDIDataset,
    *,
    max_buckets: int = 4,
    outer_edge_cap: int | None = None,
) -> DeviceData:
    """Bucket molecules + build the train-edge outer graph."""
    bucketing = bucket_graphs(ds.molecules, max_buckets=max_buckets)
    train_edges = ds.split_edges("train")
    outer = build_outer_graph(
        train_edges[:, 0],
        train_edges[:, 1],
        num_nodes=ds.num_drugs,
        edge_cap=outer_edge_cap,
    )
    return DeviceData(
        bucketing=bucketing,
        outer=outer,
        train_pairs=train_edges.astype(np.int32),
        val_pairs=ds.split_edges("val").astype(np.int32),
        test_pairs=ds.split_edges("test").astype(np.int32),
        num_drugs=ds.num_drugs,
        feat_dim=ds.feat_dim,
    )
