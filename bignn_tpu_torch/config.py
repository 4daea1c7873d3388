"""Experiment configs (counterpart of ``bignn_tpu/config.py``): the same
registry and aliases. ``TrainConfig`` copies the JAX trainer's fields and
defaults; ``train.Trainer`` reads it (``reshuffle_epochs`` belongs to the
device sampler of ``MinibatchTrainer``, still to port)."""

from __future__ import annotations

import dataclasses

from bignn_tpu_torch.models.bignn import BiGNNConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    epochs: int = 20
    batch_size: int = 256
    neg_ratio: int = 1
    eval_every: int = 1  # epochs
    seed: int = 0
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # global-norm clip, 0 = off
    reshuffle_epochs: bool = False  # device sampler only


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    dataset: str
    dataset_kwargs: dict
    model: BiGNNConfig
    train: TrainConfig
    mode: str = "full"  # "full" | "minibatch" | "p2"
    fanouts: tuple[int, ...] = (10,)
    max_drugs: int | None = None
    dispatch_chunk: int = 1
    device_sample: bool = False
    max_buckets: int = 4
    dp: int | None = None
    graph_shards: int = 1


def get_config(name: str, **overrides) -> ExperimentConfig:
    """Milestone configs #1-#5 plus aliases, as in the JAX package."""
    registry = {
        # 1: 2-layer GCN inner + 1-layer GCN outer, small DDI
        "config1": ExperimentConfig(
            name="config1",
            dataset="synthetic-small",
            dataset_kwargs=dict(num_drugs=500, feat_dim=16),
            model=BiGNNConfig.config1(feat_dim=16),
            train=TrainConfig(lr=5e-3, epochs=20, batch_size=256),
        ),
        # 2: full BI-GNN (GIN inner, GAT outer) on DrugBank DDI
        "config2": ExperimentConfig(
            name="config2",
            dataset="drugbank",
            dataset_kwargs=dict(),
            model=BiGNNConfig.full_bignn(feat_dim=64, dim=128, heads=4),
            train=TrainConfig(lr=1e-3, epochs=40, batch_size=2048),
        ),
        # 2r: config #2's model on the in-repo real drug sample
        "config2-real": ExperimentConfig(
            name="config2-real",
            dataset="ddi-sample",
            dataset_kwargs=dict(),
            model=BiGNNConfig.full_bignn(feat_dim=21, dim=16, heads=2),
            train=TrainConfig(lr=3e-3, epochs=60, batch_size=64, seed=1,
                              weight_decay=1e-3),
        ),
        # 3: BioSNAP, minibatch hierarchical sampling
        "config3": ExperimentConfig(
            name="config3",
            dataset="biosnap",
            dataset_kwargs=dict(),
            model=BiGNNConfig.full_bignn(feat_dim=64, dim=128, heads=4),
            train=TrainConfig(lr=1e-3, epochs=40, batch_size=512),
            mode="minibatch",
            fanouts=(10, 5),
        ),
        # 4: large synthetic graph-of-graphs, device-sampled minibatches
        "config4": ExperimentConfig(
            name="config4",
            dataset="synthetic-large",
            dataset_kwargs=dict(),
            model=dataclasses.replace(
                BiGNNConfig.full_bignn(feat_dim=32, dim=128, heads=4),
                dtype="bfloat16"),
            train=TrainConfig(lr=3e-4, epochs=5, batch_size=1024),
            mode="minibatch",
            fanouts=(10,),
            max_drugs=16384,
            dispatch_chunk=8,
            device_sample=True,
        ),
        # 5: edge-partitioned outer graph across devices
        "config5": ExperimentConfig(
            name="config5",
            dataset="drugbank",
            dataset_kwargs=dict(),
            model=BiGNNConfig.full_bignn(feat_dim=64, dim=128, heads=4),
            train=TrainConfig(lr=1e-3, epochs=40, batch_size=2048),
            mode="p2",
            graph_shards=4,
        ),
        # 5L: the edge-partitioned path at config #4's scale
        "config5-large": ExperimentConfig(
            name="config5-large",
            dataset="synthetic-large",
            dataset_kwargs=dict(),
            model=dataclasses.replace(
                BiGNNConfig.full_bignn(feat_dim=32, dim=128, heads=4),
                dtype="bfloat16"),
            train=TrainConfig(lr=3e-4, epochs=5, batch_size=1024),
            mode="p2",
            graph_shards=8,
        ),
    }
    registry["small"] = registry["config1"]
    registry["real"] = registry["config2-real"]
    registry["drugbank"] = registry["config2"]
    registry["biosnap"] = registry["config3"]
    registry["large"] = registry["config4"]
    registry["distributed"] = registry["config5"]
    try:
        cfg = registry[name]
    except KeyError:
        raise ValueError(
            f"unknown config {name!r}; known: {sorted(registry)}") from None
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
