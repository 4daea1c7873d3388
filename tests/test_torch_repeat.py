"""Seeded training repeats bit for bit (ROADMAP Queue 3, F7).

On the card autograd's backward of a row gather (``index_select``,
``gather``) adds rows by float atomics in no fixed order, so a seeded run
of the port did not repeat. The pair scorer (``models.scorer.pair_rows``)
and the p2 halo's send gathers (``parallel/halo.py:_take``) now gather
through ``ops.gather_rows_sorted_grad`` on ``ops.sort_ids``, whose
backward is a sorted segment sum.
Here on the CPU: ``pair_rows``' gradient equals the plain gather's, and
the backward graph of a training step of the full-graph ``Trainer``, of
config4's ``MinibatchTrainer`` and of the p2 mode holds no node whose
backward scatters rows by atomics on the card. On the card (``gpu``): two
seeded runs give the same losses and parameters, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bignn_tpu_torch import run
from bignn_tpu_torch.config import TrainConfig, get_config
from bignn_tpu_torch.data import (
    load_dataset,
    make_synthetic_ddi,
    prepare_device_data,
)
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.models.scorer import pair_rows
from bignn_tpu_torch.ops import gather_rows
from bignn_tpu_torch.sparse import build_outer_graph
from bignn_tpu_torch.train import MinibatchTrainer, Trainer

# autograd nodes whose CUDA backward adds rows by float atomics
ATOMIC_NODES = ("IndexSelectBackward0", "GatherBackward0",
                "IndexAddBackward0", "ScatterAddBackward0",
                "EmbeddingBackward0", "TakeBackward0", "PutBackward0")
KW = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_rows_grad_matches_plain_gather(dtype):
    """Forward equal to ``gather_rows``; backward the plain gather's
    gradient summed in float32 and rounded once (equal bit for bit in
    float32), clipped ids sending theirs to the edge row as
    ``gather_rows`` does."""
    rng = np.random.default_rng(0)
    emb = torch.tensor(rng.normal(size=(30, 16)), dtype=dtype)
    ids = torch.tensor(rng.integers(-3, 33, 500))
    g = torch.tensor(rng.normal(size=(500, 16)), dtype=dtype)
    a = emb.clone().requires_grad_()
    got = pair_rows(a, ids)
    got.backward(g)
    b = emb.float().clone().requires_grad_()
    want = gather_rows(b, ids)
    want.backward(g.float())
    assert torch.equal(got, gather_rows(emb, ids))
    assert torch.equal(a.grad, b.grad.to(dtype))


def _atomic_nodes(loss) -> list:
    found, stack, seen = [], [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ in ATOMIC_NODES:
            found.append(type(node).__name__)
        stack.extend(fn for fn, _ in node.next_functions)
    return found


@pytest.fixture
def record_backward(monkeypatch):
    """Every ``Tensor.backward`` call's atomic-scatter nodes, in order."""
    found = []
    original = torch.Tensor.backward

    def backward(self, *a, **k):
        found.append(_atomic_nodes(self))
        return original(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "backward", backward)
    return found


@pytest.mark.parametrize("scorer,outer", [
    ("dot", "gat:16:2"), ("mlp:16", "gat:16:2"),
    ("mlp:16", "gat:16:2:edges"), ("mlp:16", "dotattn:16:2:edges")])
def test_trainer_step_has_no_atomic_scatter(record_backward, scorer, outer):
    """A dense outer graph, or an edge list (``:edges``: the GAT's and
    ``DotAttnConv``'s edge-list branches, ``ops.sddmm``)."""
    data = prepare_device_data(make_synthetic_ddi(**KW))
    if outer.endswith(":edges"):
        outer = outer[:-len(":edges")]
        tr = data.train_pairs
        data = dataclasses.replace(data, outer=build_outer_graph(
            tr[:, 0], tr[:, 1], data.num_drugs, dense_max_nodes=0))
    cfg = dataclasses.replace(
        BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2), scorer=scorer,
        outer_layers=(outer,))
    tr = Trainer(BiGNN(cfg, seed=0), data, TrainConfig(batch_size=32),
                 device="cpu")
    pos = data.train_pairs[:32]
    tr.train_step(pos, np.ones(32, np.float32), 0, 0)
    assert record_backward == [[]]


def test_minibatch_step_has_no_atomic_scatter(record_backward):
    """config4's step (device sampler, bf16, a sparse outer graph)."""
    cfg = get_config("config4")
    ds = load_dataset("synthetic-large", num_drugs=300)
    tr = MinibatchTrainer(BiGNN(cfg.model, seed=0), ds,
                          dataclasses.replace(cfg.train, batch_size=32),
                          fanouts=cfg.fanouts, max_drugs=256,
                          dispatch_chunk=2, device_sample=True, device="cpu")
    tr.init(0)
    tr.train_chunk_device(0, 0, 2)
    assert record_backward == [[], []]


def test_p2_steps_have_no_atomic_scatter(record_backward, monkeypatch):
    """The p2 mode of ``run.main`` (a tiny config5, 4 graph shards on the
    CPU): its halo gathers (``parallel/halo.py:_take``) and scorer."""
    cfg = get_config("config5")
    cfg = dataclasses.replace(
        cfg, dataset="synthetic-small",
        dataset_kwargs=dict(num_drugs=40, feat_dim=8, avg_degree=6.0,
                            min_atoms=4, max_atoms=8),
        model=dataclasses.replace(cfg.model, feat_dim=8,
                                  inner_layers=("gin:16",),
                                  outer_layers=("gat:16:2",)),
        train=dataclasses.replace(cfg.train, batch_size=32, epochs=1))
    monkeypatch.setattr(run, "get_config", lambda name: cfg)
    run.main(["--config", "config5", "--device", "cpu"])
    assert record_backward and all(n == [] for n in record_backward)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda", 0)


def _seeded_run(dev) -> tuple[list, list]:
    data = prepare_device_data(make_synthetic_ddi(
        num_drugs=300, feat_dim=12, avg_degree=8.0, seed=0))
    tr = Trainer(BiGNN(BiGNNConfig.full_bignn(feat_dim=12, dim=32, heads=4),
                       seed=0),
                 data, TrainConfig(lr=3e-3, batch_size=64), device=dev)
    rng = np.random.default_rng(0)
    losses = []
    for step in range(6):
        pos = data.train_pairs[rng.permutation(len(data.train_pairs))[:64]]
        losses.append(tr.train_step(pos, np.ones(64, np.float32), 0,
                                    step).item())
    return losses, [p.detach().cpu() for p in tr.model.parameters()]


@pytest.mark.gpu
def test_seeded_training_repeats_on_card(cuda_device):
    first, p1 = _seeded_run(cuda_device)
    again, p2 = _seeded_run(cuda_device)
    assert first == again
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
