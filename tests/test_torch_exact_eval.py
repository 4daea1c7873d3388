"""Exact (full-propagation) evaluation of the port's ``MinibatchTrainer``
against the JAX package on the CPU, at the sizes of tests/test_exact_eval.py
(48 drugs, feat 8, GIN:16 x2 -> sum -> GAT:16:2 -> mlp:64), the JAX init of
key 0 carried over by ``bridge``.

* ``score_exact`` against JAX's ``score_exact``, for resident, non-resident
  and device-sampled trainers, and against the port's full-graph
  ``Trainer`` on the same parameters: rtol 2e-4 / atol 2e-5 (two f32 paths
  that sum in other orders, tests/test_torch_train.py).
* ``evaluate(exact=True)`` against JAX's within 1e-3 on AUC and AP, and
  repeated on the port bit for bit.
* A bf16 model against JAX's bf16 ``score_exact`` within
  tests/test_torch_minibatch.py's ``BF16_TOL``.
* The ``Scorer``'s embeddings (its own bucketed encode) against
  ``embed_all_exact``: the two exact routes agree at rtol 2e-4 / atol
  2e-5 x max.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bignn_tpu import ops as jax_ops
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.train.trainer import MinibatchTrainer as JaxMinibatchTrainer
from bignn_tpu.train.trainer import TrainConfig as JaxTrainConfig

from bignn_tpu_torch import bridge
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.serve import Scorer
from bignn_tpu_torch.train import MinibatchTrainer, Trainer

TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=6e-2)  # tests/test_torch_minibatch.py
DATA = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
            max_atoms=10, seed=0)
KW = dict(fanouts=(4,), calibrate_caps=2, max_drugs=20)  # 2 encode chunks
TRAIN = dict(batch_size=8, epochs=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny tensors (see
    tests/test_torch_minibatch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(dtype="float32"):
    return dataclasses.replace(
        JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2), dtype=dtype)


@pytest.fixture(scope="module")
def setup():
    jds = jax_make_synthetic_ddi(**DATA)
    params = JaxBiGNN(_cfg()).init(jax.random.key(0))
    state = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    pairs = np.random.default_rng(7).integers(0, 48, (40, 2)).astype(np.int64)
    return jds, make_synthetic_ddi(**DATA), params, state, pairs


def _jax_trainer(jds, dtype="float32", **kw):
    return JaxMinibatchTrainer(JaxBiGNN(_cfg(dtype)), jds,
                               JaxTrainConfig(**TRAIN), **KW, **kw)


def _trainer(ds, dtype="float32", **kw):
    return MinibatchTrainer(BiGNN(BiGNNConfig(**dataclasses.asdict(
        _cfg(dtype)))), ds, TrainConfig(**TRAIN), **KW, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_scores(setup):
    jds, _, params, _, pairs = setup
    with jax_ops.backend_scope("xla"):
        return _jax_trainer(jds).score_exact(params, pairs)


@pytest.mark.parametrize("kw", [dict(), dict(resident=False),
                                dict(device_sample=True)],
                         ids=["resident", "nonresident", "device_sample"])
def test_score_exact_matches_jax(setup, jax_scores, kw):
    _, ds, _, state, pairs = setup
    tr = _trainer(ds, **kw)
    got = tr.score_exact(state, pairs)
    assert got.dtype == np.float32 and got.shape == (40,)
    np.testing.assert_allclose(got, jax_scores, **TOL)
    # a non-resident trainer keeps its exact-evaluation tables apart
    assert (tr.tables is None) == (kw.get("resident") is False)


def test_score_exact_matches_full_graph_trainer(setup):
    """tests/test_exact_eval.py's check on the port: the minibatch
    trainer's exact scores equal the full-graph Trainer's."""
    _, ds, _, state, pairs = setup
    got = _trainer(ds).score_exact(state, pairs)
    full = Trainer(BiGNN(BiGNNConfig(**dataclasses.asdict(_cfg()))),
                   prepare_device_data(ds), TrainConfig(**TRAIN),
                   device="cpu")
    full.model.load_state_dict(state)
    with torch.no_grad():
        want = full.model(full.buckets, full.graph_index, full.outer,
                          torch.as_tensor(pairs))
    np.testing.assert_allclose(got, want.numpy(), **TOL)


@pytest.mark.parametrize("split", ["val", "test"])
def test_exact_evaluate_matches_jax(setup, split):
    jds, ds, params, state, _ = setup
    with jax_ops.backend_scope("xla"):
        want = _jax_trainer(jds).evaluate(params, split, exact=True)
    tr = _trainer(ds)
    tr.model.train(False)
    got = tr.evaluate(state, split, exact=True)
    assert set(got) == set(want) == {f"{split}_auc", f"{split}_ap"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    assert not tr.model.training  # the mode is left as it was
    assert not any(p.grad is not None for p in tr.model.parameters())


def test_exact_evaluate_repeats(setup):
    _, ds, _, state, _ = setup
    tr = _trainer(ds, resident=False)
    first = tr.evaluate(state, "val", exact=True)
    assert first == tr.evaluate(state, "val", exact=True)
    assert 0.0 <= first["val_auc"] <= 1.0 and 0.0 <= first["val_ap"] <= 1.0


def test_bf16_score_exact_matches_jax(setup):
    jds, ds, params, state, pairs = setup
    with jax_ops.backend_scope("xla"):
        want = _jax_trainer(jds, "bfloat16").score_exact(params, pairs)
    tr = _trainer(ds, "bfloat16")
    emb = tr.embed_all_exact(state)
    assert emb.shape == (48, 16) and emb.dtype == torch.bfloat16
    got = tr.score_exact(None, pairs)
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_scorer_matches_embed_all_exact(setup):
    """The Scorer's bucketed encode and the trainer's chunked one are two
    routes to the same exact embeddings."""
    _, ds, _, state, pairs = setup
    scorer = Scorer(BiGNN(BiGNNConfig(**dataclasses.asdict(_cfg()))), ds,
                    state, device="cpu")
    want = _trainer(ds).embed_all_exact(state).numpy()
    got = scorer.embeddings.numpy()
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * np.abs(want).max())
    assert np.all(np.isfinite(scorer.score_pairs(pairs)))
