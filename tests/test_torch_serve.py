"""The port's Scorer against bignn_tpu.serve.Scorer on the same dataset and
parameters (CPU). Embeddings and pair scores: rtol 2e-4 / atol 2e-5, as
tests/test_exact_eval.py. Rankings are compared by score values: torch.topk
and lax.top_k may order tied scores differently."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.serve import Scorer as JaxScorer

from bignn_tpu_torch import bridge
from bignn_tpu_torch.data import make_synthetic_ddi
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.serve import Scorer

TOL = dict(rtol=2e-4, atol=2e-5)
KW = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)


@pytest.fixture(scope="module")
def scorers():
    jax_model = JaxBiGNN(JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16,
                                                   heads=2))
    params = jax_model.init(jax.random.key(0))
    jax_scorer = JaxScorer(jax_model, jax_make_synthetic_ddi(**KW), params,
                           chunk=64)
    ds = make_synthetic_ddi(**KW)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    state = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    scorer = Scorer(model, ds, state, chunk=64, device="cpu")
    return scorer, jax_scorer, jax_model


def _known_partners(ds, drug):
    known = np.concatenate([ds.split_edges("train"), ds.split_edges("val")])
    return (set(known[known[:, 0] == drug, 1].tolist())
            | set(known[known[:, 1] == drug, 0].tolist()))


def test_embeddings_and_pair_scores(scorers):
    scorer, jax_scorer, _ = scorers
    np.testing.assert_allclose(scorer.embeddings.numpy(),
                               np.asarray(jax_scorer.embeddings), **TOL)
    pairs = np.random.default_rng(0).integers(0, 48, (150, 2))  # 3 chunks
    got = scorer.score_pairs(pairs)
    assert got.shape == (150,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_scorer.score_pairs(pairs), **TOL)


@pytest.mark.parametrize("exclude_known", [False, True])
def test_top_k(scorers, exclude_known):
    scorer, jax_scorer, _ = scorers
    drug = int(scorer.ds.split_edges("train")[0, 0])
    ids, scores = scorer.top_k(drug, k=8, exclude_known=exclude_known)
    _, jax_scores = jax_scorer.top_k(drug, k=8, exclude_known=exclude_known)
    np.testing.assert_allclose(scores, jax_scores, **TOL)
    assert drug not in ids and np.all(np.diff(scores) <= 0)
    partners = _known_partners(scorer.ds, drug)
    assert partners
    if exclude_known:
        assert not set(ids.tolist()) & partners


@pytest.mark.parametrize("exclude_known", [False, True])
def test_top_k_batch(scorers, exclude_known):
    scorer, jax_scorer, _ = scorers
    drugs = list(range(48))  # more queries than one query chunk
    ids, scores = scorer.top_k_batch(drugs, k=5, exclude_known=exclude_known)
    jax_ids, jax_scores = jax_scorer.top_k_batch(
        drugs, k=5, exclude_known=exclude_known)
    assert ids.shape == jax_ids.shape == (48, 5)
    np.testing.assert_allclose(scores, jax_scores, **TOL)
    _, one_scores = scorer.top_k(7, k=5, exclude_known=exclude_known)
    np.testing.assert_array_equal(scores[7], one_scores)


def test_refresh_swaps_params(scorers):
    scorer, jax_scorer, jax_model = scorers
    pairs = np.stack([np.arange(8), (np.arange(8) * 5 + 2) % 48], 1)
    before = scorer.score_pairs(pairs)
    new = jax_model.init(jax.random.key(999))
    scorer.refresh(bridge.params_from_jax(jax.tree.map(np.asarray, new)))
    jax_scorer.refresh(new)
    after = scorer.score_pairs(pairs)
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, jax_scorer.score_pairs(pairs), **TOL)


def test_port_runs_without_jax():
    """The package imports no JAX (the card's machine has none): with jax,
    flax and optax blocked, it imports, serves and trains on the CPU."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "flax", "optax", "bignn_tpu"):
            sys.modules[name] = None
        import torch
        import bignn_tpu_torch, bignn_tpu_torch.bridge, bignn_tpu_torch.config
        from bignn_tpu_torch.data import load_dataset
        from bignn_tpu_torch.models import BiGNN, BiGNNConfig
        from bignn_tpu_torch.ops import cuda_lib
        from bignn_tpu_torch.serve import Scorer
        ds = load_dataset("synthetic-small", num_drugs=24, feat_dim=4)
        model = BiGNN(BiGNNConfig.full_bignn(feat_dim=4, dim=8, heads=2),
                      seed=0)
        s = Scorer(model, ds, model.state_dict(), device="cpu")
        ids, scores = s.top_k(0, k=3, exclude_known=True)
        assert len(ids) == 3 and torch.isfinite(s.embeddings).all()
        from bignn_tpu_torch.data import prepare_device_data
        from bignn_tpu_torch.train import Trainer, TrainConfig
        real = load_dataset("ddi-sample")
        model = BiGNN(BiGNNConfig.full_bignn(feat_dim=real.feat_dim, dim=8,
                                             heads=2))
        _, result = Trainer(model, prepare_device_data(real),
                            TrainConfig(epochs=1, batch_size=64),
                            device="cpu").fit()
        assert 0.0 <= result["test_auc"] <= 1.0
        assert cuda_lib._lib is None  # nothing was built
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=False,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
