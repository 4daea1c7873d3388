"""The port's training path against the JAX package on the CPU: threefry
draws, initial parameters, loss, sampler, metrics, one whole training step,
a whole ``Trainer.fit`` run, and kill-and-resume.

The JAX side runs its ``xla`` backend. Random draws are equal bit for bit
(``bignn_tpu_torch/prng.py``); floats: rtol 2e-4 / atol 2e-5, as
tests/test_torch_models.py, for two f32 paths that sum in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bignn_tpu import ops as jax_ops
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.data import prepare_device_data as jax_prepare_device_data
from bignn_tpu.data.sampler import EdgeMinibatchSampler as JaxSampler
from bignn_tpu.data.sampler import sample_negative_pairs as jax_negatives
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.models.loss import bce_with_logits_loss as jax_bce
from bignn_tpu.train import Trainer as JaxTrainer
from bignn_tpu.train import TrainConfig as JaxTrainConfig
from bignn_tpu.train import metrics as jax_metrics

from bignn_tpu_torch import bridge, prng
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.data.sampler import (
    EdgeMinibatchSampler,
    sample_negative_pairs,
)
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.models.loss import bce_with_logits_loss
from bignn_tpu_torch.parallel import dp as dp_mod
from bignn_tpu_torch.train import CheckpointManager, Trainer, metrics

TOL = dict(rtol=2e-4, atol=2e-5)
KW = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)


def t(x):
    return torch.from_numpy(np.array(x))


def _port_config(cfg: JaxBiGNNConfig) -> BiGNNConfig:
    return BiGNNConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BiGNNConfig)})


# ---------------------------------------------------------------------------
# threefry draws and initial parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**31 - 1])
def test_prng_matches_jax_random(seed):
    k, pk = jax.random.key(seed), prng.key(seed)

    def data(key):
        return tuple(np.asarray(jax.random.key_data(key)).tolist())

    assert data(k) == pk
    assert [tuple(r) for r in np.asarray(jax.random.key_data(
        jax.random.split(k, 5))).tolist()] == prng.split(pk, 5)
    assert data(jax.random.fold_in(k, 7)) == prng.fold_in(pk, 7)
    np.testing.assert_array_equal(prng.random_bits(pk, (3, 50)),
                                  np.asarray(jax.random.bits(k, (3, 50))))
    lim = float(np.sqrt(np.float32(6 / 37)))
    np.testing.assert_array_equal(
        prng.uniform(pk, (640, 17), -lim, lim),
        np.asarray(jax.random.uniform(k, (640, 17), minval=-lim,
                                      maxval=lim)))
    np.testing.assert_array_equal(
        prng.uniform(pk, (1000,)) < 0.5,
        np.asarray(jax.random.bernoulli(k, 0.5, (1000,))))
    halves = prng.random_bits_many(prng.split(pk), 1000)
    for n in (7, 1704, 2**20 + 3):  # the last wraps JAX's uint32 product
        np.testing.assert_array_equal(
            prng.randint_from_bits(*halves, 0, n),
            np.asarray(jax.random.randint(k, (1000,), 0, n, jnp.int32)))


@pytest.mark.parametrize("name", ["config1", "config2", "config2-real"])
def test_init_params_match_jax_init(name):
    """BiGNN.init_params(seed) equals bridge.params_from_jax of the JAX
    BiGNN.init(key(seed)) bit for bit, at the config's full widths."""
    from bignn_tpu.config import get_config

    cfg = get_config(name).model
    model = BiGNN(_port_config(cfg))
    for seed in (0, 3):
        want = bridge.params_from_jax(jax.tree.map(
            np.asarray, JaxBiGNN(cfg).init(jax.random.key(seed))))
        got = model.init_params(seed)
        assert set(got) == set(want) == set(model.state_dict())
        for k in got:
            assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# loss, sampler, negatives, metrics
# ---------------------------------------------------------------------------


def test_bce_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(64).astype(np.float32) * 4
    logits[:4] = [50.0, -50.0, 49.5, -50.0]  # saturated terms
    labels = (rng.random(64) < 0.5).astype(np.float32)
    labels[:4] = [0.0, 1.0, 1.0, 0.0]
    mask = (rng.random(64) < 0.8).astype(np.float32)
    for m in (mask, None):
        jm = None if m is None else jnp.asarray(m)
        want, want_g = jax.value_and_grad(jax_bce)(
            jnp.asarray(logits), jnp.asarray(labels), jm)
        x = t(logits).requires_grad_()
        got = bce_with_logits_loss(x, t(labels), None if m is None else t(m))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), **TOL)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **TOL)


def test_sampler_epochs_match_jax():
    pos = np.random.default_rng(1).integers(0, 500, (1000, 2))
    port, ref = EdgeMinibatchSampler(pos, 96, seed=4), JaxSampler(pos, 96, 4)
    assert len(port) == len(ref) == 11
    for epoch in (0, 1, None):  # None: the stateful rng, as in JAX
        batches = list(zip(port.epoch(epoch), ref.epoch(epoch),
                           strict=True))
        for (p, m), (jp, jm) in batches:
            np.testing.assert_array_equal(p, jp)
            np.testing.assert_array_equal(m, jm)
        assert batches[-1][0][1].sum() == 1000 - 10 * 96  # padded tail


@pytest.mark.parametrize("ratio", [1, 3])
def test_negative_pairs_match_jax(ratio):
    pos = np.random.default_rng(2).integers(0, 1704, (500, 2)).astype(
        np.int32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(5), 2), 9)
    want = np.asarray(jax_negatives(key, jnp.asarray(pos), 1704, ratio))
    got = sample_negative_pairs(prng.fold_in(prng.fold_in(prng.key(5), 2), 9),
                                t(pos), 1704, ratio).numpy()
    np.testing.assert_array_equal(got, want)
    rep = np.tile(pos, (ratio, 1))
    kept = (got[:, 0] == rep[:, 0]) | (got[:, 1] == rep[:, 1])
    assert kept.all() and got.min() >= 0 and got.max() < 1704


def test_metrics_match_jax_on_ties():
    rng = np.random.default_rng(3)
    labels = (rng.random(300) < 0.4).astype(np.float32)
    scores = np.round(rng.standard_normal(300), 1).astype(np.float32)  # ties
    mask = (rng.random(300) < 0.9).astype(np.float32)
    assert metrics.roc_auc(labels, scores) == jax_metrics.roc_auc(
        labels, scores)
    assert metrics.average_precision(labels, scores) == (
        jax_metrics.average_precision(labels, scores))
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else t(m)
        np.testing.assert_allclose(
            metrics.roc_auc_torch(t(labels), t(scores), tm).item(),
            float(jax_metrics.roc_auc_jnp(jnp.asarray(labels),
                                          jnp.asarray(scores), jm)),
            rtol=1e-6)
        np.testing.assert_allclose(
            metrics.average_precision_torch(t(labels), t(scores), tm).item(),
            float(jax_metrics.average_precision_jnp(
                jnp.asarray(labels), jnp.asarray(scores), jm)), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.roc_auc_torch(t(labels), t(scores)).item(),
        metrics.roc_auc(labels, scores), rtol=1e-6)


# ---------------------------------------------------------------------------
# one training step, a whole fit, resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_train_step_matches_jax(weight_decay):
    """Loss, every gradient, and the parameters after 3 optimizer steps of
    Trainer equal JAX value_and_grad + optax on the same host-built
    positives and negatives.

    Init key 1: with key 0 one GAT head's a_l gradient is zero in exact
    arithmetic (every leaky_relu input of a destination lies on one side of
    0, so its score half cancels in the softmax); both packages then carry
    ~1e-6 of rounding noise there, and Adam's first step turns its sign
    into +-lr, which no tolerance on parameters would survive."""
    jax_data = jax_prepare_device_data(jax_make_synthetic_ddi(**KW))
    data = prepare_device_data(make_synthetic_ddi(**KW))
    cfg = JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)
    jax_model = JaxBiGNN(cfg)
    params = jax_model.init(jax.random.key(1))
    opt = (optax.adamw(1e-3, weight_decay=weight_decay) if weight_decay
           else optax.adam(1e-3))
    opt_state = opt.init(params)
    buckets = [jax.tree.map(jnp.asarray, b)
               for b in jax_data.bucketing.batches]
    outer = jax.tree.map(jnp.asarray, jax_data.outer)

    def loss_fn(p, pos, mask, neg):
        pairs = jnp.concatenate([pos, neg])
        labels = jnp.concatenate([jnp.ones(len(pos)), jnp.zeros(len(neg))])
        logits = jax_model.apply(p, buckets, jax_data.bucketing.graph_index,
                                 outer, pairs)
        return jax_bce(logits, labels, jnp.concatenate([mask, mask]))

    step_fn = jax.jit(jax.value_and_grad(loss_fn))
    trainer = Trainer(BiGNN(_port_config(cfg)), data,
                      TrainConfig(lr=1e-3, weight_decay=weight_decay),
                      device="cpu")
    trainer.init(1)
    rng = np.random.default_rng(0)
    with jax_ops.backend_scope("xla"), pytest.MonkeyPatch.context() as mp:
        for step in range(3):
            pos = data.train_pairs[rng.permutation(len(data.train_pairs))[:32]]
            mask = np.ones(32, np.float32)
            mask[-3:] = 0.0
            neg = rng.integers(0, 48, (32, 2)).astype(np.int32)
            mp.setattr(dp_mod, "sample_negative_pairs",
                       lambda key, p, n, r, neg=neg: t(neg))
            loss, grads = step_fn(params, jnp.asarray(pos),
                                  jnp.asarray(mask), jnp.asarray(neg))
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            got = trainer.train_step(pos, mask, 0, step)
            np.testing.assert_allclose(got.item(), float(loss), **TOL)
            if step == 0:
                want_g = bridge.params_from_jax(jax.tree.map(np.asarray,
                                                             grads))
                for name, p in trainer.model.named_parameters():
                    scale = want_g[name].abs().max().item()
                    np.testing.assert_allclose(
                        p.grad.numpy(), want_g[name].numpy(), rtol=2e-4,
                        atol=2e-5 * max(scale, 1.0), err_msg=name)
    want_p = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   **TOL, err_msg=name)


@pytest.fixture(scope="module")
def config1_runs():
    """Trainer.fit of config1 on 200 synthetic drugs, 30 epochs, in both
    packages (tests/test_e2e_config1.py's run)."""
    kw = dict(num_drugs=200, feat_dim=12, avg_degree=8.0, seed=0)
    jax_cfg = JaxTrainConfig(lr=5e-3, epochs=30, batch_size=256, seed=0)
    _, ref = JaxTrainer(
        JaxBiGNN(JaxBiGNNConfig.config1(feat_dim=12)),
        jax_prepare_device_data(jax_make_synthetic_ddi(**kw), max_buckets=2),
        jax_cfg).fit()
    trainer = Trainer(BiGNN(BiGNNConfig.config1(feat_dim=12)),
                      prepare_device_data(make_synthetic_ddi(**kw),
                                          max_buckets=2),
                      TrainConfig(**dataclasses.asdict(jax_cfg)),
                      device="cpu")
    _, res = trainer.fit()
    return res, ref


def test_fit_learns(config1_runs):
    res, _ = config1_runs
    losses = [r["loss"] for r in res["history"]]
    assert losses[-1] < losses[0] * 0.9, losses
    assert max(r["val_auc"] for r in res["history"]) > 0.70
    assert 0.0 <= res["test_auc"] <= 1.0 and 0.0 <= res["test_ap"] <= 1.0


def test_fit_follows_jax_trajectory(config1_runs):
    """The same seed draws the same init and negatives, so the whole run
    follows the JAX one: epoch losses, validation metrics, the chosen epoch
    and the test metrics."""
    res, ref = config1_runs
    for key in ("loss", "val_auc", "val_ap"):
        np.testing.assert_allclose([r[key] for r in res["history"]],
                                   [r[key] for r in ref["history"]],
                                   rtol=1e-3, atol=1e-3, err_msg=key)
    assert res["best_epoch"] == ref["best_epoch"]
    np.testing.assert_allclose(res["test_auc"], ref["test_auc"], atol=1e-3)


def test_evaluate_on_device_equals_host(config1_runs):
    del config1_runs
    trainer = Trainer(BiGNN(BiGNNConfig.config1(feat_dim=8)),
                      prepare_device_data(make_synthetic_ddi(**KW)),
                      TrainConfig(), device="cpu")
    trainer.init(0)
    host = trainer.evaluate(split="test")
    dev = trainer.evaluate(split="test", on_device=True)
    for k in host:
        np.testing.assert_allclose(dev[k], host[k], rtol=1e-6)


@pytest.fixture(scope="module")
def resume_data():
    return prepare_device_data(make_synthetic_ddi(
        num_drugs=80, feat_dim=8, avg_degree=5.0, seed=0))


def _losses(result):
    return [r["loss"] for r in result["history"]]


def test_kill_and_resume_matches_uninterrupted(resume_data, tmp_path):
    """tests/test_checkpoint_resume.py's check: 2 epochs, "killed", resumed
    in a fresh manager and trainer to 4, equals 4 uninterrupted epochs."""
    def trainer(epochs):
        return Trainer(BiGNN(BiGNNConfig.config1(feat_dim=8)), resume_data,
                       TrainConfig(epochs=epochs, batch_size=64, seed=3),
                       device="cpu")

    _, ref = trainer(4).fit()
    ck = CheckpointManager(str(tmp_path / "ck"))
    trainer(2).fit(ckpt=ck)
    ck.close()
    ck2 = CheckpointManager(str(tmp_path / "ck"))
    _, res = trainer(4).fit(ckpt=ck2)
    ck2.close()
    assert [r["epoch"] for r in res["history"]] == [2, 3]
    np.testing.assert_allclose(_losses(res), _losses(ref)[2:], rtol=0,
                               atol=1e-6)
    assert res["best_epoch"] == ref["best_epoch"]
    np.testing.assert_allclose(res["test_auc"], ref["test_auc"], atol=1e-6)


def test_checkpoint_manager_keeps_newest(tmp_path):
    ck = CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore_state() is None
    for step in (0, 3, 7):
        ck.save_state(step, {"x": torch.full((2,), float(step)),
                             "meta": {"epoch": step}})
    assert ck.steps() == [3, 7] and ck.latest_step() == 7
    assert ck.restore_state()["meta"]["epoch"] == 7
    assert torch.equal(ck.restore_state(3)["x"], torch.full((2,), 3.0))
    assert not list((tmp_path / "m").glob("*.tmp"))
