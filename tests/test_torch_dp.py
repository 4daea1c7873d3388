"""Data parallelism of the port (``parallel/dp.py``, the trainers' ``mesh``)
against the JAX package on the CPU: JAX on the conftest's 8 fake CPU
devices, the port on a mesh that names ``cpu`` several times, parameters
carried across with ``bridge.params_from_jax``.

* (a) ``Trainer`` on dp = 4 against JAX's ``Trainer(mesh=dp4)`` over 3
  Adam steps (rtol 2e-4 / atol 2e-5, tests/test_torch_train.py: two f32
  paths that sum in other orders), and against the port's own no-mesh
  trajectory at JAX ``tests/test_dp.py``'s tolerances (loss rtol 1e-5,
  parameters rtol 1e-4 / atol 1e-6).
* (b) ``MinibatchTrainer`` host-drawn on dp = 4, resident and not: one SGD
  step against JAX's dp ``train_step`` on the same draws (SGD for the
  reason in tests/test_dp_minibatch.py: Adam's first step turns rounding
  noise on near-zero gradients into +-lr).
* (c) device-drawn dp = 2 and 4 (the draws are the port's
  ``torch.Generator``'s, so no JAX run has them): a chunk of 2 steps against
  a union-batch reference built here, JAX ``tests/test_dp_device_sample.py``
  's tolerances.
* (d) ``fit`` under dp: 3 steps at ``dispatch_chunk`` 2 (a chunk and a
  tail) sample 6 batches; exact evaluation under a mesh equals it without.
* (e) mesh validation.
* (g) the no-atomics check of tests/test_torch_repeat.py on a dp step and a
  tp step (ROADMAP F7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bignn_tpu import ops as jax_ops
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.data import prepare_device_data as jax_prepare_device_data
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.parallel import make_mesh as jax_make_mesh
from bignn_tpu.train import MinibatchTrainer as JaxMinibatchTrainer
from bignn_tpu.train import Trainer as JaxTrainer
from bignn_tpu.train import TrainConfig as JaxTrainConfig

from bignn_tpu_torch import bridge, prng
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.models.bignn import upload_buckets
from bignn_tpu_torch.models.loss import bce_with_logits_elementwise
from bignn_tpu_torch.parallel import (
    dp_train_step_fn,
    make_mesh,
    shard_pairs,
    shard_params_tp,
    tp_train_step_fn,
)
from bignn_tpu_torch.train import MinibatchTrainer, Trainer

TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_RTOL = 1e-5  # JAX tests/test_dp.py
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
KW = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (see
    tests/test_torch_minibatch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cpu_mesh(dp, **kw):
    return make_mesh(dp=dp, devices=["cpu"] * (dp * kw.get("tp", 1)), **kw)


def _assert_params(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


# ---------------------------------------------------------------------------
# (a) the full-graph Trainer
# ---------------------------------------------------------------------------


def _batches(data, n=3):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        pos = data.train_pairs[rng.permutation(len(data.train_pairs))[:32]]
        mask = np.ones(32, np.float32)
        mask[-3:] = 0.0
        out.append((pos, mask))
    return out


def _port_trajectory(data, params, mesh):
    tr = Trainer(BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)),
                 data, TrainConfig(lr=1e-3, batch_size=32), device="cpu",
                 mesh=mesh)
    tr.model.load_state_dict(params)
    losses = [tr.train_step(pos, mask, 0, i).item()
              for i, (pos, mask) in enumerate(_batches(data))]
    return losses, tr.params()


def test_trainer_dp_matches_jax_and_no_mesh():
    """Init key 1, as tests/test_torch_train.py (no gradient there is
    rounding noise)."""
    jdata = jax_prepare_device_data(jax_make_synthetic_ddi(**KW))
    data = prepare_device_data(make_synthetic_ddi(**KW))
    jmodel = JaxBiGNN(JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    jtr = JaxTrainer(jmodel, jdata, JaxTrainConfig(lr=1e-3, batch_size=32),
                     mesh=jax_make_mesh(dp=4, graph=1,
                                        devices=jax.devices()[:4]))
    params = jmodel.init(jax.random.key(1))
    init = bridge.params_from_jax(_np_tree(params))
    opt_state = jtr.optimizer.init(params)
    ekey = jax.random.fold_in(jax.random.key(1), 0)  # key(seed + 1), epoch 0
    want = []
    with jax_ops.backend_scope("xla"):
        for i, (pos, mask) in enumerate(_batches(data)):
            params, opt_state, loss = jtr._train_step(
                params, opt_state, jax.random.fold_in(ekey, i),
                jnp.asarray(pos), jnp.asarray(mask))
            want.append(float(loss))
    got, got_p = _port_trajectory(data, init, _cpu_mesh(4))
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params(got_p, bridge.params_from_jax(_np_tree(params)), **TOL)
    ref, ref_p = _port_trajectory(data, init, None)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    _assert_params(got_p, ref_p, **PARAM_TOL)


# ---------------------------------------------------------------------------
# (b)-(d) the minibatch trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def datasets():
    return make_synthetic_ddi(**KW), jax_make_synthetic_ddi(**KW)


@pytest.mark.parametrize("resident", [True, False])
def test_minibatch_host_dp_matches_jax(datasets, resident):
    """tests/test_dp_minibatch.py's setup: shard s draws batch (0, s)."""
    ds, jds = datasets
    cfg = dict(batch_size=8, epochs=1, seed=3)
    kw = dict(fanouts=(4,), resident=resident, calibrate_caps=2)
    jtr = JaxMinibatchTrainer(
        JaxBiGNN(JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)),
        jds, JaxTrainConfig(**cfg), **kw,
        mesh=jax_make_mesh(dp=4, graph=1, devices=jax.devices()[:4]))
    jtr.optimizer = optax.sgd(0.1)
    params = jtr.model.init(jax.random.key(1))
    with jax_ops.backend_scope("xla"):
        new, _, loss = jtr.train_step(
            params, jtr.optimizer.init(params),
            jtr._to_device(jtr._draw_host(at=(0, 0))))
    tr = MinibatchTrainer(
        BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)), ds,
        TrainConfig(**cfg), **kw, mesh=_cpu_mesh(4), device="cpu")
    tr.model.load_state_dict(bridge.params_from_jax(_np_tree(params)))
    tr.optimizer = torch.optim.SGD(tr.model.parameters(), lr=0.1)
    hbs = tr._draw_host(at=(0, 0))
    assert len(hbs) == 4
    got = tr.train_step(hbs)
    np.testing.assert_allclose(got.item(), float(loss), **TOL)
    _assert_params(tr.params(), bridge.params_from_jax(_np_tree(new)), **TOL)


def _device_trainer(ds, mesh=None, **kw):
    return MinibatchTrainer(
        BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:16",),
                          outer_layers=("gcn:16:identity",)), seed=0),
        ds, TrainConfig(lr=1e-3, epochs=1, batch_size=8, seed=0),
        fanouts=(4,), calibrate_caps=2, device_sample=True,
        dispatch_chunk=2, mesh=mesh, device="cpu", **kw)


@pytest.fixture(scope="module")
def device_ds():
    return make_synthetic_ddi(num_drugs=60, feat_dim=8, avg_degree=6.0,
                              min_atoms=4, max_atoms=10, seed=2)


@pytest.mark.parametrize("dp", [2, 4])
def test_minibatch_device_dp_matches_union(device_ds, dp):
    tr = _device_trainer(device_ds, _cpu_mesh(dp))
    losses, stats = tr.train_chunk_device(0, 0)
    assert losses.shape == (2,)
    assert int(stats["batches_sampled"]) == 2 * dp

    ref = _device_trainer(device_ds)
    d, consts = ref.dsampler, ref._dev_consts
    for step in range(2):
        ref.optimizer.zero_grad(set_to_none=True)
        num = den = 0.0
        for s in range(dp):
            cb, _ = d.sample(consts, d.key_at(0, step * dp + s))
            per = bce_with_logits_elementwise(ref._forward(cb), cb.labels)
            num = num + (per * cb.mask).sum()
            den = den + cb.mask.sum()
        loss = num / den.clamp_min(1.0)
        loss.backward()
        ref.optimizer.step()
        np.testing.assert_allclose(losses[step].item(), loss.item(),
                                   rtol=LOSS_RTOL)
    _assert_params(tr.params(), ref.params(), rtol=5e-4, atol=1e-6)


def test_minibatch_dp_fit_and_exact_eval(device_ds):
    tr = _device_trainer(device_ds, _cpu_mesh(2))
    params, result = tr.fit(steps_per_epoch=3)  # a chunk of 2 and a tail
    rec = result["history"][0]
    assert np.isfinite(rec["loss"]) and rec["batches_sampled"] == 6
    exact = tr.evaluate(params, "val", exact=True)
    assert np.isfinite(exact["val_auc"])
    assert _device_trainer(device_ds).evaluate(params, "val",
                                               exact=True) == exact


def test_minibatch_host_dp_fit_steps(device_ds):
    """Host-drawn under dp: an epoch of the sampler's batches takes
    ceil(len / dp) steps of dp batches each, and the run repeats whatever
    the workers."""
    runs = []
    for workers in (1, 3):
        tr = MinibatchTrainer(
            BiGNN(BiGNNConfig(feat_dim=8, inner_layers=("gin:16",),
                              outer_layers=("gcn:16:identity",))),
            device_ds, TrainConfig(lr=1e-3, epochs=1, batch_size=8),
            fanouts=(4,), calibrate_caps=2, dispatch_chunk=2,
            prefetch_workers=workers, mesh=_cpu_mesh(2), device="cpu")
        shards, step = [], tr._step
        tr._step = lambda hb: (shards.append(len(hb)), step(hb))[1]
        runs.append(tr.fit()[1]["history"][0]["loss"])
        assert shards == [2] * -(-len(tr.sampler) // 2)
    assert np.isfinite(runs[0]) and runs[0] == runs[1]


# ---------------------------------------------------------------------------
# (e) validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dp-only", "no-dp", "batch", "device",
                                  "pairs", "shards"])
def test_mesh_validation(device_ds, case):
    data = prepare_device_data(make_synthetic_ddi(**KW))
    model = BiGNN(BiGNNConfig.config1(feat_dim=8))
    cfg = TrainConfig(batch_size=8)
    if case == "dp-only":
        mesh = make_mesh(dp=2, graph=2, devices=["cpu"] * 4)
        with pytest.raises(ValueError, match="dp-only"):
            Trainer(model, data, cfg, mesh=mesh)
        with pytest.raises(ValueError, match="dp-only"):
            _device_trainer(device_ds, mesh)
    elif case == "no-dp":
        with pytest.raises(ValueError, match="'dp' axis"):
            Trainer(model, data, cfg, mesh=object())
    elif case == "batch":
        with pytest.raises(ValueError, match="not divisible by dp=3"):
            Trainer(model, data, cfg, mesh=_cpu_mesh(3))
    elif case == "device":
        with pytest.raises(ValueError, match="mesh's device"):
            Trainer(model, data, cfg, mesh=_cpu_mesh(2), device="cuda")
    elif case == "pairs":
        with pytest.raises(ValueError, match="split over dp=4"):
            shard_pairs(_cpu_mesh(4), np.zeros((6, 2), np.int32),
                        np.ones(6, np.float32))
    else:  # a step on dp = 2 takes two batches, not one
        tr = _device_trainer(device_ds, _cpu_mesh(2))
        with pytest.raises(ValueError, match="1 batches for a step on dp=2"):
            tr.train_step(tr._draw_host(at=(0, 0))[0])


# ---------------------------------------------------------------------------
# (g) no atomic-scatter autograd node in a dp or a tp step
# ---------------------------------------------------------------------------

# tests/test_torch_repeat.py: nodes whose CUDA backward adds rows by float
# atomics
ATOMIC_NODES = ("IndexSelectBackward0", "GatherBackward0",
                "IndexAddBackward0", "ScatterAddBackward0",
                "EmbeddingBackward0", "TakeBackward0", "PutBackward0")


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


@pytest.mark.parametrize("kind", ["dp", "tp", "minibatch"])
def test_parallel_steps_have_no_atomic_scatter(monkeypatch, device_ds,
                                               kind):
    found = []
    backward = torch.Tensor.backward

    def record(self, *a, **k):
        found.append(_atomic_nodes(self))
        return backward(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "backward", record)
    if kind == "minibatch":
        _device_trainer(device_ds, _cpu_mesh(2)).train_chunk_device(0, 0)
        assert found == [[], []]
        return
    data = prepare_device_data(make_synthetic_ddi(**KW))
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    buckets, gidx = upload_buckets(data.bucketing, model.config.inner_layers,
                                   "cpu")
    if kind == "dp":
        mesh = _cpu_mesh(4)
        step = dp_train_step_fn(model, torch.optim.Adam(model.parameters()),
                                mesh, data.num_drugs)
    else:
        mesh = _cpu_mesh(2, tp=2)
        model = shard_params_tp(mesh, model)
        step = tp_train_step_fn(model, torch.optim.Adam(model.parameters()),
                                mesh, data.num_drugs)
    step(prng.key(3), data.train_pairs[:32], np.ones(32, np.float32),
         buckets, gidx, data.outer.to("cpu"))
    assert found == [[]]
