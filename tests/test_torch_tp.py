"""Feature sharding of the port (``parallel/tp.py``) against the JAX
package on the CPU: JAX on the conftest's 8 fake CPU devices, the port on
a mesh that names ``cpu`` several times.

* ``tp_param_specs`` equals JAX's specs leaf by leaf, JAX's ``[in, out]``
  axes swapped for the port's ``[out, in]`` weights (``bridge``): the
  Megatron pairing inside the MLPs, a GCN stack not taken for an MLP, the
  attention readout's gate taken for one, DotAttn's projections, and a
  ``tp`` that divides nothing.
* One tp step at ``(dp, tp)`` = (1, 8) and (2, 4) against JAX's
  ``tp_train_step_fn`` on the same parameters, positives and key, and
  against the port's unsharded step, at JAX ``tests/test_tp.py``'s
  tolerances (loss rtol 1e-5; parameters rtol 5e-4 / atol 1e-5); the
  shards are tensors of their own and ``gather_params_tp`` gives the whole
  state dict back.
* ``grad_clip`` under tp takes one global norm over every shard and every
  replicated parameter: an SGD step at (1, 4) equals the unsharded one.
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
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.parallel import make_mesh as jax_make_mesh
from bignn_tpu.parallel import shard_params_tp as jax_shard_params_tp
from bignn_tpu.parallel import tp_param_specs as jax_tp_param_specs
from bignn_tpu.parallel import tp_train_step_fn as jax_tp_train_step_fn

from bignn_tpu_torch import bridge, prng
from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.models.bignn import upload_buckets
from bignn_tpu_torch.parallel import (
    dp_train_step_fn,
    gather_params_tp,
    make_mesh,
    shard_params_tp,
    tp_param_specs,
    tp_train_step_fn,
)

LOSS_RTOL = 1e-5  # JAX tests/test_tp.py
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
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


MODELS = {
    "gin-gat-mlp": JaxBiGNNConfig.full_bignn(feat_dim=8, dim=32, heads=4),
    "gcn-stack": JaxBiGNNConfig(feat_dim=8, inner_layers=("gcn:16", "gcn:16"),
                                outer_layers=("gcn:16:identity",)),
    "attention-gate": JaxBiGNNConfig(feat_dim=8, inner_layers=("gin:32",),
                                     readout="attention:32",
                                     outer_layers=("gcn:32:identity",)),
    "dotattn": JaxBiGNNConfig(feat_dim=8, inner_layers=("dotattn:16:2",),
                              outer_layers=("dotattn:16:2",), scorer="mlp:32"),
}


def _port_model(cfg: JaxBiGNNConfig, **kw) -> BiGNN:
    return BiGNN(BiGNNConfig(**dataclasses.asdict(cfg)), **kw)


@pytest.mark.parametrize("name,tp", [
    ("gin-gat-mlp", 4), ("gin-gat-mlp", 8), ("gcn-stack", 4),
    ("attention-gate", 4), ("dotattn", 2), ("gin-gat-mlp", 3)])
def test_tp_param_specs_match_jax(name, tp):
    cfg = MODELS[name]
    want = jax_tp_param_specs(JaxBiGNN(cfg).init(jax.random.key(0)), tp)
    got = tp_param_specs(_port_model(cfg), tp)
    flat = {}
    for path, spec in bridge._flatten(want):
        port_name, transpose = bridge._rename(path)
        spec = tuple(spec)
        flat[port_name] = spec[::-1] if transpose and spec else spec
    assert got == flat
    if name == "gcn-stack":  # column-parallel throughout, never paired
        assert set(got.values()) == {("tp", None), ("tp",)}
    if tp == 3:
        assert set(got.values()) == {()}


@pytest.fixture(scope="module")
def setup():
    jdata = jax_prepare_device_data(jax_make_synthetic_ddi(**KW),
                                    max_buckets=2)
    data = prepare_device_data(make_synthetic_ddi(**KW), max_buckets=2)
    cfg = MODELS["gin-gat-mlp"]
    # init key 1: no gradient there is rounding noise (tests/test_torch_train)
    params = JaxBiGNN(cfg).init(jax.random.key(1))
    pos = np.random.default_rng(1).integers(0, 48, (16, 2)).astype(np.int32)
    return jdata, data, cfg, params, pos


@pytest.mark.parametrize("dp,tp", [(1, 8), (2, 4)])
def test_tp_step_matches_jax(setup, dp, tp):
    jdata, data, cfg, params, pos = setup
    mask = np.ones(16, np.float32)
    mask[-2:] = 0.0
    jmodel = JaxBiGNN(cfg)
    optimizer = optax.adam(1e-3)
    jmesh = jax_make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    jbuckets = tuple(jax.tree.map(jnp.asarray, b)
                     for b in jdata.bucketing.batches)
    jgidx = tuple(jnp.asarray(i) for i in jdata.bucketing.graph_index)
    jouter = jax.tree.map(jnp.asarray, jdata.outer)
    with jax_ops.backend_scope("xla"), jmesh:
        p_tp = jax_shard_params_tp(jmesh, params)
        step = jax_tp_train_step_fn(jmodel, optimizer, jmesh, 48)
        new, _, loss = step(p_tp, jax.jit(optimizer.init)(p_tp),
                            jax.random.key(7), jnp.asarray(pos),
                            jnp.asarray(mask), jbuckets, jgidx, jouter)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, new))

    init = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    model = _port_model(cfg)
    model.load_state_dict(init)
    mesh = make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))
    replica = shard_params_tp(mesh, model)
    shards = list(replica.parameters())
    assert len({p.data_ptr() for p in shards}) == len(shards)
    assert sum(p.numel() for p in shards) == sum(
        p.numel() for p in model.parameters())
    assert {k: v.shape for k, v in gather_params_tp(replica).items()} == {
        k: v.shape for k, v in init.items()}
    buckets, gidx = upload_buckets(data.bucketing, cfg.inner_layers, "cpu")
    outer = data.outer.to("cpu")
    got = tp_train_step_fn(replica, torch.optim.Adam(shards, lr=1e-3), mesh,
                           48)(prng.key(7), pos, mask, buckets, gidx, outer)
    np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL)
    got_p = gather_params_tp(replica)
    for name, p in got_p.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   err_msg=name, **PARAM_TOL)

    # the unsharded step of the same parameters, positives and key
    ref = _port_model(cfg)
    ref.load_state_dict(init)
    plain = make_mesh(dp=dp, devices=["cpu"] * dp)
    ref_loss = dp_train_step_fn(ref, torch.optim.Adam(ref.parameters(),
                                                      lr=1e-3), plain, 48)(
        prng.key(7), pos, mask, buckets, gidx, outer)
    np.testing.assert_allclose(got.item(), ref_loss.item(), rtol=LOSS_RTOL)
    for name, p in ref.state_dict().items():
        np.testing.assert_allclose(got_p[name].numpy(), p.numpy(),
                                   err_msg=name, **PARAM_TOL)


def test_tp_step_clips_by_one_global_norm(setup):
    """grad_clip under tp: one norm over every shard and every replicated
    parameter, each once, so SGD at lr 1 (the update is the clipped
    gradient) gives the unsharded clipped step."""
    _, data, cfg, params, pos = setup
    mask = np.ones(16, np.float32)
    init = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    buckets, gidx = upload_buckets(data.bucketing, cfg.inner_layers, "cpu")
    outer = data.outer.to("cpu")
    results = []
    for tp in (1, 4):
        model = _port_model(cfg)
        model.load_state_dict(init)
        if tp == 1:
            mesh = make_mesh(dp=1, devices=["cpu"])
            step_fn = dp_train_step_fn
        else:
            mesh = make_mesh(dp=1, tp=tp, devices=["cpu"] * tp)
            model = shard_params_tp(mesh, model)
            step_fn = tp_train_step_fn
        step = step_fn(model, torch.optim.SGD(model.parameters(), lr=1.0),
                       mesh, 48, grad_clip=1e-3)
        loss = step(prng.key(7), pos, mask, buckets, gidx, outer)
        norm = torch.stack([p.grad.norm() for p in model.parameters()]).norm()
        assert norm <= 1e-3 * (1 + 1e-5)
        results.append((loss.item(), gather_params_tp(model) if tp > 1
                        else model.state_dict()))
    (l1, p1), (l4, p4) = results
    np.testing.assert_allclose(l4, l1, rtol=LOSS_RTOL)
    for name, p in p1.items():
        np.testing.assert_allclose(p4[name].numpy(), p.numpy(),
                                   err_msg=name, rtol=1e-5, atol=1e-7)
