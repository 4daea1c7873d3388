"""The port's layers and the whole BiGNN forward against the JAX package,
with parameters carried through ``bignn_tpu_torch.bridge``.

Both sides get the same NumPy inputs (host layouts are equal array for
array, tests/test_torch_formats.py); the JAX side runs its ``xla`` backend.
Tolerance rtol 2e-4 / atol 2e-5, as tests/test_exact_eval.py uses for two
f32 paths that sum in different orders through several layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bignn_tpu import config as jax_config
from bignn_tpu import ops as jax_ops
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.data import prepare_device_data as jax_prepare_device_data
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.models import convs as jax_convs
from bignn_tpu.models import scorer as jax_scorer

from bignn_tpu_torch import bridge, config
from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.models import (
    BiGNN,
    BiGNNConfig,
    DotScorer,
    GATConv,
    GCNConv,
    GINConv,
    MLPScorer,
    parse_conv,
    parse_readout,
)

TOL = dict(rtol=2e-4, atol=2e-5)
KW = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def load_layer(module, jax_params, prefix=("inner", "layer_0")):
    """Load one JAX layer's params into a port module through the bridge."""
    tree = jax.tree.map(np.asarray, jax_params)
    for key in reversed(prefix):
        tree = {key: tree}
    dotted = ".".join("0" if k.startswith("layer_") else k for k in prefix)
    state = {k[len(dotted) + 1:]: v
             for k, v in bridge.params_from_jax(tree).items()}
    module.load_state_dict(state, strict=True)
    return module


@pytest.fixture(scope="module")
def data():
    return (prepare_device_data(make_synthetic_ddi(**KW)),
            jax_prepare_device_data(jax_make_synthetic_ddi(**KW)))


def _block_dense(batch):
    return (t(batch.block_adj), t(batch.block_cnt))


@pytest.mark.parametrize("kind", ["gin", "gcn"])
def test_inner_conv_block_dense(data, kind):
    port_data, _ = data
    batch = port_data.bucketing.batches[0]
    jax_conv = jax_convs.parse_conv(f"{kind}:16", 8)
    params = jax_conv.init(jax.random.key(1))
    if kind == "gin":  # a nonzero eps exercises the (1 + eps) x term
        params["eps"] = jnp.float32(0.3)
    want = jax_conv.apply(
        params, jnp.asarray(batch.node_feat), None, None, None,
        batch.node_cap,
        block_dense=(jnp.asarray(batch.block_adj),
                     jnp.asarray(batch.block_cnt)))
    port = load_layer(parse_conv(f"{kind}:16", 8), params)
    assert isinstance(port, GINConv if kind == "gin" else GCNConv)
    got = port(t(batch.node_feat), block_dense=_block_dense(batch))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("spec", ["gat:16:2:identity", "gat:16:4", "gcn:16",
                                  "gin:16"])
def test_outer_conv_dense(data, spec):
    port_data, _ = data
    outer = port_data.outer
    x = np.random.default_rng(2).standard_normal(
        (outer.num_nodes, 12)).astype(np.float32)
    jax_conv = jax_convs.parse_conv(spec, 12)
    params = jax_conv.init(jax.random.key(2))
    want = jax_conv.apply(
        params, jnp.asarray(x), None, None, None, outer.num_nodes,
        dense=(jnp.asarray(outer.dense_adj), jnp.asarray(outer.dense_cnt)))
    port = load_layer(parse_conv(spec, 12), params, ("outer", "layer_0"))
    got = port(t(x), dense=(t(outer.dense_adj), t(outer.dense_cnt)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["mlp", "dot"])
def test_scorers(kind):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((37, 16)).astype(np.float32)
    pairs = rng.integers(-2, 40, (50, 2)).astype(np.int32)  # some clipped
    if kind == "mlp":
        jax_sc = jax_scorer.MLPScorer(16, hidden=8)
        params = jax_sc.init(jax.random.key(3))
        port = load_layer(MLPScorer(16, hidden=8), params, ("scorer",))
    else:
        jax_sc, params, port = jax_scorer.DotScorer(16), {}, DotScorer(16)
    with torch.no_grad():
        np.testing.assert_allclose(
            port(t(emb), t(pairs)).numpy(),
            np.asarray(jax_sc.apply(params, jnp.asarray(emb),
                                    jnp.asarray(pairs))), **TOL)
        one = port.apply_one_vs_all(t(emb), torch.tensor(5))
        np.testing.assert_allclose(
            one.numpy(),
            np.asarray(jax_sc.apply_one_vs_all(params, jnp.asarray(emb),
                                               jnp.int32(5))), **TOL)
        batch = port.apply_one_vs_all(t(emb), torch.tensor([5, 0, 36]))
        assert batch.shape == (3, 37)
        np.testing.assert_allclose(batch[0].numpy(), one.numpy(), **TOL)


def test_bignn_forward_matches_jax_apply(data):
    port_data, jax_data = data
    jax_model = JaxBiGNN(JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16,
                                                   heads=2))
    params = jax_model.init(jax.random.key(0))
    pairs = np.random.default_rng(4).integers(0, 48, (60, 2)).astype(np.int32)
    with jax_ops.backend_scope("xla"):
        want = jax_model.apply(
            params,
            [jax.tree.map(jnp.asarray, b) for b in jax_data.bucketing.batches],
            jax_data.bucketing.graph_index,
            jax.tree.map(jnp.asarray, jax_data.outer), jnp.asarray(pairs))

    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model([b.to("cpu") for b in port_data.bucketing.batches],
                    port_data.bucketing.graph_index,
                    port_data.outer.to("cpu"), t(pairs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bridge_names_and_shapes():
    jax_model = JaxBiGNN(JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16,
                                                   heads=2))
    tree = jax.tree.map(np.asarray, jax_model.init(jax.random.key(0)))
    state = bridge.params_from_jax(tree)
    model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2))
    assert set(state) == set(model.state_dict())
    w = tree["inner"]["layer_0"]["mlp"]["layer_0"]["w"]  # [in, out]
    np.testing.assert_array_equal(
        state["inner.0.mlp.layers.0.weight"].numpy(), w.T)
    assert state["inner.0.eps"].shape == ()
    assert state["outer.0.a_l"].shape == (2, 8)
    with pytest.raises(ValueError, match="unknown JAX parameter"):
        bridge.params_from_jax({"outer": {"layer_0": {"wq": w}}})
    del tree["scorer"]
    with pytest.raises(RuntimeError, match="Missing key"):
        bridge.load_jax_params(model, tree)


def test_seeded_init_is_reproducible():
    """The constructor loads init_params(seed), the JAX init of the seed
    (tests/test_torch_train.py holds it to JAX bit for bit)."""
    cfg = BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)
    a = BiGNN(cfg, seed=0).state_dict()
    b = BiGNN(cfg, seed=0).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    want = BiGNN(cfg, seed=1).init_params(0)
    assert all(torch.equal(a[k], want[k]) for k in a)
    other = BiGNN(cfg, seed=1).state_dict()
    assert not torch.equal(a["outer.0.a_l"], other["outer.0.a_l"])
    lim = np.sqrt(6.0 / (8 + 16))  # glorot on the first Dense
    assert a["inner.0.mlp.layers.0.weight"].abs().max() <= lim


@pytest.mark.parametrize(
    "name", ["config1", "config2", "config2-real", "config3", "config4",
             "config5", "config5-large", "small", "drugbank", "large"])
def test_config_registry_matches_jax(name):
    port, ref = config.get_config(name), jax_config.get_config(name)
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert dataclasses.asdict(port.train) == dataclasses.asdict(ref.train)
    for f in dataclasses.fields(port):
        if f.name not in ("model", "train"):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_unported_parts_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_conv("dotattn:16:2", 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_readout("mean", 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GINConv(8, 16)(torch.zeros(4, 8))  # streaming edge-list branch
    with pytest.raises(NotImplementedError):
        GATConv(8, 16, heads=2)(torch.zeros(128, 8),
                                block_dense=(None, torch.zeros(1, 128, 128)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GCNConv(8, 16)(torch.zeros(4, 8))  # streaming edge-list branch
    # bf16 is ported (config4); other compute types are refused
    assert BiGNN(dataclasses.replace(BiGNNConfig.full_bignn(8),
                                     dtype="bfloat16")).compute_dtype == (
        torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        BiGNN(dataclasses.replace(BiGNNConfig.full_bignn(8),
                                  dtype="float16"))
