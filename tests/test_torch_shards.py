"""The edge-partitioned (p2) path at more graph shards than row 9's launch
takes pointers for by value (32): the port's partition, distributed outer
forward and exchange at 40 and 64 shards against the JAX package, on the
CPU (the exchange's CPU route; its kernel at these counts is held to the
same plain version on the card by tests/test_torch_kernels.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.parallel import build_outer_partition as jax_partition
from bignn_tpu.sparse import build_outer_graph as jax_outer_graph

from bignn_tpu_torch import bridge, ops
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.parallel import build_outer_partition, dist_outer_forward

N_DRUGS = 120


@pytest.fixture(scope="module")
def edges():
    rng = np.random.default_rng(11)
    u, v = rng.integers(0, N_DRUGS, 700), rng.integers(0, N_DRUGS, 700)
    keep = u != v
    return u[keep], v[keep]


def _shards(arr):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arr]


@pytest.mark.parametrize("n_shards", [40, 64])
def test_outer_partition_matches_jax_past_32_shards(edges, n_shards):
    """A pure function of the edges: every array of the plan, its sizes and
    its stats, as JAX's."""
    u, v = edges
    got = build_outer_partition(u, v, N_DRUGS, n_shards)
    want = jax_partition(u, v, N_DRUGS, n_shards)
    assert got.n_shards == want.n_shards == n_shards
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.ext_size == want.ext_size
    assert got.stats() == want.stats()


@pytest.mark.parametrize("outer", [("gat:16:4",), ("gcn:16", "gin:16")],
                         ids=["gat", "gcn-gin"])
def test_dist_outer_forward_at_40_shards_matches_jax(edges, outer):
    """The port's distributed outer layers over 40 shards, all on the CPU
    (one device named 40 times: every layer's exchange takes the CPU
    route), against JAX's single-device propagate_outer on the whole graph
    with the same parameters (tests/test_partition_halo.py at 4 shards)."""
    u, v = edges
    g, f = 40, 16
    h = np.random.default_rng(3).normal(size=(N_DRUGS, f)).astype(np.float32)
    cfg = JaxBiGNNConfig(feat_dim=f, inner_layers=(), outer_layers=outer)
    jmodel = JaxBiGNN(cfg)
    params = jmodel.init(jax.random.key(0))
    og = jax.tree.map(jnp.asarray, jax_outer_graph(u, v, N_DRUGS))
    want = np.asarray(jax.jit(jmodel.propagate_outer)(params, jnp.asarray(h),
                                                      og))
    model = BiGNN(BiGNNConfig(feat_dim=f, inner_layers=(),
                              outer_layers=outer))
    model.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params)))

    plan = build_outer_partition(u, v, N_DRUGS, g)
    b = plan.node_block
    h_pad = np.zeros((g * b, f), np.float32)
    h_pad[:N_DRUGS] = h
    with torch.no_grad():
        got = dist_outer_forward(
            model, _shards(h_pad.reshape(g, b, f)), _shards(plan.edge_src),
            _shards(plan.edge_dst), _shards(plan.edge_weight),
            _shards(plan.send_idx), src_perm=_shards(plan.src_perm),
            src_sorted=_shards(plan.src_sorted))
    assert len(got) == g
    got = torch.cat(got).numpy().reshape(g * b, -1)[:N_DRUGS]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("g", [40, 64])
def test_all_to_all_past_32_shards_is_the_transposition(g):
    """``ops.all_to_all`` on the CPU route at G shards: receive buffer j's
    slot i is send buffer i's slot j, exactly (the transposition in NumPy),
    and its backward is the exchange of the cotangents."""
    rng = np.random.default_rng(g)
    x = rng.normal(size=(g, g, 2, 3)).astype(np.float32)
    ct = rng.normal(size=(g, g, 2, 3)).astype(np.float32)
    bufs = [torch.from_numpy(b.copy()).requires_grad_() for b in x]
    got = ops.all_to_all(bufs)
    assert len(got) == g
    np.testing.assert_array_equal(torch.stack(got).detach().numpy(),
                                  x.transpose(1, 0, 2, 3))
    torch.autograd.backward(got, [torch.from_numpy(c) for c in ct])
    np.testing.assert_array_equal(np.stack([b.grad.numpy() for b in bufs]),
                                  ct.transpose(1, 0, 2, 3))
