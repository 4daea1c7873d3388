"""The port's attention convs against the JAX package on the same NumPy
inputs: ``ops.sddmm``, ``DotAttnConv`` in its three branches (block-dense,
dense outer, edge list), ``GATConv``'s block-dense branch (against JAX, and
against its own edge-list branch on the same graph), the DotAttn names of
``bridge`` with the bit-for-bit init, and a whole ``BiGNN`` with GAT inner
and DotAttn outer layers (logits and every gradient).

Everything runs in float32 on the CPU: the port's plain versions and JAX's
``xla`` backend (the JAX package has no Pallas kernel on these paths: its
``sddmm_pallas`` is the XLA composition and its masked dense attention is
XLA). Tolerances: rtol = atol = 1e-5 for ``sddmm`` (two gathers and a dot),
rtol 2e-4 / atol 2e-5 (x max(1, max |g|) for gradients) through whole
layers and models, as tests/test_torch_models.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bignn_tpu import ops as jax_ops
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.data import prepare_device_data as jax_prepare_device_data
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.models import convs as jax_convs
from bignn_tpu.sparse import build_outer_graph as jax_build_outer_graph

from bignn_tpu_torch import bridge, ops
from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.models import BiGNN, BiGNNConfig, parse_conv
from bignn_tpu_torch.sparse import build_outer_graph
from bignn_tpu_torch.sparse.formats import src_sort_arrays

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)
KW = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x))


def _assert_grads(conv, want_tree, prefix="outer.0."):
    """Every parameter gradient of ``conv`` against a JAX gradient tree."""
    want = bridge.params_from_jax(jax.tree.map(np.asarray, want_tree))
    for name, p in conv.named_parameters():
        ref = want[prefix + name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=2e-4,
                                   atol=2e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("heads", [0, 4])  # [N, D] and [N, H, D] factors
def test_sddmm_matches_jax(heads):
    rng = np.random.default_rng(0)
    n, e = 40, 300
    shape = (n, heads, 8) if heads else (n, 8)
    q, k = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.concatenate([np.sort(rng.integers(0, n, e - 20)),
                          np.full(20, n)]).astype(np.int32)  # padding: clip
    g = rng.standard_normal((e, heads) if heads else (e,)).astype(np.float32)

    def jax_f(a, b):
        return jax_ops.sddmm(a, b, jnp.asarray(src), jnp.asarray(dst),
                             backend="xla")

    want, vjp = jax.vjp(jax_f, jnp.asarray(q), jnp.asarray(k))
    want_dq, want_dk = vjp(jnp.asarray(g))
    qt, kt = t(q).requires_grad_(), t(k).requires_grad_()
    got = ops.sddmm(qt, kt, t(src), t(dst))
    got_dq, got_dk = torch.autograd.grad(got, (qt, kt), t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dq.numpy(), np.asarray(want_dq), **TOL)
    np.testing.assert_allclose(got_dk.numpy(), np.asarray(want_dk), **TOL)


def _block_graph(rng, nblk=3, atoms=40):
    """A block-local layout: ``nblk - 1`` blocks holding a molecule of
    ``atoms`` atoms (self-loops, random bonds, one duplicate edge) and a
    padding block; returns the dst-sorted edge list padded with (0, N), its
    source-sort arrays and the ``[nblk, 128, 128]`` count blocks."""
    n = nblk * 128
    src, dst = [], []
    for b in range(nblk - 1):
        a = np.arange(atoms) + 128 * b
        s = rng.integers(0, atoms, 3 * atoms) + 128 * b
        d = rng.integers(0, atoms, 3 * atoms) + 128 * b
        src += [a, s, s[:1]]
        dst += [a, d, d[:1]]
    src, dst = np.concatenate(src), np.concatenate(dst)
    order = np.argsort(dst, kind="stable")
    src = np.concatenate([src[order], np.zeros(30)]).astype(np.int32)
    dst = np.concatenate([dst[order], np.full(30, n)]).astype(np.int32)
    cnt = np.zeros((nblk, 128, 128), np.float32)
    real = dst < n
    np.add.at(cnt, (dst[real] // 128, dst[real] % 128, src[real] % 128), 1.0)
    perm, ssorted = src_sort_arrays(src)
    return n, src, dst, perm, ssorted, cnt


def _jax_apply(jconv, x, branch, n, src, dst, perm, ssorted, cnt):
    """``jconv.apply`` on the xla backend with one of the three forms."""
    def f(p):
        kw = {}
        if branch == "block":
            kw["block_dense"] = (None, jnp.asarray(cnt))
        elif branch == "dense":
            kw["dense"] = (None, jnp.asarray(cnt))
        with jax_ops.backend_scope("xla"):
            return jconv.apply(p, jnp.asarray(x), jnp.asarray(src),
                               jnp.asarray(dst), None, n,
                               src_perm=jnp.asarray(perm),
                               src_sorted=jnp.asarray(ssorted), **kw)
    return f


def _port_conv(spec, in_dim, params):
    conv = parse_conv(spec, in_dim)
    tree = {"outer": {"layer_0": jax.tree.map(np.asarray, params)}}
    conv.load_state_dict({k[len("outer.0."):]: v for k, v in
                          bridge.params_from_jax(tree).items()})
    return conv


def _port_forms(branch, n, src, dst, perm, ssorted, cnt):
    edges = dict(edge_src=t(src), edge_dst=t(dst), num_nodes=n,
                 src_perm=t(perm), src_sorted=t(ssorted))
    if branch == "block":
        return dict(edges, block_dense=(None, t(cnt)))
    if branch == "dense":
        return dict(edges, dense=(None, t(cnt)))
    return edges


def _graph(branch, rng):
    """Block-local inputs for the block branch; else one outer graph of 60
    drugs with duplicate edges and drugs with only their self-loop, its
    dense count mask as ``cnt``."""
    if branch == "block":
        return _block_graph(rng)
    n = 60
    s = rng.integers(0, n - 3, 300)
    d = rng.integers(0, n - 3, 300)
    s, d = np.concatenate([s, s[:40]]), np.concatenate([d, d[:40]])
    kw = dict(symmetrize_edges=False)
    sparse = build_outer_graph(s, d, n, dense_max_nodes=0, **kw)
    dense = build_outer_graph(s, d, n, dense_max_nodes=n, **kw)
    jsparse = jax_build_outer_graph(s, d, n, dense_max_nodes=0, **kw)
    assert np.array_equal(np.asarray(jsparse.edge_src), sparse.edge_src)
    return (n, sparse.edge_src, sparse.edge_dst, sparse.edge_src_perm,
            sparse.edge_src_sorted, dense.dense_cnt)


@pytest.mark.parametrize("spec, branch", [
    ("dotattn:32:4", "block"), ("dotattn:32:4", "dense"),
    ("dotattn:32:4", "edges"), ("gat:32:4", "block")])
def test_attention_conv_matches_jax_and_edge_list(spec, branch):
    """Forward and every gradient of the conv against JAX's ``xla`` path
    in the given branch; the dense forms also against the port's own
    edge-list branch on the same graph (multiplicities included). GAT's
    dense outer and edge-list branches are held in tests/test_torch_ops.py
    and tests/test_torch_sparse_gat.py."""
    rng = np.random.default_rng(3)
    g = _graph(branch, rng)
    n = g[0]
    x = rng.standard_normal((n, 24)).astype(np.float32)
    w = np.cos(np.arange(n * 32)).reshape(n, 32).astype(np.float32)
    jconv = jax_convs.parse_conv(spec, 24)
    params = jconv.init(jax.random.key(0))
    f = _jax_apply(jconv, x, branch, *g)
    want_out = f(params)
    want_g = jax.grad(lambda p: jnp.sum(f(p) * w))(params)
    conv = _port_conv(spec, 24, params)
    got = conv(t(x), **_port_forms(branch, *g))
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_out),
                               **MODEL_TOL)
    _assert_grads(conv, {"outer": {"layer_0": want_g}})
    if branch == "edges":
        return
    dense_grads = {k: p.grad.clone() for k, p in conv.named_parameters()}
    conv.zero_grad()
    edges = _port_forms("edges", *g)
    got_e = conv(t(x), **edges)
    (got_e * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), got_e.detach().numpy(),
                               **MODEL_TOL)
    for name, p in conv.named_parameters():
        ref = p.grad.numpy()
        np.testing.assert_allclose(dense_grads[name].numpy(), ref, rtol=2e-4,
                                   atol=2e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)


def _config(cls, outer="dotattn:16:2:identity"):
    return cls(feat_dim=8, inner_layers=("gat:16:2", "gat:16:2"),
               readout="sum", outer_layers=(outer,), scorer="mlp:16")


def test_dotattn_bridge_names_and_init_bit_for_bit():
    """``BiGNN(config, seed)`` with GAT inner and DotAttn outer layers is
    the JAX init of ``key(seed)`` bit for bit, and the JAX tree loads
    strictly through ``bridge`` (``wq``/``wk``/``wv`` -> ``lin_q``/
    ``lin_k``/``lin_v`` transposed, ``b`` -> ``bias``)."""
    cfg = _config(JaxBiGNNConfig)
    tree = jax.tree.map(np.asarray, JaxBiGNN(cfg).init(jax.random.key(2)))
    state = bridge.params_from_jax(tree)
    assert {k for k in state if k.startswith("outer.0.")} == {
        "outer.0.lin_q.weight", "outer.0.lin_k.weight", "outer.0.lin_v.weight",
        "outer.0.bias"}
    np.testing.assert_array_equal(state["outer.0.lin_q.weight"].numpy(),
                                  tree["outer"]["layer_0"]["wq"].T)
    model = BiGNN(_config(BiGNNConfig), seed=2)
    got = model.state_dict()
    assert set(got) == set(state)
    for name, v in state.items():
        assert torch.equal(got[name], v), name
    bridge.load_jax_params(BiGNN(_config(BiGNNConfig)), tree)  # strict


def _data(port: bool, sparse_outer: bool):
    """The 48-drug dataset (block-local buckets with dense blocks), its
    outer graph dense or rebuilt without dense masks."""
    if port:
        data = prepare_device_data(make_synthetic_ddi(**KW))
        build = build_outer_graph
    else:
        data = jax_prepare_device_data(jax_make_synthetic_ddi(**KW))
        build = jax_build_outer_graph
    if not sparse_outer:
        return data
    tr = data.train_pairs
    return dataclasses.replace(
        data, outer=build(tr[:, 0], tr[:, 1], data.num_drugs,
                          dense_max_nodes=0))


@pytest.mark.parametrize("sparse_outer", [False, True])
def test_bignn_gat_inner_dotattn_outer_matches_jax(sparse_outer):
    """A whole BiGNN (GAT inner on block-dense buckets, DotAttn outer on
    the dense or the edge-list outer graph): logits and every gradient."""
    data, jdata = _data(True, sparse_outer), _data(False, sparse_outer)
    assert all(b.block_cnt is not None for b in data.bucketing.batches)
    assert (data.outer.dense_cnt is None) == sparse_outer
    cfg = _config(JaxBiGNNConfig)
    jax_model = JaxBiGNN(cfg)
    params = jax_model.init(jax.random.key(0))
    pairs = np.random.default_rng(6).integers(0, 48, (60, 2)).astype(np.int32)
    w = np.cos(np.arange(60)).astype(np.float32)
    buckets = [jax.tree.map(jnp.asarray, b) for b in jdata.bucketing.batches]
    outer = jax.tree.map(jnp.asarray, jdata.outer)

    def jax_f(p):
        with jax_ops.backend_scope("xla"):
            return jax_model.apply(p, buckets, jdata.bucketing.graph_index,
                                   outer, jnp.asarray(pairs))

    want = jax_f(params)
    want_g = jax.grad(lambda p: jnp.sum(jax_f(p) * w))(params)
    model = BiGNN(_config(BiGNNConfig))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    got = model([b.to("cpu") for b in data.bucketing.batches],
                data.bucketing.graph_index, data.outer.to("cpu"), t(pairs))
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    want_g = bridge.params_from_jax(jax.tree.map(np.asarray, want_g))
    for name, p in model.named_parameters():
        ref = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=2e-4,
                                   atol=2e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
