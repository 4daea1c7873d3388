"""The port's edge-partitioned ("p2") path against the JAX package on the
CPU: ``build_padded_batch``'s graph slots, the outer partition and the
sharded unions (array for array), the exchange (against ``lax.all_to_all``
and the Pallas kernel under the TPU simulator, and its autograd), the
distributed outer layers, the p2 train step and the p2 scorer.

The JAX side runs on the 8 fake CPU devices of tests/conftest.py, its
``xla`` backend, under ``shard_map``; the port runs every shard of a mesh
that names the CPU several times. Floats: two f32 paths that sum in
different orders, so rtol 2e-4 / atol 2e-5 (x the largest gradient of a
tensor) as tests/test_torch_train.py, and the loss and the parameters
after one Adam step at rtol 1e-5 (lr 1e-3 moves a parameter by at most
~1e-3, so its rounding differences stay near the float32 epsilon). bf16
layers: the sums of both packages round to bf16 at other places, so
BF16_TOL as tests/test_torch_minibatch.py.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from bignn_tpu import ops as jax_ops
from bignn_tpu.data import make_synthetic_ddi as jax_make_synthetic_ddi
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.ops.pallas.collectives import all_to_all_pallas
from bignn_tpu.parallel import build_outer_partition as jax_partition
from bignn_tpu.parallel import build_sharded_inner as jax_sharded_inner
from bignn_tpu.parallel import device_put_plan as jax_put_plan
from bignn_tpu.parallel import make_mesh as jax_make_mesh
from bignn_tpu.parallel import make_p2_train_step as jax_p2_step
from bignn_tpu.parallel import halo as jax_halo
from bignn_tpu.parallel.halo import dist_outer_forward as jax_dist_outer
from bignn_tpu.parallel.step import make_p2_score_fn as jax_p2_score
from bignn_tpu.sparse import COOGraph as JaxCOOGraph
from bignn_tpu.sparse import build_padded_batch as jax_padded_batch

from bignn_tpu_torch import bridge, ops, prng
from bignn_tpu_torch.data import make_synthetic_ddi
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.parallel import (
    build_outer_partition,
    build_sharded_inner,
    device_put_plan,
    dist_outer_forward,
    make_mesh,
    make_p2_score_fn,
    make_p2_train_step,
    shard_device,
)
from bignn_tpu_torch.parallel.halo import dist_gin_apply
from bignn_tpu_torch.sparse import (
    COOGraph,
    build_outer_graph,
    build_padded_batch,
)

TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=3e-2, atol=6e-2)
KW = dict(num_drugs=40, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tiny tensors (see
    tests/test_torch_minibatch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def datasets():
    return make_synthetic_ddi(**KW), jax_make_synthetic_ddi(**KW)


def _fields(batch):
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}


def _assert_same(got, want, what):
    """Every field of a port container equals the JAX one's: arrays exactly
    (value and type), the rest by equality."""
    g, w = _fields(got), _fields(want)
    assert set(g) <= set(w), what
    for name, v in g.items():
        ref = w[name]
        if isinstance(ref, np.ndarray):
            assert isinstance(v, np.ndarray), (what, name)
            assert v.dtype == ref.dtype, (what, name, v.dtype, ref.dtype)
            np.testing.assert_array_equal(v, ref, err_msg=f"{what}.{name}")
        else:
            assert v == ref, (what, name, v, ref)


def _graphs(rng, n, lo=3, hi=9):
    out = []
    for _ in range(n):
        k = int(rng.integers(lo, hi))
        e = int(rng.integers(k, 3 * k))
        out.append((rng.normal(size=(k, 5)).astype(np.float32),
                    rng.integers(0, k, e), rng.integers(0, k, e)))
    return ([COOGraph(*g) for g in out], [JaxCOOGraph(*g) for g in out])


def _mesh_jax(dp, graph):
    return jax_make_mesh(dp=dp, graph=graph,
                         devices=jax.devices()[: dp * graph])


def _mesh(dp, graph):
    return make_mesh(dp=dp, graph=graph, devices=["cpu"] * (dp * graph))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# graph slots, the partition, the sharded unions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_local", [False, True])
def test_padded_batch_graph_slots_match_jax(block_local):
    rng = np.random.default_rng(0)
    graphs, jgraphs = _graphs(rng, 6)
    kw = dict(node_cap=256, edge_cap=256, block_local=block_local,
              graph_slots=[1, 2, 5, 6, 9, 11], num_graphs_override=16)
    got = build_padded_batch(graphs, **kw)
    _assert_same(got, jax_padded_batch(jgraphs, **kw), "batch")
    assert got.num_graphs == 16 and got.graph_n_nodes[[0, 3, 15]].sum() == 0


@pytest.mark.parametrize("kw", [
    dict(graph_slots=[0, 1]),
    dict(graph_slots=[2, 1, 3]),
    dict(num_graphs_override=2),
    dict(graph_slots=[0, 1, 4], num_graphs_override=4),
], ids=["length", "order", "override-small", "slot-beyond"])
def test_padded_batch_graph_slot_errors_match_jax(kw):
    graphs, jgraphs = _graphs(np.random.default_rng(1), 3)
    with pytest.raises(ValueError) as want:
        jax_padded_batch(jgraphs, 64, 128, **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        build_padded_batch(graphs, 64, 128, **kw)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_outer_partition_matches_jax(datasets, n_shards):
    ds, _ = datasets
    train = ds.split_edges("train")
    got = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs,
                                n_shards)
    want = jax_partition(train[:, 0], train[:, 1], ds.num_drugs, n_shards)
    _assert_same(got, want, "plan")
    assert got.stats() == want.stats()
    assert got.ext_size == want.ext_size
    for a, b in zip(got.local_src, got.remote_src):
        assert a.max() < got.node_block <= b[b > 0].min()


@pytest.mark.parametrize("block_local", [True, False])
@pytest.mark.parametrize("split", [False, True])
def test_sharded_inner_matches_jax(datasets, split, block_local):
    ds, jds = datasets
    train = ds.split_edges("train")
    plan = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs, 4)
    got = build_sharded_inner(ds.molecules, plan, split_boundary=split,
                              block_local=block_local)
    want = jax_sharded_inner(jds.molecules, plan, split_boundary=split,
                             block_local=block_local)
    got, want = (got, want) if split else ((got,), (want,))
    for g, w in zip(got, want):
        _assert_same(g, w, "union")
        assert g.graph_ids.shape[0] == 4
        assert (g.block_estarts is not None) == block_local


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


def _sendbufs(g, s=3, f=5, seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(g, g, s, f)).astype(np.float32)


def test_all_to_all_plain_matches_lax():
    x = _sendbufs(4)
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("graph",))

    def f(v):
        return jax.lax.all_to_all(v[0], "graph", 0, 0)[None]

    want = np.array(jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P("graph"), out_specs=P("graph")))(x))
    got = ops.all_to_all_plain([torch.from_numpy(b) for b in x])
    assert torch.equal(torch.stack(got), torch.from_numpy(want))
    got = ops.all_to_all([torch.from_numpy(b) for b in x])  # the CPU route
    assert torch.equal(torch.stack(got), torch.from_numpy(want))


def test_all_to_all_matches_pallas_kernel():
    """The Pallas remote-DMA kernel under the TPU simulator (barrier,
    remote copies, per-source semaphores) on 4 fake devices."""
    from jax.experimental.pallas import tpu as pltpu

    x = _sendbufs(4, s=8, f=128)
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("graph",))

    def f(v):
        return all_to_all_pallas(v[0], "graph", 4,
                                 interpret=pltpu.InterpretParams())[None]

    want = np.array(jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P("graph"), out_specs=P("graph"),
        check_vma=False))(x))
    got = ops.all_to_all_plain([torch.from_numpy(b) for b in x])
    assert torch.equal(torch.stack(got), torch.from_numpy(want))


def test_halo_exchange_matches_jax():
    from bignn_tpu.parallel import halo_exchange as jax_halo_exchange

    from bignn_tpu_torch.parallel import halo_exchange

    g, b, f = 4, 6, 16
    rng = np.random.default_rng(1)
    h = rng.normal(size=(g, b, f)).astype(np.float32)
    send_idx = rng.integers(0, b, size=(g, g, 2)).astype(np.int32)
    mesh = JaxMesh(np.array(jax.devices()[:g]), ("graph",))

    def f_jax(hb, idx):
        return jax_halo_exchange(hb[0], idx[0])[None]

    want = np.array(jax.jit(jax.shard_map(
        f_jax, mesh=mesh, in_specs=(P("graph"),) * 2,
        out_specs=P("graph")))(h, send_idx))
    got = halo_exchange(_shards(h), _shards(send_idx))
    assert torch.equal(torch.stack(got), torch.from_numpy(want))


def test_all_to_all_autograd_is_the_exchange_of_cotangents():
    x = [torch.from_numpy(b).requires_grad_() for b in _sendbufs(3)]
    ct = [torch.from_numpy(b) for b in _sendbufs(3, seed=5)]
    out = ops.all_to_all(x)
    torch.autograd.backward(out, ct)
    want = ops.all_to_all_plain(ct)
    for a, b in zip(x, want):
        assert torch.equal(a.grad, b)


@pytest.mark.parametrize("case", ["empty", "leading", "shape", "dtype",
                                  "strided", "devices"])
def test_all_to_all_refuses(case):
    bufs = [torch.zeros(2, 3, 4), torch.zeros(2, 3, 4)]
    if case == "empty":
        bufs = []
    elif case == "leading":
        bufs = [torch.zeros(3, 3, 4)] * 2
    elif case == "shape":
        bufs[1] = torch.zeros(2, 3, 5)
    elif case == "dtype":
        bufs[1] = bufs[1].double()
    elif case == "strided":
        bufs[1] = torch.zeros(2, 4, 3).transpose(1, 2)
    else:
        bufs[1] = torch.zeros(2, 3, 4, device="meta")
    err = NotImplementedError if case == "devices" else ValueError
    with pytest.raises(err):
        ops.all_to_all(bufs)


def test_make_mesh():
    mesh = make_mesh(dp=2, graph=2, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "graph": 2}
    assert mesh.local_graph == [0, 1] and mesh.process_count == 1
    assert mesh.first_device == torch.device("cpu")
    assert mesh.cards == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(dp=2, graph=3, devices=["cpu"] * 4)
    # distinct cards form a mesh (no card is touched to build it), each
    # entry on its own device, as JAX's single controller over its chips
    cards = [torch.device("cuda", i) for i in range(4)]
    mesh = make_mesh(dp=1, graph=2, devices=["cuda:0", "cuda:1"])
    assert mesh.devices.tolist() == [cards[:2]]
    assert mesh.first_device == cards[0] and mesh.cards == cards[:2]
    mesh = make_mesh(dp=1, graph=4, devices=cards)
    assert [shard_device(mesh, j) for j in range(4)] == cards
    mesh = make_mesh(dp=4, devices=cards)
    assert mesh.shape == {"dp": 4, "graph": 1}
    assert mesh.devices[:, 0].tolist() == cards
    with pytest.raises(NotImplementedError):
        make_mesh(dp=2, graph=1, devices=["cpu", "cuda:0"])
    # the tp axis (JAX bignn_tpu/parallel/mesh.py:31-39)
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "tp": 2}
    assert mesh.first_device == torch.device("cpu")
    assert make_mesh(tp=4, devices=["cpu"] * 8).shape == {"dp": 2, "tp": 4}
    with pytest.raises(ValueError, match="don't compose"):
        make_mesh(dp=1, graph=2, tp=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="device count"):
        make_mesh(dp=3, tp=2, devices=["cpu"] * 4)
    mesh = make_mesh(dp=1, tp=2, devices=["cuda:0", "cuda:1"])
    assert mesh.shape == {"dp": 1, "tp": 2}
    assert mesh.devices.tolist() == [cards[:2]]


# ---------------------------------------------------------------------------
# the distributed outer layers
# ---------------------------------------------------------------------------


def _shards(arr):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arr]


@pytest.mark.parametrize("outer,dtype", [
    (("gcn:32",), "float32"), (("gin:32",), "float32"),
    (("gat:32:4",), "float32"), (("gcn:32", "gat:32:2"), "float32"),
    (("gin:32", "gat:32:4"), "bfloat16"),
], ids=["gcn", "gin", "gat", "gcn-gat", "gin-gat-bf16"])
def test_dist_outer_forward_matches_jax(outer, dtype):
    """Against JAX's dist_outer_forward under shard_map (4 shards) and
    against the port's single-device propagate_outer."""
    n, g, f = 50, 4, 32
    rng = np.random.default_rng(3)
    u, v = rng.integers(0, n, 300), rng.integers(0, n, 300)
    keep = u != v
    u, v = u[keep], v[keep]
    h = rng.normal(size=(n, f)).astype(np.float32)
    cfg = JaxBiGNNConfig(feat_dim=f, inner_layers=(), outer_layers=outer)
    jmodel = JaxBiGNN(cfg)
    params = jmodel.init(jax.random.key(0))
    model = BiGNN(BiGNNConfig(feat_dim=f, inner_layers=(),
                              outer_layers=outer))
    model.load_state_dict(bridge.params_from_jax(_np_tree(params)))

    plan = build_outer_partition(u, v, n, g)
    B = plan.node_block
    h_pad = np.zeros((g * B, f), np.float32)
    h_pad[:n] = h
    h_blocks = h_pad.reshape(g, B, f)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mesh = JaxMesh(np.array(jax.devices()[:g]), ("graph",))

    def shard_fn(hb, src, dst, w, sidx, perm, srt):
        return jax_dist_outer(jmodel, params, hb[0], src[0], dst[0], w[0],
                              sidx[0], src_perm=perm[0],
                              src_sorted=srt[0])[None]

    with jax_ops.backend_scope("xla"):
        want = np.asarray(jax.jit(jax.shard_map(
            shard_fn, mesh=mesh, in_specs=(P("graph"),) * 7,
            out_specs=P("graph")))(
                jnp.asarray(h_blocks).astype(jdt), plan.edge_src,
                plan.edge_dst, plan.edge_weight, plan.send_idx,
                plan.src_perm, plan.src_sorted), np.float32)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = dist_outer_forward(
            model, [x.to(tdt) for x in _shards(h_blocks)],
            _shards(plan.edge_src), _shards(plan.edge_dst),
            _shards(plan.edge_weight), _shards(plan.send_idx),
            src_perm=_shards(plan.src_perm),
            src_sorted=_shards(plan.src_sorted))
    assert all(x.dtype == torch.float32 for x in got)
    got = torch.cat(got).numpy().reshape(g * B, -1)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(got, want.reshape(g * B, -1), **tol)
    if dtype == "float32":
        og = build_outer_graph(u, v, n)
        with torch.no_grad():
            ref = model.propagate_outer(torch.from_numpy(h), og.to("cpu"))
        np.testing.assert_allclose(got[:n], ref.numpy(), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the distributed GIN's split SpMMs: each source order holds a hub row
# ---------------------------------------------------------------------------


def _gin_hub_plan(n=60, g=4, e=600, seed=5):
    """A plan whose shard 0 reads three quarters of its sources from the
    halo, and ``dist_gin_apply``'s two SpMMs on its shard 0, built as both
    packages' halo.py build them: ``(src, dst, weight, rows of x)`` of the
    owned-source one (halo sources clamped to row B - 1, weight 0) and of
    the halo-source one (owned sources on halo row 0, weight 0), with the
    plan's source sort clamped alike."""
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = u != v
    plan = build_outer_partition(u[keep], v[keep], n, g)
    b, n_halo = plan.node_block, g * plan.halo_size
    src, dst = plan.edge_src[0], plan.edge_dst[0]
    perm, srt = plan.src_perm[0], plan.src_sorted[0]
    w_loc = (src < b).astype(np.float32)
    lays = {"local": (np.minimum(src, b - 1), dst, w_loc, b,
                      np.minimum(srt, b - 1)),
            "halo": (np.clip(src - b, 0, n_halo - 1), dst, 1.0 - w_loc,
                     n_halo, np.clip(srt - b, 0, n_halo - 1))}
    return plan, perm, lays


@pytest.mark.parametrize("layout", ["local", "halo"])
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_gin_split_spmm_matches_jax(layout, backend):
    """``ops.spmm_sorted_coo`` forward, ``d_x`` and ``d_w`` on a G(ii)-shaped
    hub layout (clamped ids, 0/1 weights, padding edges) against JAX's
    dispatch (``xla``) and ``spmm_pallas`` in interpret mode, with the
    plan's source sort; f32 sums of up to ~200 edges in other orders, so
    the module's TOL."""
    plan, perm, lays = _gin_hub_plan()
    src, dst, w, num_x, srt = lays[layout]
    real = dst < plan.node_block
    hub = np.bincount(src[real])
    assert hub.max() >= (0.5 if layout == "local" else 0.15) * real.sum()
    rng = np.random.default_rng(6)
    f = 16
    x = rng.standard_normal((num_x, f)).astype(np.float32)
    gy = rng.standard_normal((plan.node_block, f)).astype(np.float32)
    sort = dict(src_perm=perm.astype(np.int32),
                src_sorted=srt.astype(np.int32))

    def jax_f(xx, ww):
        return jax_ops.spmm_sorted_coo(
            xx, jnp.asarray(src), jnp.asarray(dst), ww, plan.node_block,
            backend=backend, **{k: jnp.asarray(a) for k, a in sort.items()})

    want, vjp = jax.vjp(jax_f, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = ops.spmm_sorted_coo(xt, torch.from_numpy(src),
                              torch.from_numpy(dst), wt, plan.node_block,
                              **{k: torch.from_numpy(a)
                                 for k, a in sort.items()})
    got_dx, got_dw = torch.autograd.grad(got, [xt, wt], torch.from_numpy(gy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), **TOL)


def test_dist_gin_apply_matches_jax():
    """Both packages' ``dist_gin_apply`` (4 shards; JAX under shard_map on
    the fake CPU devices, ``xla``) on the same numpy rows of the hub plan:
    the layer's output and the rows' gradient, at the module's TOL."""
    plan, _, _ = _gin_hub_plan()
    g, b, f = plan.n_shards, plan.node_block, 32
    rng = np.random.default_rng(7)
    h = rng.standard_normal((g, b, f)).astype(np.float32)
    gy = rng.standard_normal((g, b, f)).astype(np.float32)
    outer = ("gin:32",)
    cfg = JaxBiGNNConfig(feat_dim=f, inner_layers=(), outer_layers=outer)
    jmodel = JaxBiGNN(cfg)
    params = jmodel.init(jax.random.key(0))
    model = BiGNN(BiGNNConfig(feat_dim=f, inner_layers=(),
                              outer_layers=outer))
    model.load_state_dict(bridge.params_from_jax(_np_tree(params)))
    conv, _ = jmodel._outer_stack(jmodel._inner_stack()[1])
    mesh = JaxMesh(np.array(jax.devices()[:g]), ("graph",))

    def shard_fn(hb, src, dst, w, sidx, perm, srt):
        return jax_halo.dist_gin_apply(
            conv[0], params["outer"]["layer_0"], hb[0], src[0], dst[0], w[0],
            sidx[0], src_perm=perm[0], src_sorted=srt[0])[None]

    def loss(hb):
        out = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P("graph"),) * 7,
                            out_specs=P("graph"))(
            hb, plan.edge_src, plan.edge_dst, plan.edge_weight,
            plan.send_idx, plan.src_perm, plan.src_sorted)
        return (out * gy).sum(), out

    with jax_ops.backend_scope("xla"):
        (_, want), want_dh = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jnp.asarray(h))
    hs = [x.requires_grad_() for x in _shards(h)]
    got = dist_gin_apply(model.outer[0], hs, _shards(plan.edge_src),
                         _shards(plan.edge_dst), _shards(plan.edge_weight),
                         _shards(plan.send_idx),
                         src_perm=_shards(plan.src_perm),
                         src_sorted=_shards(plan.src_sorted))
    got_dh = torch.autograd.grad(
        sum((o * t).sum() for o, t in zip(got, _shards(gy))), hs)
    np.testing.assert_allclose(torch.stack(got).detach().numpy(),
                               np.asarray(want), **TOL)
    np.testing.assert_allclose(torch.stack(got_dh).numpy(),
                               np.asarray(want_dh), **TOL)


# ---------------------------------------------------------------------------
# the p2 train step and scorer
# ---------------------------------------------------------------------------


def _capture():
    """An optax stage that keeps the gradients in its state and passes
    them on: JAX's step then returns its gradients in ``opt_state[0]``."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _jax_side(jds, cfg, dp, graph, overlap):
    train = jds.split_edges("train")
    plan = jax_partition(train[:, 0], train[:, 1], jds.num_drugs, graph)
    inner = jax_sharded_inner(jds.molecules, plan, split_boundary=overlap)
    mesh = _mesh_jax(dp, graph)
    return mesh, jax_put_plan(mesh, plan, inner)


def _port_side(ds, model, dp, graph, overlap):
    train = ds.split_edges("train")
    plan = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs,
                                 graph)
    inner = build_sharded_inner(ds.molecules, plan, split_boundary=overlap)
    mesh = _mesh(dp, graph)
    return mesh, device_put_plan(mesh, plan, inner,
                                 model.config.inner_layers)


def _pos(seed=4, n=16):
    return np.random.default_rng(seed).integers(
        0, KW["num_drugs"], (n, 2)).astype(np.int32)


@pytest.mark.parametrize("dp,graph,overlap,remat,outer", [
    (1, 4, False, False, ("gin:16", "gat:16:2:identity")),
    (2, 2, False, False, ("gat:16:2:identity",)),
    (1, 4, True, False, ("gcn:16", "gat:16:2:identity")),
    (2, 2, True, False, ("gin:16", "gat:16:2:identity")),
    (1, 4, False, True, ("gat:16:2:identity",)),
], ids=["1x4", "2x2", "1x4-overlap", "2x2-overlap", "1x4-remat"])
def test_p2_step_matches_jax(datasets, dp, graph, overlap, remat, outer):
    """Loss, every gradient and the parameters after one Adam step equal
    JAX's make_p2_train_step on the same positives and key (init key 1, as
    tests/test_torch_train.py: no gradient there is rounding noise)."""
    ds, jds = datasets
    cfg = dataclasses.replace(
        JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
        outer_layers=outer)
    jmodel = JaxBiGNN(cfg)
    params = jmodel.init(jax.random.key(1))
    opt = optax.chain(_capture(), optax.adam(1e-3))
    jmesh, jplan = _jax_side(jds, cfg, dp, graph, overlap)
    step = jax_p2_step(jmodel, opt, jmesh, jds.num_drugs, overlap=overlap,
                       remat=remat)
    pos, mask = _pos(), np.ones(16, np.float32)
    mask[-3:] = 0.0
    with jax_ops.backend_scope("xla"), jmesh:
        new_params, (grads, _), loss = step(
            params, opt.init(params), jax.random.key(9), jnp.asarray(pos),
            jnp.asarray(mask), *jplan)

    model = BiGNN(BiGNNConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(bridge.params_from_jax(_np_tree(params)))
    mesh, plan_d = _port_side(ds, model, dp, graph, overlap)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    got = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                             overlap=overlap, remat=remat)(
        prng.key(9), pos, mask, plan_d)
    np.testing.assert_allclose(got.item(), float(loss), **STEP_TOL)
    want_g = bridge.params_from_jax(_np_tree(grads))
    want_p = bridge.params_from_jax(_np_tree(new_params))
    for name, p in model.named_parameters():
        scale = want_g[name].abs().max().item()
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(scale, 1.0),
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   **STEP_TOL, err_msg=name)


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
def test_p2_step_clips_like_jax(datasets, opt_name):
    """grad_clip 1e-3 on 4 graph shards: one step against JAX's p2 step
    with the same optimizer behind optax.clip_by_global_norm: Adam, as
    make_optimizer chains it, and SGD at lr 1, whose update is the clipped
    gradient itself (Adam's first step hardly sees the gradient's scale).
    The norm is taken once over the replicated parameters."""
    ds, jds = datasets
    cfg = JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)
    jmodel = JaxBiGNN(cfg)
    params = jmodel.init(jax.random.key(1))
    inner = optax.adam(1e-3) if opt_name == "adam" else optax.sgd(1.0)
    opt = optax.chain(optax.clip_by_global_norm(1e-3), inner)
    jmesh, jplan = _jax_side(jds, cfg, 1, 4, False)
    pos, mask = _pos(), np.ones(16, np.float32)
    with jax_ops.backend_scope("xla"), jmesh:
        new_params, _, loss = jax_p2_step(jmodel, opt, jmesh, jds.num_drugs)(
            params, opt.init(params), jax.random.key(9), jnp.asarray(pos),
            jnp.asarray(mask), *jplan)
    model = BiGNN(BiGNNConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(bridge.params_from_jax(_np_tree(params)))
    mesh, plan_d = _port_side(ds, model, 1, 4, False)
    optimizer = (torch.optim.Adam(model.parameters(), lr=1e-3)
                 if opt_name == "adam"
                 else torch.optim.SGD(model.parameters(), lr=1.0))
    got = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                             grad_clip=1e-3)(prng.key(9), pos, mask, plan_d)
    np.testing.assert_allclose(got.item(), float(loss), **STEP_TOL)
    norm = torch.stack([p.grad.norm() for p in model.parameters()]).norm()
    assert norm <= 1e-3 * (1 + 1e-5)
    want_p = bridge.params_from_jax(_np_tree(new_params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   **STEP_TOL, err_msg=name)


def test_p2_step_remat_changes_nothing(datasets):
    """remat recomputes in the backward: loss and gradients equal the step
    without it, bit for bit on the CPU (same ops, same order)."""
    ds, _ = datasets
    results = []
    for remat in (False, True):
        model = BiGNN(BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
                      seed=1)
        mesh, plan_d = _port_side(ds, model, 1, 4, False)
        step = make_p2_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.0), mesh,
            ds.num_drugs, remat=remat)
        loss = step(prng.key(3), _pos(), np.ones(16, np.float32), plan_d)
        results.append((loss, {k: p.grad for k, p in
                               model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("dp,graph,overlap", [(1, 4, False), (2, 2, True)])
def test_p2_score_fn_matches_jax(datasets, dp, graph, overlap):
    ds, jds = datasets
    cfg = JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)
    jmodel = JaxBiGNN(cfg)
    params = jmodel.init(jax.random.key(2))
    jmesh, jplan = _jax_side(jds, cfg, dp, graph, overlap)
    pairs = _pos(seed=6, n=24)
    with jax_ops.backend_scope("xla"), jmesh:
        want = np.asarray(jax_p2_score(jmodel, jmesh, overlap=overlap)(
            params, jnp.asarray(pairs), *jplan))
    model = BiGNN(BiGNNConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(bridge.params_from_jax(_np_tree(params)))
    mesh, plan_d = _port_side(ds, model, dp, graph, overlap)
    got = make_p2_score_fn(model, mesh, overlap=overlap)(pairs, plan_d)
    assert got.dtype == torch.float32 and got.shape == (24,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
