"""The port's hierarchical samplers against the JAX package on the CPU.

``HierarchicalSampler`` is a NumPy copy: the same seed gives the same caps,
tables and batches, array for array. ``MinibatchTrainer._expand_compact`` of
one ``CompactBatch`` gives the same padded batch as JAX's, field for field
(features included, int8 block counts against ``build_block_adj_xla``).
``DeviceSampler`` draws with a ``torch.Generator``, not JAX's threefry, so
its batches are held to the JAX sampler's invariants
(tests/test_device_sampler.py) and, over 16 draws each, to its
distribution. Everything runs at config4's settings scaled down: a
300-drug ``synthetic-large``, batch 32, ``max_drugs`` 256, fanouts (10,),
superrows (4, 32).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bignn_tpu.data import load_dataset as jax_load_dataset
from bignn_tpu.data.device_sampler import DeviceSampler as JaxDeviceSampler
from bignn_tpu.data.hierarchical import HierarchicalSampler as JaxSampler
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.ops.pallas.block_adj import build_block_adj_xla
from bignn_tpu.train.trainer import MinibatchTrainer as JaxMinibatchTrainer

from bignn_tpu_torch import ops
from bignn_tpu_torch.data import load_dataset
from bignn_tpu_torch.data.device_sampler import DeviceSampler
from bignn_tpu_torch.data.hierarchical import HierarchicalSampler
from bignn_tpu_torch.models import BiGNN, BiGNNConfig
from bignn_tpu_torch.train import MinibatchTrainer

DATA = dict(num_drugs=300, avg_degree=20.0)
SAMPLER = dict(batch_size=32, neg_ratio=1, fanouts=(10,), seed=0,
               max_drugs=256, calibrate_caps=4)
DIST_REL = 0.10  # mean real drugs / real outer edges, port vs JAX, 16 draws


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the test workers
    share a few cores, and PyTorch's default of one thread per core
    oversubscribes them (each small op then waits on descheduled threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def samplers():
    ds = load_dataset("synthetic-large", **DATA)
    jds = jax_load_dataset("synthetic-large", **DATA)
    return ds, jds, HierarchicalSampler(ds, **SAMPLER), JaxSampler(jds,
                                                                   **SAMPLER)


@pytest.fixture(scope="module")
def device_sampler(samplers):
    ds, _, host, _ = samplers
    dev = DeviceSampler(host)
    return ds, host, dev, dev.constants().to("cpu")


def _fields(batch) -> dict:
    return {k: v for k, v in vars(batch).items() if v is not None}


def _assert_same(port, ref):
    """Equal fields, array for array (dtypes included)."""
    a, b = _fields(port), _fields(ref)
    assert sorted(a) == sorted(b)
    for name, want in b.items():
        got = a[name]
        if isinstance(want, (int, np.integer)):
            assert int(got) == int(want), name
            continue
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_caps_and_tables_equal_jax(samplers):
    _, _, host, ref = samplers
    for cap in ("drug_budget", "node_cap", "edge_cap", "outer_edge_cap",
                "pair_cap", "r_node", "r_edge", "mols_per_block"):
        assert getattr(host, cap) == getattr(ref, cap), cap
    assert (host.r_node, host.r_edge) == (4, 32) and host.quantized
    _assert_same(host.tables(), ref.tables())


@pytest.mark.parametrize("at", [(0, 0), (0, 7), (3, 2)])
def test_sample_compact_at_equals_jax(samplers, at):
    _, _, host, ref = samplers
    _assert_same(host.sample_compact_at(*at), ref.sample_compact_at(*at))
    assert host.truncation_stats(reset=True) == ref.truncation_stats(
        reset=True)


def test_compact_from_pairs_equals_jax(samplers):
    """An evaluation-style batch: fewer pairs than pair_cap (padded)."""
    ds, _, host, ref = samplers
    pairs = ds.split_edges("val")[:40].astype(np.int64)
    labels = np.ones(40, np.float32)
    _assert_same(host.compact_from_pairs(pairs, labels),
                 ref.compact_from_pairs(pairs, labels))
    with pytest.raises(ValueError, match="pair_cap"):
        host.compact_from_pairs(np.zeros((host.pair_cap + 1, 2), np.int64),
                                np.zeros(host.pair_cap + 1, np.float32))


def test_host_gathered_batches_equal_jax(samplers):
    """The host-gathered ``HierarchicalBatch`` (``sample_at``) and the
    id-order chunks that cover every drug (``compact_chunks_all_nodes``,
    the exact evaluation's encode chunks) equal JAX's."""
    _, _, host, ref = samplers
    _assert_same(host.sample_at(2, 5), ref.sample_at(2, 5))
    chunks = list(host.compact_chunks_all_nodes())
    want = list(ref.compact_chunks_all_nodes())
    assert len(chunks) == len(want) > 1
    for (cb, ids), (jcb, jids) in zip(chunks, want):
        np.testing.assert_array_equal(ids, jids)
        _assert_same(cb, jcb)
    np.testing.assert_array_equal(np.concatenate([i for _, i in chunks]),
                                  np.arange(host.num_nodes))


def test_expand_compact_equals_jax(samplers):
    """The resident expansion of one batch, field for field, with the
    block counts in int8 (r_node**2 = 16 <= 127) equal to JAX's xla build
    cast to int8."""
    ds, jds, host, ref = samplers
    cfg = BiGNNConfig.full_bignn(feat_dim=ds.feat_dim, dim=32, heads=4)
    jcfg = JaxBiGNNConfig.full_bignn(feat_dim=ds.feat_dim, dim=32, heads=4)
    port = types.SimpleNamespace(sampler=host, model=BiGNN(cfg),
                                 _rank_slots=MinibatchTrainer._rank_slots)
    jax_self = types.SimpleNamespace(
        sampler=ref, dense_inner=True, model=JaxBiGNN(jcfg),
        _rank_slots=JaxMinibatchTrainer._rank_slots)
    cb = host.sample_compact_at(1, 4)
    pb = MinibatchTrainer._expand_compact(port, cb.to("cpu"),
                                          host.tables().to("cpu"))
    jpb = JaxMinibatchTrainer._expand_compact(
        jax_self, jax.tree.map(jnp.asarray, ref.sample_compact_at(1, 4)),
        jax.tree.map(jnp.asarray, ref.tables()))
    assert pb.block_cnt.dtype == torch.int8
    for name in ("node_feat", "node_mask", "edge_src", "edge_dst",
                 "edge_weight", "graph_ids", "graph_n_nodes", "block_estarts",
                 "block_adj", "block_cnt"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                      np.asarray(getattr(jpb, name)),
                                      err_msg=name)
    assert (pb.num_graphs, pb.node_cap, pb.edge_cap) == (
        jpb.num_graphs, jpb.node_cap, jpb.edge_cap)
    want = np.asarray(build_block_adj_xla(
        jnp.asarray(pb.edge_src.numpy()), jnp.asarray(pb.edge_dst.numpy()),
        None, pb.node_cap)).astype(np.int8)
    np.testing.assert_array_equal(pb.block_cnt.numpy(), want)
    assert int(pb.block_cnt.max()) > 1  # superrow pairs repeat edges


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8, torch.int16])
def test_block_adjacency_dtypes_equal_jax(samplers, out_dtype):
    """The plain build in every output type against build_block_adj_xla
    cast (a weighted bf16 build rounds each weight to bf16 first, as
    build_block_adj)."""
    ds, _, host, _ = samplers
    port = types.SimpleNamespace(
        sampler=host, _rank_slots=MinibatchTrainer._rank_slots,
        model=BiGNN(BiGNNConfig(feat_dim=ds.feat_dim,
                                inner_layers=("gcn:16",),
                                outer_layers=("gat:16:2",))))
    pb = MinibatchTrainer._expand_compact(
        port, host.sample_compact_at(0, 1).to("cpu"),
        host.tables().to("cpu"))
    src, dst, w = pb.edge_src, pb.edge_dst, pb.edge_weight
    j = [jnp.asarray(x.numpy()) for x in (src, dst, w)]
    got = ops.block_adjacency(src, dst, None, pb.block_estarts, pb.node_cap,
                              out_dtype)
    want = np.asarray(build_block_adj_xla(j[0], j[1], None, pb.node_cap))
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    if out_dtype.is_floating_point:
        jw = j[2].astype(jnp.bfloat16).astype(jnp.float32) if (
            out_dtype == torch.bfloat16) else j[2]
        got = ops.block_adjacency(src, dst, w, pb.block_estarts, pb.node_cap,
                                  out_dtype)
        want = np.asarray(build_block_adj_xla(j[0], j[1], jw, pb.node_cap))
        want = torch.from_numpy(np.array(want)).to(out_dtype).float().numpy()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                                   atol=1e-7)
    else:
        with pytest.raises(ValueError, match="float output"):
            ops.block_adjacency(src, dst, w, pb.block_estarts, pb.node_cap,
                                out_dtype)


def _draw(dev, consts, epoch, step):
    cb, stats = dev.sample(consts, dev.key_at(epoch, step))
    return cb, {k: int(v) for k, v in stats.items()}


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_device_sampler_invariants(device_sampler, step):
    """tests/test_device_sampler.py's structural invariants on the port's
    draws: static shapes, budget, seeds kept, class packing, the outer
    graph dst-sorted with its mirror src-sort permutation, real edges."""
    ds, host, dev, consts = device_sampler
    qn = np.diff(host._mol_qptr).astype(np.int64)
    cb, stats = _draw(dev, consts, 0, step)
    shapes = {"nodes": (dev.D,), "pack_off": (dev.D,),
              "block_slot0": (dev.NC // 128 + 1,), "outer_src": (dev.OE,),
              "outer_dst": (dev.OE,), "outer_src_perm": (dev.OE,),
              "pairs": (dev.pair_cap, 2), "labels": (dev.pair_cap,),
              "mask": (dev.pair_cap,)}
    for name, shape in shapes.items():
        assert tuple(getattr(cb, name).shape) == shape, name
    assert cb.outer_src.dtype == torch.int16 and cb.pairs.dtype == torch.int16
    n = int(cb.n_real)
    assert 0 < n <= dev.D and stats["batches_sampled"] == 1
    nodes = cb.nodes[:n].numpy().astype(np.int64)
    assert len(np.unique(nodes)) == n and nodes.max() < ds.num_drugs
    # seeds first: every pair endpoint was kept (2 * 64 seeds < D)
    assert float(cb.mask.min()) == 1.0
    # class packing: offsets non-decreasing r_node multiples, no molecule
    # straddles a 128-row block, disjoint rows, within node_cap
    off = cb.pack_off[:n].numpy().astype(np.int64)
    sizes = qn[nodes]
    assert np.all(np.diff(off) >= 0) and np.all(off % dev.r_node == 0)
    assert np.all(off % 128 + sizes <= 128) and np.all(off + sizes <= dev.NC)
    assert np.all(off[1:] >= off[:-1] + sizes[:-1])
    np.testing.assert_array_equal(
        cb.block_slot0.numpy(),
        np.searchsorted(off // 128, np.arange(dev.NC // 128 + 1), "left"))
    # outer graph: dst-sorted, padding at D, each non-loop edge a train
    # edge, one self-loop per live slot
    od = cb.outer_dst.numpy().astype(np.int64)
    osrc_all = cb.outer_src.numpy().astype(np.int64)
    live = od < dev.D
    assert np.all(np.diff(od) >= 0) and np.all(od[~live] == dev.D)
    gs, gd = nodes[osrc_all[live]], nodes[od[live]]
    train = ds.split_edges("train")
    eset = set(map(tuple, np.concatenate([train, train[:, ::-1]]).tolist()))
    assert all((a, b) in eset for a, b in zip(gs[gs != gd].tolist(),
                                              gd[gs != gd].tolist()))
    np.testing.assert_array_equal(np.sort(osrc_all[live][gs == gd]),
                                  np.arange(n))
    # mirror src-sort permutation: a permutation of [0, OE) that sorts the
    # sources (padding as id D) and equals outer_src_sorted
    perm = cb.outer_src_perm.numpy().astype(np.int64)
    np.testing.assert_array_equal(np.sort(perm), np.arange(dev.OE))
    got = np.where(live, osrc_all, dev.D)[perm]
    assert np.all(np.diff(got) >= 0)
    np.testing.assert_array_equal(got, cb.outer_src_sorted.numpy())
    np.testing.assert_array_equal(od[perm][live], osrc_all[live])
    # positives are train edges
    pairs = cb.pairs.numpy().astype(np.int64)
    pos = cb.labels.numpy() == 1
    assert pos.sum() == dev.batch_size
    tp = set(map(tuple, ds.split_edges("train").tolist()))
    assert all(tuple(x) in tp for x in nodes[pairs[pos]].tolist())


def test_device_sampler_is_a_function_of_seed_epoch_step(device_sampler):
    _, _, dev, consts = device_sampler
    a, _ = _draw(dev, consts, 1, 5)
    b, _ = _draw(dev, consts, 1, 5)
    c, _ = _draw(dev, consts, 1, 6)
    names = ("nodes", "pack_off", "outer_src", "outer_dst", "pairs")
    for name in names:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert any(not torch.equal(getattr(a, n), getattr(c, n)) for n in names)
    # the opt-in reshuffle keeps every neighbour list's multiset
    shuffled = dev.reshuffle_adj(consts, 2)
    assert not torch.equal(shuffled.adj_dst, consts.adj_dst)
    flat, ref = shuffled.adj_dst.reshape(-1), consts.adj_dst.reshape(-1)
    ptr = consts.adj_ptr.numpy()
    for v in (0, 17, 299):
        lo, hi = ptr[v], ptr[v + 1]
        assert sorted(flat[lo:hi].tolist()) == sorted(ref[lo:hi].tolist())


def test_device_sampler_distribution_matches_jax(samplers, device_sampler):
    """Different generators, one estimator: over 16 draws each, the mean
    counts of real drugs and of real outer edges agree within DIST_REL."""
    _, _, dev, consts = device_sampler
    jdev = JaxDeviceSampler(samplers[3])
    assert (jdev.D, jdev.NC, jdev.OE, jdev.U, jdev.n_node_hops) == (
        dev.D, dev.NC, dev.OE, dev.U, dev.n_node_hops)
    jconsts = jax.tree.map(jnp.asarray, jdev.constants())
    jsample = jax.jit(jdev.sample)
    port, ref = [], []
    for step in range(16):
        cb, _ = _draw(dev, consts, 0, step)
        port.append((int(cb.n_real), int((cb.outer_dst < dev.D).sum())))
        jcb, _ = jsample(jconsts, jdev.key_at(0, step))
        ref.append((int(jcb.n_real), int((jcb.outer_dst < jdev.D).sum())))
    port, ref = np.mean(port, axis=0), np.mean(ref, axis=0)
    np.testing.assert_allclose(port, ref, rtol=DIST_REL)
