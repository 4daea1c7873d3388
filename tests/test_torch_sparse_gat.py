"""The port's sparse-outer GAT against the JAX package on the same NumPy
inputs: ``segment_softmax``, ``spmm_multihead`` and
``gather_rows_sorted_grad`` (forward and VJP), the edge-list branch of
``GATConv``, ``BiGNN`` on an outer graph without dense masks, and a whole
``Trainer`` step.

On the CPU each op runs its plain PyTorch version (forward, and the
analytic backward behind its autograd Function); the JAX side runs its
``xla`` backend and, where the Pallas contract holds (sorted ids),
``pallas_interpret``. Tolerances: rtol = atol = 1e-5 for forwards and
1e-4 for gradients (tests/test_torch_ops.py), rtol 2e-4 / atol 2e-5 through
whole layers and steps (tests/test_torch_models.py,
tests/test_torch_train.py). The card's kernels are held against these
plain versions in tests/test_torch_kernels.py.
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
from bignn_tpu.models import convs as jax_convs
from bignn_tpu.models.loss import bce_with_logits_loss as jax_bce
from bignn_tpu.ops.gather import gather_rows_sorted_grad as jax_gather_sg
from bignn_tpu.ops.multihead import spmm_multihead as jax_spmm_mh
from bignn_tpu.sparse import build_outer_graph as jax_build_outer_graph

from bignn_tpu_torch import bridge, ops
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
from bignn_tpu_torch.models import BiGNN, BiGNNConfig, parse_conv
from bignn_tpu_torch.parallel import dp as dp_mod
from bignn_tpu_torch.sparse import build_outer_graph
from bignn_tpu_torch.sparse.formats import src_sort_arrays
from bignn_tpu_torch.train import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)
KW = dict(num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4,
          max_atoms=10, seed=0)


def t(x):
    return torch.from_numpy(np.array(x))


def _sorted_ids(rng, num_segments, num_rows, pad=40):
    """Sorted ids with empty segments (3, 7 and the last) and ``pad``
    trailing padding ids."""
    ids = np.sort(rng.integers(0, num_segments - 1, num_rows - pad))
    ids = ids[(ids != 3) & (ids != 7)]
    return np.concatenate(
        [ids, np.full(num_rows - len(ids), num_segments)]).astype(np.int32)


def _edges(rng, n, e, pad=37):
    """A dst-sorted edge list with a duplicate edge, a destination whose
    only edge is its self-loop, destinations with none, and ``pad`` padding
    edges (src 0, dst n)."""
    src = rng.integers(0, n, e - 2)
    dst = rng.integers(0, n - 3, e - 2)  # n-3, n-2: no edges; n-1: self-loop
    src = np.concatenate([src, [src[0], n - 1]])
    dst = np.concatenate([dst, [dst[0], n - 1]])
    order = np.argsort(dst, kind="stable")
    src = np.concatenate([src[order], np.zeros(pad)]).astype(np.int32)
    dst = np.concatenate([dst[order], np.full(pad, n)]).astype(np.int32)
    return src, dst


# ---------------------------------------------------------------------------
# segment_softmax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
# [E] and [E, H] scores; "long": H 4 and segment 5 on 600 more rows (the
# card's forward holds a segment of up to 256 rows in registers and sweeps
# a longer one)
@pytest.mark.parametrize("heads", [0, 4, 8, "long"])
def test_segment_softmax_fwd_and_vjp_match_jax(backend, heads):
    rng = np.random.default_rng(0)
    n, e = 50, 600
    ids = _sorted_ids(rng, n, e)
    if heads == "long":
        heads = 4
        ids = np.sort(np.concatenate([ids, np.full(600, 5, np.int32)]))
        e = len(ids)
    shape = (e, heads) if heads else (e,)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    valid = ids < n

    def jax_f(s):
        return jax_ops.segment_softmax(s, jnp.asarray(ids), n,
                                       backend=backend)

    want, vjp = jax.vjp(jax_f, jnp.asarray(x))
    (want_d,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_()
    got = ops.segment_softmax(xt, t(ids), n)
    (got_d,) = torch.autograd.grad(got, xt, t(g))
    # the xla path leaves padding rows unspecified; the port gives 0 there
    np.testing.assert_allclose(got.detach().numpy()[valid],
                               np.asarray(want)[valid], **TOL)
    np.testing.assert_allclose(got_d.numpy()[valid],
                               np.asarray(want_d)[valid], **GRAD_TOL)
    assert np.all(got.detach().numpy()[~valid] == 0.0)
    assert np.all(got_d.numpy()[~valid] == 0.0)
    if backend == "pallas_interpret":  # padding rows are 0 there too
        np.testing.assert_array_equal(np.asarray(want)[~valid], 0.0)


def test_segment_softmax_plain_autograd_equals_analytic_vjp():
    """The plain forward is differentiable (a reference run's backward goes
    through it); its autograd equals the analytic backward, and the max
    shift carries no gradient."""
    rng = np.random.default_rng(1)
    ids = _sorted_ids(rng, 30, 300)
    x = t(rng.standard_normal((300, 3)).astype(np.float32)).requires_grad_()
    g = t(rng.standard_normal((300, 3)).astype(np.float32))
    alpha = ops.segment_softmax_plain(x, t(ids), 30)
    (auto,) = torch.autograd.grad(alpha, x, g)
    analytic = ops.segment_softmax_bwd_plain(alpha.detach(), g, t(ids), 30)
    np.testing.assert_allclose(auto.numpy(), analytic.numpy(), **GRAD_TOL)
    sums = ops.segment_sum_plain(alpha.detach(), t(ids), 30).numpy()
    present = np.isin(np.arange(30), ids)
    np.testing.assert_allclose(sums[present], 1.0, rtol=1e-6)
    assert np.all(sums[~present] == 0.0)


# ---------------------------------------------------------------------------
# spmm_multihead and gather_rows_sorted_grad
# ---------------------------------------------------------------------------


def _mh_params():
    """(backend, precomputed, shape): 4 heads of 8 through both backends,
    with and without the source-sort arrays; through ``xla``, a hub source
    (source 7 on 1,000 more edges, so the card's backward shares it among a
    block's warps), a hub destination (destination 7 on 1,000 more edges,
    shared so by the card's forward) and 1 and 8 heads."""
    return [pytest.param(b, p, "h4", id=f"{p}-{b}")
            for p in (True, False) for b in ("xla", "pallas_interpret")] + [
        pytest.param("xla", True, s, id=f"{s}-xla")
        for s in ("hub", "h1", "h8", "hubdst")]


def _mh_edges(rng, n, e, shape):
    src, dst = _edges(rng, n, e)
    if shape not in ("hub", "hubdst"):
        return src, dst
    hub = np.full(1000, 7, np.int32)
    other = rng.integers(0, n - 3, 1000).astype(np.int32)
    if shape == "hubdst":
        hub, other = other, hub
    src = np.concatenate([src, hub])
    dst = np.concatenate([dst, other])
    order = np.argsort(dst, kind="stable")  # the padding stays last
    return src[order], dst[order]


@pytest.mark.parametrize("backend, precomputed, shape", _mh_params())
def test_spmm_multihead_fwd_and_vjp_match_jax(backend, precomputed, shape):
    rng = np.random.default_rng(2)
    n, e = 40, 500
    h, d = {"h1": (1, 8), "h8": (8, 4)}.get(shape, (4, 8))
    src, dst = _mh_edges(rng, n, e, shape)
    v = rng.standard_normal((n, h, d)).astype(np.float32)
    alpha = rng.random((len(src), h)).astype(np.float32)
    g = rng.standard_normal((n, h, d)).astype(np.float32)
    kw = {}
    if precomputed:
        perm, ssorted = src_sort_arrays(src)
        kw = dict(src_perm=perm, src_sorted=ssorted)

    def jax_f(v_, a_):
        return jax_spmm_mh(v_, jnp.asarray(src), jnp.asarray(dst), a_, n,
                           backend=backend,
                           **{k: jnp.asarray(x) for k, x in kw.items()})

    want, vjp = jax.vjp(jax_f, jnp.asarray(v), jnp.asarray(alpha))
    want_dv, want_da = vjp(jnp.asarray(g))
    vt, at = t(v).requires_grad_(), t(alpha).requires_grad_()
    got = ops.spmm_multihead(vt, t(src), t(dst), at, n,
                             **{k: t(x) for k, x in kw.items()})
    got_dv, got_da = torch.autograd.grad(got, (vt, at), t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_dv.numpy(), np.asarray(want_dv),
                               **GRAD_TOL)
    np.testing.assert_allclose(got_da.numpy(), np.asarray(want_da),
                               **GRAD_TOL)
    assert np.all(got_da.numpy()[dst >= n] == 0.0)  # padding edges
    assert np.all(got.detach().numpy()[[n - 3, n - 2]] == 0.0)  # no edges


def test_spmm_multihead_plain_autograd_equals_analytic_vjp():
    rng = np.random.default_rng(3)
    n, e, h, d = 30, 300, 2, 4
    src, dst = _edges(rng, n, e)
    vt = t(rng.standard_normal((n, h, d)).astype(np.float32)).requires_grad_()
    at = t(rng.random((len(src), h)).astype(np.float32)).requires_grad_()
    g = t(rng.standard_normal((n, h, d)).astype(np.float32))
    out = ops.spmm_multihead_plain(vt, t(src), t(dst), at, n)
    auto = torch.autograd.grad(out, (vt, at), g)
    analytic = ops.spmm_multihead_bwd_plain(vt.detach(), t(src), t(dst),
                                            at.detach(), n, g)
    for a, b in zip(auto, analytic):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def _gather_params():
    """(which, backend, shape): the GAT's 4 heads through both backends;
    1, 2 and 8 heads and one long segment through ``xla``."""
    params = [pytest.param(w, b, "h4", id=f"{w}-{b}")
              for w in ("sorted", "perm") for b in ("xla", "pallas_interpret")]
    params += [pytest.param(w, "xla", s, id=f"{w}-xla-{s}")
               for w in ("sorted", "perm") for s in ("h1", "h2", "h8", "long")]
    return params


@pytest.mark.parametrize("which,backend,shape", _gather_params())
def test_gather_rows_sorted_grad_matches_jax(which, backend, shape):
    """The dst gather (sorted ids, padding id n) and the src gather (through
    the source-sort permutation) of the GAT scores. ``long``: one index
    (drug 5) takes 20,000 more edges, a segment of the backward's sum among
    short ones; its cotangent is small integers, so that its sums are exact
    in any order."""
    rng = np.random.default_rng(4)
    n = 40
    h = 4 if shape == "long" else int(shape[1:])
    src, dst = _edges(rng, n, 400)
    if shape == "long":
        real = dst < n
        extra = rng.integers(0, n - 3, 20_000)
        long_run = np.full(20_000, 5)
        s2 = np.concatenate([src[real], long_run if which == "perm" else extra])
        d2 = np.concatenate([dst[real], extra if which == "perm" else long_run])
        order = np.argsort(d2, kind="stable")
        src = np.concatenate([s2[order], src[~real]]).astype(np.int32)
        dst = np.concatenate([d2[order], dst[~real]]).astype(np.int32)
    table = rng.standard_normal((n, h)).astype(np.float32)
    g = (rng.integers(-4, 5, (len(src), h)) if shape == "long" else
         rng.standard_normal((len(src), h))).astype(np.float32)
    if which == "sorted":
        idx, kw = dst, {}
    else:
        perm, ssorted = src_sort_arrays(src)
        idx, kw = src, dict(perm=perm, ids_sorted=ssorted)
    want, vjp = jax.vjp(
        lambda tb: jax_gather_sg(tb, jnp.asarray(idx), backend=backend,
                                 **{k: jnp.asarray(x) for k, x in kw.items()}),
        jnp.asarray(table))
    (want_d,) = vjp(jnp.asarray(g))
    tt = t(table).requires_grad_()
    got = ops.gather_rows_sorted_grad(tt, t(idx),
                                      **{k: t(x) for k, x in kw.items()})
    (got_d,) = torch.autograd.grad(got, tt, t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if backend == "xla" and which == "sorted":
        # XLA's clipped-take VJP sends the padding rows' gradient to row
        # n-1; the Pallas contract (and the port) drops it
        want_d = np.asarray(want_d).copy()
        want_d[n - 1] -= g[dst >= n].sum(0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **GRAD_TOL)


# ---------------------------------------------------------------------------
# GATConv edge-list branch, BiGNN and Trainer on a sparse outer graph
# ---------------------------------------------------------------------------


def _outer_graphs(rng, n, dup):
    """The same directed graph (self-loops, maybe duplicate edges, three
    drugs with only their self-loop) in both packages, sparse and dense."""
    src = rng.integers(0, n - 3, 300)
    dst = rng.integers(0, n - 3, 300)
    if dup:
        src = np.concatenate([src, src[:40]])
        dst = np.concatenate([dst, dst[:40]])
    kw = dict(symmetrize_edges=False)
    return (build_outer_graph(src, dst, n, dense_max_nodes=0, **kw),
            build_outer_graph(src, dst, n, dense_max_nodes=n, **kw),
            jax_build_outer_graph(src, dst, n, dense_max_nodes=0, **kw))


def _port_layer(spec, in_dim, params):
    conv = parse_conv(spec, in_dim)
    tree = {"outer": {"layer_0": jax.tree.map(np.asarray, params)}}
    conv.load_state_dict({k[len("outer.0."):]: v for k, v in
                          bridge.params_from_jax(tree).items()})
    return conv


def _edge_args(g):
    return dict(edge_src=t(g.edge_src), edge_dst=t(g.edge_dst),
                num_nodes=g.num_nodes, src_perm=t(g.edge_src_perm),
                src_sorted=t(g.edge_src_sorted))


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dup", [False, True])
def test_gat_conv_edge_list_matches_jax_and_dense(backend, dup):
    rng = np.random.default_rng(5)
    n, spec = 60, "gat:32:4"
    sparse, dense, jsparse = _outer_graphs(rng, n, dup)
    assert (jnp.asarray(jsparse.edge_src) == sparse.edge_src).all()
    x = rng.standard_normal((n, 24)).astype(np.float32)
    w = np.cos(np.arange(n * 32)).reshape(n, 32).astype(np.float32)
    jconv = jax_convs.parse_conv(spec, 24)
    params = jconv.init(jax.random.key(0))

    def jax_loss(p):
        with jax_ops.backend_scope(backend):
            out = jconv.apply(
                p, jnp.asarray(x), jnp.asarray(jsparse.edge_src),
                jnp.asarray(jsparse.edge_dst),
                jnp.asarray(jsparse.edge_weight), n,
                src_perm=jnp.asarray(jsparse.edge_src_perm),
                src_sorted=jnp.asarray(jsparse.edge_src_sorted))
        return jnp.sum(out * w), out

    (_, want), want_g = jax.value_and_grad(jax_loss, has_aux=True)(params)
    conv = _port_layer(spec, 24, params)
    got = conv(t(x), **_edge_args(sparse))
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    want_g = bridge.params_from_jax(
        {"outer": {"layer_0": jax.tree.map(np.asarray, want_g)}})
    for name, p in conv.named_parameters():
        ref = want_g[f"outer.0.{name}"].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=2e-4,
                                   atol=2e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    # the port's own dense branch on the same graph (multiplicity included)
    sparse_grads = {k: p.grad.clone() for k, p in conv.named_parameters()}
    conv.zero_grad()
    got_dense = conv(t(x), dense=(t(dense.dense_adj), t(dense.dense_cnt)))
    (got_dense * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(),
                               got_dense.detach().numpy(), **MODEL_TOL)
    for name, p in conv.named_parameters():
        np.testing.assert_allclose(sparse_grads[name].numpy(),
                                   p.grad.numpy(), **GRAD_TOL, err_msg=name)


def _sparse_data(port: bool):
    """The 48-drug dataset with its outer graph rebuilt without dense
    masks, in either package."""
    if port:
        data = prepare_device_data(make_synthetic_ddi(**KW))
        build = build_outer_graph
    else:
        data = jax_prepare_device_data(jax_make_synthetic_ddi(**KW))
        build = jax_build_outer_graph
    tr = data.train_pairs
    outer = build(tr[:, 0], tr[:, 1], data.num_drugs, dense_max_nodes=0)
    return dataclasses.replace(data, outer=outer)


def _port_config(cfg):
    return BiGNNConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BiGNNConfig)})


def test_bignn_forward_on_sparse_outer_matches_jax():
    data, jdata = _sparse_data(True), _sparse_data(False)
    assert data.outer.dense_cnt is None and jdata.outer.dense_cnt is None
    cfg = JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)
    jax_model = JaxBiGNN(cfg)
    params = jax_model.init(jax.random.key(0))
    pairs = np.random.default_rng(6).integers(0, 48, (60, 2)).astype(np.int32)
    with jax_ops.backend_scope("xla"):
        want = jax_model.apply(
            params,
            [jax.tree.map(jnp.asarray, b) for b in jdata.bucketing.batches],
            jdata.bucketing.graph_index, jax.tree.map(jnp.asarray, jdata.outer),
            jnp.asarray(pairs))
    model = BiGNN(_port_config(cfg))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    launches = ops.segment_softmax.launches
    with torch.no_grad():
        got = model([b.to("cpu") for b in data.bucketing.batches],
                    data.bucketing.graph_index, data.outer.to("cpu"),
                    t(pairs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert ops.segment_softmax.launches == launches  # the CPU takes plain


def test_train_step_on_sparse_outer_matches_jax():
    """Loss, every gradient and 3 Adam steps of Trainer on an outer graph
    without dense masks equal JAX value_and_grad + optax on the same
    positives and negatives (init key 1, as tests/test_torch_train.py)."""
    data, jdata = _sparse_data(True), _sparse_data(False)
    cfg = JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)
    jax_model = JaxBiGNN(cfg)
    params = jax_model.init(jax.random.key(1))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    buckets = [jax.tree.map(jnp.asarray, b) for b in jdata.bucketing.batches]
    outer = jax.tree.map(jnp.asarray, jdata.outer)

    def loss_fn(p, pos, mask, neg):
        pairs = jnp.concatenate([pos, neg])
        labels = jnp.concatenate([jnp.ones(len(pos)), jnp.zeros(len(neg))])
        logits = jax_model.apply(p, buckets, jdata.bucketing.graph_index,
                                 outer, pairs)
        return jax_bce(logits, labels, jnp.concatenate([mask, mask]))

    step_fn = jax.jit(jax.value_and_grad(loss_fn))
    trainer = Trainer(BiGNN(_port_config(cfg)), data, TrainConfig(lr=1e-3),
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
            np.testing.assert_allclose(got.item(), float(loss), **MODEL_TOL)
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
                                   **MODEL_TOL, err_msg=name)
