"""The port's streaming inner level and its remaining readouts against the
JAX package on the same NumPy inputs: ``spmm_sorted_coo`` (Queue 2 row 7),
``block_spmm`` (row 6) and ``segment_max`` (row 5), forward and VJP; the
mean, max and attention readouts; ``BiGNN`` on a bucket of molecules over
128 atoms (which is not block-local, so every inner conv streams);
``upload_buckets`` above the block-dense threshold; the non-block-local
``_expand_compact`` and one ``MinibatchTrainer(resident=False)`` step.

On the CPU each op runs its plain PyTorch version (forward, and the backward
behind its autograd Function); the JAX side runs its ``xla`` backend and,
where a Pallas contract holds (sorted ids; block-local plans), its Pallas
kernels in interpret mode. Tolerances: rtol = atol = 1e-5 for forwards and
1e-4 for gradients (tests/test_torch_ops.py), rtol 2e-4 / atol 2e-5 x max
|g| through whole layers and models (tests/test_torch_models.py). The bf16
cases (``-bf16`` in their ids) hold the port's rounding (bf16 messages,
float32 sums, one rounding at the store) against JAX's, which may round at
other places: forwards within 1e-2 x max(1, max |JAX|), gradients within
1e-1 x max |g| and a cosine of at least 0.99, as chip_smoke.py holds
config4's step; a max of bf16 values is exact. A whole bf16 model's logits
are held within 2e-2 x max(1, max |JAX|): two bf16 steps of its output. The card's kernels are held
against these plain versions in tests/test_torch_kernels.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bignn_tpu import ops as jax_ops
from bignn_tpu.data import load_dataset as jax_load_dataset
from bignn_tpu.models import BiGNN as JaxBiGNN
from bignn_tpu.models import BiGNNConfig as JaxBiGNNConfig
from bignn_tpu.models import readout as jax_readout
from bignn_tpu.ops.pallas.block_spmm import block_spmm as jax_block_spmm
from bignn_tpu.ops.pallas.segment import segment_max_pallas
from bignn_tpu.sparse import COOGraph as JaxCOOGraph
from bignn_tpu.sparse import bucket_graphs as jax_bucket_graphs
from bignn_tpu.sparse import build_outer_graph as jax_build_outer_graph
from bignn_tpu.train.trainer import MinibatchTrainer as JaxMinibatchTrainer
from bignn_tpu.train.trainer import TrainConfig as JaxTrainConfig

from bignn_tpu_torch import bridge, ops
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data import load_dataset
from bignn_tpu_torch.models import BiGNN, BiGNNConfig, parse_readout
from bignn_tpu_torch.models.bignn import upload_buckets
from bignn_tpu_torch.sparse import COOGraph, bucket_graphs, build_outer_graph
from bignn_tpu_torch.sparse import formats as formats_mod
from bignn_tpu_torch.train import MinibatchTrainer

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)
# molecules over 128 atoms in a small synthetic-large, config3's fanouts
LARGE = dict(num_drugs=120, avg_degree=12.0, max_atoms=160)
SAMPLER_KW = dict(fanouts=(10, 5), max_drugs=64, calibrate_caps=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small tensors (the test workers
    share a few cores; see tests/test_torch_minibatch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x))


def _edges(rng, n, e, pad=37):
    """A dst-sorted edge list with a duplicate edge, a destination whose
    only edge is its self-loop, destinations with none, and ``pad`` padding
    edges (src 0, dst n)."""
    src = rng.integers(0, n, e - 2)
    dst = rng.integers(0, n - 3, e - 2)
    src = np.concatenate([src, [src[0], n - 1]])
    dst = np.concatenate([dst, [dst[0], n - 1]])
    order = np.argsort(dst, kind="stable")
    src = np.concatenate([src[order], np.zeros(pad)]).astype(np.int32)
    dst = np.concatenate([dst[order], np.full(pad, n)]).astype(np.int32)
    return src, dst


def _hole_ids(rng, num_segments, max_run=6, max_hole=40):
    """Valid id runs in order with padding-id runs between them (the
    block-local readout layout, ROADMAP F1/F2), segment 5 empty."""
    parts = []
    for s in range(num_segments):
        if s != 5:
            parts.append(np.full(rng.integers(1, max_run), s))
        if rng.random() < 0.5:
            parts.append(np.full(rng.integers(1, max_hole), num_segments))
    return np.concatenate(parts).astype(np.int32)


def _bf16_close(got, want, what="forward", tol=1e-2):
    """The bf16 tolerances of the module docstring, in float32: ``tol`` x
    max(1, max |want|) for a forward, 1e-1 x max |want| and a cosine of
    0.99 for a gradient."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(1.0, np.abs(want).max()) if what == "forward" else (
        np.abs(want).max())
    tol = tol if what == "forward" else 1e-1
    assert np.abs(got - want).max() <= tol * scale, what
    if what != "forward":
        cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= 0.99, (what, cos)


def _grads_close(got, want, names=None):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=2e-4, atol=2e-5 * max(np.abs(w).max(), 1.0),
            err_msg=str(names[i] if names else i))


# ---------------------------------------------------------------------------
# spmm_sorted_coo (row 7)
# ---------------------------------------------------------------------------


def _cases(f32, bf16):
    """pytest parameters: the float32 cases under their own ids, the bf16
    ones with ``-bf16`` after them."""
    return [pytest.param(*c, False, id="-".join(map(str, c))) for c in f32] + [
        pytest.param(*c, True, id="-".join(map(str, c)) + "-bf16")
        for c in bf16]


@pytest.mark.parametrize("precomputed, weighted, backend, bf16", _cases(
    [(p, w, b) for b in ("xla", "pallas_interpret") for w in (False, True)
     for p in (False, True)],
    [(True, w, "pallas_interpret") for w in (False, True)]))
def test_spmm_sorted_coo_fwd_and_vjp_match_jax(backend, weighted,
                                                precomputed, bf16):
    """Forward, ``d_x`` and ``d_w`` against JAX's dispatch (``xla``, and
    ``spmm_pallas`` in interpret mode on the sorted dst), with and without
    the source-sort arrays; bf16 rows with float32 weights against the
    Pallas path (``d_w`` in float32, as JAX gives it)."""
    rng = np.random.default_rng(0)
    n, e, f = 60, 500, 12
    src, dst = _edges(rng, n, e)
    perm = np.argsort(src, kind="stable").astype(np.int32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = np.where(dst < n, rng.random(len(src)), 0.0).astype(np.float32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    sort = dict(src_perm=perm, src_sorted=src[perm]) if precomputed else {}
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                      torch.float32)

    def jax_f(xx, ww):
        return jax_ops.spmm_sorted_coo(
            xx, jnp.asarray(src), jnp.asarray(dst), ww if weighted else None,
            n, backend=backend, **{k: jnp.asarray(v) for k, v in sort.items()})

    want, vjp = jax.vjp(jax_f, jnp.asarray(x, dt[0]), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g, dt[0]))
    xt, wt = t(x).to(dt[1]).requires_grad_(), t(w).requires_grad_()
    got = ops.spmm_sorted_coo(xt, t(src), t(dst), wt if weighted else None,
                              n, **{k: t(v) for k, v in sort.items()})
    inputs = [xt, wt] if weighted else [xt]
    got_d = torch.autograd.grad(got, inputs, t(g).to(dt[1]))
    if bf16:
        assert got.dtype == got_d[0].dtype == torch.bfloat16
        _bf16_close(got, want.astype(jnp.float32))
        _bf16_close(got_d[0], want_dx.astype(jnp.float32), "d_x")
        if weighted:
            assert got_d[1].dtype == torch.float32
            assert want_dw.dtype == jnp.float32
            _bf16_close(got_d[1], want_dw, "d_w")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_d[0].numpy(), np.asarray(want_dx),
                               **GRAD_TOL)
    if weighted:
        np.testing.assert_allclose(got_d[1].numpy(), np.asarray(want_dw),
                                   **GRAD_TOL)
        assert np.all(got_d[1].numpy()[dst == n] == 0.0)  # padding edges
    # the plain backward equals the analytic one behind the Function
    d_x = ops.spmm_sorted_coo_bwd_plain(t(g), t(src), t(dst),
                                        t(w) if weighted else None, n)
    np.testing.assert_allclose(d_x.numpy(), got_d[0].numpy(), **GRAD_TOL)


# ---------------------------------------------------------------------------
# block_spmm (row 6)
# ---------------------------------------------------------------------------


def _block_plan(rng, nblk, f, dense=False):
    """A block-local edge list over ``nblk`` 128-row blocks with its
    transposed plan, as ``build_padded_batch`` lays them out, plus one edge
    whose source lies in another block and another 512-row TPU program (so
    both packages drop it), and padding edges. ``dense``: block 2 also holds
    every (d, s) pair once, and block 3 one pair 300 times (a count that
    bf16 holds exactly only as 256 + 44)."""
    n = nblk * 128
    src, dst = [], []
    for b in range(nblk):
        k = int(rng.integers(20, 200))
        src.append(rng.integers(b * 128, (b + 1) * 128, k))
        dst.append(rng.integers(b * 128, (b + 1) * 128, k))
    if dense:
        every = np.arange(2 * 128, 3 * 128)
        src.append(np.tile(every, 128))
        dst.append(np.repeat(every, 128))
        src.append(np.full(300, 3 * 128 + 9))
        dst.append(np.full(300, 3 * 128 + 100))
    src.append([5])  # block 0 -> block 4
    dst.append([4 * 128 + 7])
    src, dst = np.concatenate(src), np.concatenate(dst)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
    w = rng.random(len(src)).astype(np.float32)
    bounds = np.arange(nblk + 1) * 128
    torder = np.argsort(src, kind="stable")
    tdst = src[torder]
    pad = 40
    plan = dict(
        src=np.concatenate([src, np.zeros(pad, np.int32)]),
        dst=np.concatenate([dst, np.full(pad, n, np.int32)]),
        weight=np.concatenate([w, np.zeros(pad, np.float32)]),
        estarts=np.searchsorted(dst, bounds).astype(np.int32),
        tsrc=np.concatenate([dst[torder], np.zeros(pad, np.int32)]),
        tdst=np.concatenate([tdst, np.full(pad, n, np.int32)]),
        tweight=np.concatenate([w[torder], np.zeros(pad, np.float32)]),
        tstarts=np.searchsorted(tdst, bounds).astype(np.int32))
    x = rng.standard_normal((n, f)).astype(np.float32)
    return plan, x, n


@pytest.mark.parametrize("weighted, bf16, dense", [
    *(pytest.param(*c.values, False, id=c.id) for c in _cases(
        [(False,), (True,)], [(False,), (True,)])),
    pytest.param(False, True, True, id="dense-bf16")])
def test_block_spmm_fwd_and_vjp_match_jax(weighted, bf16, dense):
    """Against JAX's ``block_spmm`` in interpret mode (forward, and its VJP:
    the same kernel on the transposed plan, ``d_w`` a per-edge dot), on 5
    blocks with an out-of-block edge that both drop; the plain version
    agrees, and ``spmm_sorted_coo`` with the plan routes to it. In bf16
    (float32 weights): forward, ``d_x`` and the kept edges' ``d_w``; and,
    unweighted, with a fully dense block and a pair repeated 300 times (the
    card's tensor-core product splits that count)."""
    rng = np.random.default_rng(1)
    plan, x, n = _block_plan(rng, 5, 16, dense)
    g = rng.standard_normal(x.shape).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in plan.items()}
    if bf16:
        _block_spmm_bf16(plan, j, x, g, n, weighted)
        return

    def jax_f(xx, ww):
        return jax_block_spmm(
            xx, j["src"], j["dst"], ww if weighted else None, j["estarts"],
            j["tsrc"], j["tdst"], j["tweight"] if weighted else None,
            j["tstarts"], n, interpret=True)

    want, vjp = jax.vjp(jax_f, jnp.asarray(x), j["weight"])
    want_dx, want_dw = vjp(jnp.asarray(g))
    p = {k: t(v) for k, v in plan.items()}
    xt = t(x).requires_grad_()
    wt = p["weight"].clone().requires_grad_()
    got = ops.block_spmm(xt, p["src"], p["dst"], wt if weighted else None,
                         p["estarts"], p["tsrc"], p["tdst"],
                         p["tweight"] if weighted else None, p["tstarts"], n)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    inputs = [xt, wt] if weighted else [xt]
    got_d = torch.autograd.grad(got, inputs, t(g))
    np.testing.assert_allclose(got_d[0].numpy(), np.asarray(want_dx),
                               **GRAD_TOL)
    keep = ~((p["src"] == 5) & (p["dst"] == 4 * 128 + 7))
    if weighted:
        # ROADMAP F3: JAX's VJP gives the dropped edge a weight gradient
        # (its dot); the port's is the forward's derivative there, 0
        k = keep.numpy()
        np.testing.assert_allclose(got_d[1].numpy()[k],
                                   np.asarray(want_dw)[k], **GRAD_TOL)
        assert got_d[1].numpy()[~k] == 0.0 != np.asarray(want_dw)[~k]
    # the out-of-block edge adds nothing: drop it and nothing changes
    dropped = ops.block_spmm_plain(
        t(x), p["src"][keep], p["dst"][keep],
        p["weight"][keep] if weighted else None, num_nodes=n)
    np.testing.assert_allclose(got.detach().numpy(), dropped.numpy(), **TOL)
    routed = ops.spmm_sorted_coo(
        t(x), p["src"], p["dst"], p["weight"] if weighted else None, n,
        block_plan=(p["estarts"], p["tsrc"], p["tdst"], p["tweight"],
                    p["tstarts"]))
    np.testing.assert_allclose(routed.numpy(), got.detach().numpy(), **TOL)


def _block_spmm_bf16(plan, j, x, g, n, weighted):
    def jax_f(xx, ww):
        return jax_block_spmm(
            xx, j["src"], j["dst"], ww if weighted else None, j["estarts"],
            j["tsrc"], j["tdst"], j["tweight"] if weighted else None,
            j["tstarts"], n, interpret=True)

    want, vjp = jax.vjp(jax_f, jnp.asarray(x, jnp.bfloat16), j["weight"])
    want_dx, want_dw = vjp(jnp.asarray(g, jnp.bfloat16))
    p = {k: t(v) for k, v in plan.items()}
    xt = t(x).to(torch.bfloat16).requires_grad_()
    wt = p["weight"].clone().requires_grad_()
    got = ops.block_spmm(xt, p["src"], p["dst"], wt if weighted else None,
                         p["estarts"], p["tsrc"], p["tdst"],
                         p["tweight"] if weighted else None, p["tstarts"], n)
    inputs = [xt, wt] if weighted else [xt]
    got_d = torch.autograd.grad(got, inputs, t(g).to(torch.bfloat16))
    assert got.dtype == got_d[0].dtype == torch.bfloat16
    _bf16_close(got, want.astype(jnp.float32))
    _bf16_close(got_d[0], want_dx.astype(jnp.float32), "d_x")
    if weighted:  # ROADMAP F3: the out-of-block edge's d_w differs
        keep = (~((p["src"] == 5) & (p["dst"] == 4 * 128 + 7))).numpy()
        assert got_d[1].dtype == torch.float32
        _bf16_close(got_d[1][keep], np.asarray(want_dw)[keep], "d_w")


# ---------------------------------------------------------------------------
# segment_max (row 5)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["sorted_1d", "sorted_2d", "holes_2d",
                                  "sorted_2d-bf16", "holes_2d-bf16"])
def test_segment_max_fwd_and_vjp_match_jax(case):
    """Ties (values on a coarse grid), empty segments, and padding ids:
    against JAX's ``xla`` path, and on sorted ids also its Pallas kernel in
    interpret mode (``segment_max_pallas_vjp``). In bf16 the max, in the
    data's type, is exactly JAX's; its gradient (the cotangent shared among
    ties, divided in float32 where JAX divides in bf16) within the bf16
    tolerance."""
    rng = np.random.default_rng(2)
    s = 40
    if case.startswith("holes"):
        ids = _hole_ids(rng, s)
    else:
        ids = np.sort(rng.integers(0, s - 1, 400))
        ids = np.concatenate([ids[(ids != 3) & (ids != 7)],
                              np.full(30, s)]).astype(np.int32)
    shape = (len(ids),) if case.endswith("1d") else (len(ids), 6)
    x = (rng.integers(-4, 5, shape) / 2).astype(np.float32)  # many ties
    g = rng.standard_normal(shape[:1] and (s,) + shape[1:]).astype(
        np.float32)
    if case.endswith("bf16"):  # x's grid is exact in bf16; g is rounded
        x = x + (rng.random(shape) < 0.3) / 128  # values that need bf16's bits
        dt = (jnp.bfloat16, torch.bfloat16)
    else:
        dt = (jnp.float32, torch.float32)
    xt = t(x).to(dt[1]).requires_grad_()
    got = ops.segment_max(xt, t(ids), s)
    (got_d,) = torch.autograd.grad(got, xt, t(g).to(dt[1]))
    assert got.dtype == got_d.dtype == dt[1]
    backends = ["xla"] if case.startswith("holes") else ["xla",
                                                         "pallas_interpret"]
    for backend in backends:
        want, vjp = jax.vjp(lambda d: jax_ops.segment_max(
            d, jnp.asarray(ids), s, backend=backend), jnp.asarray(x, dt[0]))
        (want_d,) = vjp(jnp.asarray(g, dt[0]))
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want, np.float32),
                                      err_msg=backend)
        if dt[1] == torch.bfloat16:
            _bf16_close(got_d, np.asarray(want_d, np.float32), "d_x")
        else:
            np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                       **GRAD_TOL, err_msg=backend)
    empty = [5] if case.startswith("holes") else [3, 7, s - 1]
    assert np.all(got.detach().float().numpy()[empty] == 0.0)
    # the plain version's autograd splits ties as the composed VJP does
    xp = t(x).to(dt[1]).requires_grad_()
    (plain_d,) = torch.autograd.grad(
        ops.segment_max_plain(xp, t(ids), s), xp, t(g).to(dt[1]))
    np.testing.assert_allclose(plain_d.float().numpy(),
                               got_d.float().numpy(), **GRAD_TOL)


def test_segment_max_hole_interleaved_ids():
    """ROADMAP F2: JAX's ``segment_max_pallas`` finds each 128-segment
    block's rows by a ``searchsorted`` over the ids, which holds only for
    sorted ids; on hole-interleaved ids its chunks over-read the gaps at the
    default ``block_edges`` and miss rows at a small one. The port's
    segment max is right for any ids (bounds by integer atomics on the
    card): it equals the ``xla`` path, which allows for unsorted ids."""
    rng = np.random.default_rng(3)
    s = 300
    ids = _hole_ids(rng, s, max_run=40, max_hole=200)
    x = rng.standard_normal((len(ids), 4)).astype(np.float32)
    want = np.asarray(jax_ops.segment_max(jnp.asarray(x), jnp.asarray(ids), s,
                                          backend="xla"))
    np.testing.assert_array_equal(ops.segment_max(t(x), t(ids), s).numpy(),
                                  want)
    probe = np.asarray(segment_max_pallas(jnp.asarray(x), jnp.asarray(ids), s,
                                          block_edges=128, interpret=True))
    assert np.any(probe != want)  # the reference's kernel misses rows here


# ---------------------------------------------------------------------------
# readouts and the attention readout's weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["mean", "mean_counted", "max",
                                  "attention:8", "mean-bf16"])
def test_readout_matches_jax(spec):
    """Forward and the gradients of the input and of the attention
    readout's parameters, on hole-interleaved ids; ``mean`` divides by the
    batch's ``graph_n_nodes``, ``mean_counted`` counts the rows. On bf16
    rows ``mean`` divides by the float32 counts and returns float32, as
    JAX's division promotes it (ROADMAP F4)."""
    rng = np.random.default_rng(4)
    g_n = 30
    ids = _hole_ids(rng, g_n)
    x = rng.standard_normal((len(ids), 16)).astype(np.float32)
    counts = np.bincount(ids, minlength=g_n + 1)[:g_n].astype(np.float32)
    bf16 = spec.endswith("bf16")
    spec = spec.replace("-bf16", "")
    if bf16:
        _mean_bf16(x, ids, counts, g_n, rng)
        return
    n_nodes = counts if spec == "mean" else None
    kind = spec.replace("_counted", "")
    jro = jax_readout.parse_readout(kind, 16)
    params = jro.init(jax.random.key(5))
    w = rng.standard_normal((g_n, 16)).astype(np.float32)

    def jax_loss(p, xx):
        with jax_ops.backend_scope("xla"):
            out = jro.apply(p, xx, jnp.asarray(ids), g_n,
                            None if n_nodes is None else jnp.asarray(n_nodes))
        return jnp.sum(out * w), out

    (_, want), (want_p, want_x) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    ro = parse_readout(kind, 16)
    state = {k[len("readout."):]: v for k, v in bridge.params_from_jax(
        {"readout": jax.tree.map(np.asarray, params)}).items()}
    ro.load_state_dict(state, strict=True)
    xt = t(x).requires_grad_()
    got = ro(xt, t(ids), g_n, None if n_nodes is None else t(n_nodes))
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    _grads_close([xt.grad], [want_x])
    want_state = bridge.params_from_jax(
        {"readout": jax.tree.map(np.asarray, want_p)})
    for name, p in ro.named_parameters():
        _grads_close([p.grad], [want_state[f"readout.{name}"]], [name])


def _mean_bf16(x, ids, counts, g_n, rng):
    w = rng.standard_normal((g_n, 16)).astype(np.float32)

    def jax_loss(xx):
        with jax_ops.backend_scope("xla"):
            out = jax_readout.parse_readout("mean", 16).apply(
                {}, xx, jnp.asarray(ids), g_n, jnp.asarray(counts))
        return jnp.sum(out * w), out

    (_, want), want_x = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.float32
    xt = t(x).to(torch.bfloat16).requires_grad_()
    got = parse_readout("mean", 16)(xt, t(ids), g_n, t(counts))
    assert got.dtype == torch.float32
    (got * t(w)).sum().backward()
    _bf16_close(got, want)
    assert xt.grad.dtype == torch.bfloat16
    _bf16_close(xt.grad, want_x.astype(jnp.float32), "d_x")


def test_attention_readout_weights_cross_from_jax():
    """``BiGNN.init_params`` with ``readout="attention"`` is the JAX init,
    bit for bit (the readout gets its key), and a JAX tree loads strictly
    through ``bridge``: the gate MLP under ``readout.gate.layers.j``, the
    projection transposed into ``readout.proj.weight``."""
    jcfg = dataclasses.replace(
        JaxBiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2),
        readout="attention:8")
    tree = jax.tree.map(np.asarray, JaxBiGNN(jcfg).init(jax.random.key(3)))
    model = BiGNN(_port_config(jcfg), seed=3)
    state = bridge.params_from_jax(tree)
    assert set(state) == set(model.state_dict())
    for name, v in model.state_dict().items():
        assert torch.equal(state[name], v), name
    np.testing.assert_array_equal(state["readout.proj.weight"].numpy(),
                                  tree["readout"]["proj"].T)
    bridge.load_jax_params(BiGNN(_port_config(jcfg)), tree)


# ---------------------------------------------------------------------------
# BiGNN on molecules over 128 atoms; upload_buckets above the threshold
# ---------------------------------------------------------------------------


def _port_config(cfg):
    return BiGNNConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(BiGNNConfig)})


def _big_molecules(rng, sizes, feat=8, scale=0.02):
    """Connected molecules of the given sizes: a random tree plus a few
    ring bonds, both directions of every bond; features of ``scale`` (the
    sum readout of 130-odd atoms then stays near unit scale, where the
    outer GAT's softmax is not saturated)."""
    out = []
    for n in sizes:
        child = np.arange(1, n)
        parent = np.array([rng.integers(0, c) for c in child])
        extra = rng.integers(0, n, (n // 10, 2))
        a = np.concatenate([child, extra[:, 0]])
        b = np.concatenate([parent, extra[:, 1]])
        keep = a != b
        src = np.concatenate([a[keep], b[keep]]).astype(np.int64)
        dst = np.concatenate([b[keep], a[keep]]).astype(np.int64)
        out.append(((scale * rng.standard_normal((n, feat))).astype(
            np.float32), src, dst))
    return out


MODELS = {
    "gin_gat": dict(inner_layers=("gin:16", "gin:16"),
                    outer_layers=("gat:16:2",), scorer="mlp:16"),
    "gcn": dict(inner_layers=("gcn:16", "gcn:16"),
                outer_layers=("gcn:16:identity",), scorer="dot"),
    "max": dict(inner_layers=("gin:16", "gin:16"), readout="max",
                outer_layers=("gat:16:2",), scorer="mlp:16"),
    "gin_gat-bf16": dict(inner_layers=("gin:16", "gin:16"),
                         outer_layers=("gat:16:2",), scorer="mlp:16",
                         dtype="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bignn_streaming_bucket_matches_jax(name):
    """Three molecules of 130-140 atoms: their bucket is not block-local, so
    every inner conv takes the sorted-COO branch. Logits and every
    parameter's gradient equal JAX's ``xla`` path. The outer graph has no
    dense masks, so the outer convs take their edge lists too (GCN's the
    weighted sorted-COO SpMM)."""
    rng = np.random.default_rng(6)
    mols = _big_molecules(rng, (131, 140, 136))
    graphs = [COOGraph(*m) for m in mols]
    jgraphs = [JaxCOOGraph(*m) for m in mols]
    bucketing, jbucketing = bucket_graphs(graphs), jax_bucket_graphs(jgraphs)
    assert all(b.block_estarts is None for b in bucketing.batches)
    ends = np.array([[0, 1], [1, 2]])
    outer = build_outer_graph(ends[:, 0], ends[:, 1], 3, dense_max_nodes=0)
    jouter = jax_build_outer_graph(ends[:, 0], ends[:, 1], 3,
                                   dense_max_nodes=0)
    pairs = np.array([[0, 1], [1, 2], [0, 2], [2, 2]], np.int32)
    w = np.array([0.5, -1.0, 2.0, 1.5], np.float32)
    jcfg = JaxBiGNNConfig(feat_dim=8, **MODELS[name])
    jmodel = JaxBiGNN(jcfg)
    params = jmodel.init(jax.random.key(2))

    def jax_loss(p):
        with jax_ops.backend_scope("xla"):
            logits = jmodel.apply(
                p, [jax.tree.map(jnp.asarray, b) for b in jbucketing.batches],
                jbucketing.graph_index, jax.tree.map(jnp.asarray, jouter),
                jnp.asarray(pairs))
        return jnp.sum(logits * w), logits

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    model = BiGNN(_port_config(jcfg))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    buckets, index = upload_buckets(bucketing, jcfg.inner_layers, "cpu")
    got = model(buckets, index, outer.to("cpu"), t(pairs))
    (got * t(w)).sum().backward()
    want_g = bridge.params_from_jax(jax.tree.map(np.asarray, want_g))
    if name.endswith("bf16"):  # bf16 compute over float32 parameters
        # logits near 6, where a bf16 step is 2**-5: the two packages round
        # at other places through five layers, two steps apart at most
        _bf16_close(got, np.asarray(want, np.float32), tol=2e-2)
        for pname, p in model.named_parameters():
            assert p.grad.dtype == torch.float32
            assert bool(torch.isfinite(p.grad).all()), pname
            # the destination half of GAT's score shifts all of a
            # drug's incoming edges alike, so its gradient cancels (5e-6
            # in float32) and what is left in bf16 is rounding noise
            if pname != "outer.0.a_l":
                _bf16_close(p.grad, want_g[pname], pname)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    for pname, p in model.named_parameters():
        _grads_close([p.grad], [want_g[pname]], [pname])


def test_upload_buckets_above_threshold_keep_the_block_plan(monkeypatch):
    """A block-local bucket above ``BLOCK_DENSE_MAX_NODES`` rows goes up
    without dense blocks (as ``build_padded_batch`` builds none), and its
    GIN and GCN layers take ``block_spmm`` with the same result as the
    dense blocks give below the threshold."""
    rng = np.random.default_rng(7)
    mols = _big_molecules(rng, rng.integers(20, 60, 24))
    graphs = [COOGraph(*m) for m in mols]
    cfg = BiGNNConfig(feat_dim=8, inner_layers=("gin:16", "gcn:16"))
    model = BiGNN(cfg, seed=1)
    dense, _ = upload_buckets(bucket_graphs(graphs), cfg.inner_layers, "cpu")
    monkeypatch.setattr(formats_mod, "BLOCK_DENSE_MAX_NODES", 0)
    plan, _ = upload_buckets(bucket_graphs(graphs), cfg.inner_layers, "cpu")
    for d, p in zip(dense, plan):
        assert d.block_cnt is not None and d.block_adj is not None
        assert p.block_cnt is None and p.block_adj is None
        assert p.block_estarts is not None and p.edge_tsrc is not None
        np.testing.assert_allclose(model.encode_inner(p).detach().numpy(),
                                   model.encode_inner(d).detach().numpy(),
                                   **MODEL_TOL)


# ---------------------------------------------------------------------------
# MinibatchTrainer on a layout that is not block-local
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def large():
    ds = load_dataset("synthetic-large", **LARGE)
    jds = jax_load_dataset("synthetic-large", **LARGE)
    assert max(m.num_nodes for m in ds.molecules) > 128
    return ds, jds


def _cfg():
    return JaxBiGNNConfig.full_bignn(feat_dim=32, dim=16, heads=2)


@pytest.fixture(scope="module")
def jax_trainer(large):
    """JAX's trainer with resident tables; its ``_loss`` also takes a whole
    host batch (``trainer.py:640-654``), as with ``resident=False``."""
    return JaxMinibatchTrainer(JaxBiGNN(_cfg()), large[1],
                               JaxTrainConfig(lr=1e-3, batch_size=16),
                               **SAMPLER_KW)


def _trainer(large, resident):
    tr = MinibatchTrainer(BiGNN(_port_config(_cfg())), large[0],
                          TrainConfig(lr=1e-3, batch_size=16),
                          resident=resident, device="cpu", **SAMPLER_KW)
    assert not tr.sampler.block_local and not tr.sampler.quantized
    return tr


def test_expand_compact_not_block_local_equals_jax(large, jax_trainer):
    """Molecules packed one after another, the source-sort arrays from the
    tables' packed columns 3-4, no block fields: array for array JAX's."""
    jtr, tr = jax_trainer, _trainer(large, True)
    cb = tr.sampler.sample_compact_at(0, 2)
    pb = tr._expand_compact(cb.to("cpu"), tr.tables)
    jpb = jax.jit(lambda c, tb: JaxMinibatchTrainer._expand_compact(
        jtr, c, tb))(
        jax.tree.map(jnp.asarray, jtr.sampler.sample_compact_at(0, 2)),
        jtr.tables)
    for name in ("node_feat", "node_mask", "edge_src", "edge_dst",
                 "edge_weight", "graph_ids", "graph_n_nodes",
                 "edge_src_perm", "edge_src_sorted"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                      np.asarray(getattr(jpb, name)),
                                      err_msg=name)
    for name in ("block_estarts", "edge_tsrc", "block_adj", "block_cnt"):
        assert getattr(pb, name) is None and getattr(jpb, name) is None
    real = pb.edge_dst.numpy() < pb.node_cap
    perm = pb.edge_src_perm.numpy()
    assert sorted(perm) == list(range(pb.edge_cap))  # a permutation
    np.testing.assert_array_equal(pb.edge_src.numpy()[perm][real[perm]],
                                  pb.edge_src_sorted.numpy()[real[perm]])


@pytest.mark.parametrize("resident", [False, True])
def test_streaming_minibatch_step_matches_jax(large, jax_trainer, resident):
    """One step's loss and gradients on the same host-drawn batch: with
    ``resident=False`` a whole ``HierarchicalBatch`` uploaded (no block
    fields), with resident tables the non-block-local expansion."""
    jtr, tr = jax_trainer, _trainer(large, resident)
    params = jtr.model.init(jax.random.key(1))
    if resident:
        hb = tr.sampler.sample_compact_at(0, 1)
        jhb = jtr.sampler.sample_compact_at(0, 1)
    else:
        hb, jhb = tr.sampler.sample_at(0, 1), jtr.sampler.sample_at(0, 1)
    with jax_ops.backend_scope("xla"):
        loss, grads = jax.jit(jax.value_and_grad(jtr._loss))(
            params, jax.tree.map(jnp.asarray, jhb), jtr.tables)
    tr.model.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params)))
    got = tr.train_step(hb)
    np.testing.assert_allclose(got.item(), float(loss), **MODEL_TOL)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in tr.model.named_parameters():
        _grads_close([p.grad], [want[name]], [name])
    if not resident:
        assert tr.tables is None and tr.resident_bytes() == {}
