"""The port's ops against the JAX package on the same NumPy inputs.

On the CPU each op runs its plain PyTorch version; the JAX side runs as its
own tests run it (the ``xla`` backend, and the Pallas kernels in interpret
mode where their contract holds). Tolerances: rtol = atol = 1e-5 in f32,
because sums run in another order; counts are exact. The card's kernels are
held against these plain versions in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bignn_tpu import ops as jax_ops
from bignn_tpu.ops.gather import permutation_scatter_rows as jax_perm_scatter
from bignn_tpu.ops.pallas.block_adj import build_block_adj, build_block_adj_xla
from bignn_tpu.ops.pallas.flash_gat import NEG as JAX_NEG
from bignn_tpu.ops.pallas.flash_gat import _flash_fwd
from bignn_tpu.ops.pallas.flash_gat import flash_gat_attention as jax_flash_gat

from bignn_tpu_torch import ops
from bignn_tpu_torch.data import make_synthetic_ddi
from bignn_tpu_torch.ops.flash_gat import NEG
from bignn_tpu_torch.sparse import build_padded_batch

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# segment_sum
# ---------------------------------------------------------------------------


def _sorted_ids(rng, num_segments, num_rows):
    """Sorted ids with empty segments and trailing padding ids."""
    ids = np.sort(rng.integers(0, num_segments, num_rows - 40))
    ids = ids[(ids != 3) & (ids != 7)]  # segments 3 and 7 stay empty
    return np.concatenate(
        [ids, np.full(num_rows - len(ids), num_segments)]).astype(np.int32)


def _hole_ids(rng, num_segments):
    """The block-local readout's pattern (ROADMAP F1): valid runs in order,
    with runs of the padding id num_segments between them."""
    parts = []
    for s in range(num_segments):
        parts.append(np.full(rng.integers(1, 6), s))
        if rng.random() < 0.5:
            parts.append(np.full(rng.integers(1, 40), num_segments))
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_segment_sum_sorted_ids(backend):
    rng = np.random.default_rng(0)
    ids = _sorted_ids(rng, 50, 1024)
    data = rng.standard_normal((1024, 24)).astype(np.float32)
    want = jax_ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), 50,
                               backend=backend)
    got = ops.segment_sum(t(data), t(ids), 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[[3, 7]] == 0.0)


@pytest.mark.parametrize("layout", ["hole_runs", "block_local_batch"])
def test_segment_sum_hole_interleaved_ids(layout):
    """F1 guard: ids sorted only among the valid rows, padding ids between
    them, against JAX's xla segment_sum (which takes unsorted ids)."""
    rng = np.random.default_rng(1)
    if layout == "hole_runs":
        ids = _hole_ids(rng, 300)
        num_segments = 300
    else:
        ds = make_synthetic_ddi(num_drugs=60, feat_dim=4, min_atoms=6,
                                max_atoms=40, seed=1)
        n = sum(m.num_nodes for m in ds.molecules)
        e = sum(m.num_edges for m in ds.molecules) + n
        batch = build_padded_batch(ds.molecules, 128 * 32, e + 128,
                                   block_local=True)
        ids, num_segments = batch.graph_ids, batch.num_graphs
    valid = ids < num_segments
    assert not np.all(np.diff(ids) >= 0)  # unsorted overall
    assert np.all(np.diff(ids[valid]) >= 0)  # sorted among the valid rows
    data = rng.standard_normal((len(ids), 16)).astype(np.float32)
    want = jax_ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                               num_segments, backend="xla")
    got = ops.segment_sum(t(data), t(ids), num_segments)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_sum_vector_and_out_of_range():
    data = np.arange(6, dtype=np.float32)
    ids = np.array([0, 0, 2, -1, 5, 2], np.int32)  # -1 and 5 are dropped
    got = ops.segment_sum(t(data), t(ids), 3)
    np.testing.assert_array_equal(got.numpy(), [1.0, 0.0, 7.0])


# ---------------------------------------------------------------------------
# block_adjacency / block_diag_spmm
# ---------------------------------------------------------------------------


def _block_local_edges(rng, nblk, max_deg=4):
    """Block-local dst-sorted edges with duplicates and padding edges."""
    src, dst = [], []
    for b in range(nblk):
        n_e = rng.integers(10, 128 * max_deg)
        lo = b * 128
        src.append(rng.integers(lo, lo + 128, n_e))
        dst.append(np.sort(rng.integers(lo, lo + 128, n_e)))
    src = np.concatenate(src).astype(np.int32)
    dst = np.concatenate(dst).astype(np.int32)
    src[1], dst[1] = src[0], dst[0]  # a duplicate edge: multiplicity 2
    n = nblk * 128
    pad = (-len(src)) % 128 + 256
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.full(pad, n, np.int32)])
    estarts = np.searchsorted(dst, np.arange(0, n + 1, 128)).astype(np.int32)
    return src, dst, estarts, n


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_block_adjacency_matches_jax(weighted, reference):
    rng = np.random.default_rng(2)
    src, dst, estarts, n = _block_local_edges(rng, nblk=3)
    w = (np.where(dst < n, rng.random(len(src)), 0.0).astype(np.float32)
         if weighted else None)
    jw = None if w is None else jnp.asarray(w)
    if reference == "xla":
        want = build_block_adj_xla(jnp.asarray(src), jnp.asarray(dst), jw, n)
    else:
        want = build_block_adj(jnp.asarray(src), jnp.asarray(dst), jw,
                               jnp.asarray(estarts), n, jnp.float32,
                               interpret=True)
    got = ops.block_adjacency(t(src), t(dst), None if w is None else t(w),
                              t(estarts), n)
    if weighted:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().max() >= 2  # the duplicate edge


def test_block_adjacency_matches_host_blocks():
    """The on-device build equals the host np.add.at blocks of a real
    block-local batch (empty padding rows and blocks included)."""
    ds = make_synthetic_ddi(num_drugs=30, feat_dim=4, seed=5)
    n = sum(m.num_nodes for m in ds.molecules)
    e = sum(m.num_edges for m in ds.molecules) + n
    batch = build_padded_batch(ds.molecules, 128 * 8, e + 200,
                               block_local=True)
    args = (t(batch.edge_src), t(batch.edge_dst))
    cnt = ops.block_adjacency(*args, None, t(batch.block_estarts),
                              batch.node_cap)
    adj = ops.block_adjacency(*args, t(batch.edge_weight),
                              t(batch.block_estarts), batch.node_cap)
    np.testing.assert_array_equal(cnt.numpy(), batch.block_cnt)
    np.testing.assert_allclose(adj.numpy(), batch.block_adj, **TOL)
    assert np.all(cnt.numpy()[-1] == 0.0)  # an all-padding block


def test_block_diag_spmm_matches_jax():
    rng = np.random.default_rng(3)
    adj = rng.random((3, 128, 128)).astype(np.float32)
    x = rng.standard_normal((384, 12)).astype(np.float32)
    want = jax_ops.block_diag_spmm(jnp.asarray(adj), jnp.asarray(x))
    got = ops.block_diag_spmm(t(adj), t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# flash_gat_attention (forward)
# ---------------------------------------------------------------------------

N, H, D = 72, 2, 8
SLOPE = 0.2


@pytest.fixture(scope="module")
def gat_inputs():
    rng = np.random.default_rng(4)
    score_l = rng.standard_normal((N, H)).astype(np.float32)
    score_r = rng.standard_normal((N, H)).astype(np.float32)
    v = rng.standard_normal((N, H, D)).astype(np.float32)
    cnt = (rng.random((N, N)) < 0.1).astype(np.float32)
    cnt += rng.random((N, N)) < 0.02  # some multiplicity-2 edges
    cnt[17] = 0.0  # a row with no incoming edges
    cnt[60:] = 0.0  # a tail of empty rows, as padding gives
    return score_l, score_r, v, cnt


def test_flash_gat_matches_jax(gat_inputs):
    got, lse = ops.flash_gat_attention(*map(t, gat_inputs), SLOPE)
    want = jax_flash_gat(*map(jnp.asarray, gat_inputs), SLOPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[[17, 65]] == 0.0)
    assert NEG == JAX_NEG and np.all(lse.numpy()[[17, 65]] == NEG)


def test_flash_gat_matches_pallas_forward(gat_inputs):
    """Out and lse against the Pallas forward kernel in interpret mode."""
    want, want_lse = _flash_fwd(*map(jnp.asarray, gat_inputs), slope=SLOPE,
                                interpret=True)
    got, lse = ops.flash_gat_attention(*map(t, gat_inputs), SLOPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------


def test_gathers_match_jax():
    rng = np.random.default_rng(6)
    table = rng.standard_normal((10, 3)).astype(np.float32)
    idx = np.array([0, 9, 12, -3, 4], np.int32)  # out of range -> clipped
    np.testing.assert_array_equal(
        ops.gather_rows(t(table), t(idx)).numpy(),
        np.asarray(jax_ops.gather_rows(jnp.asarray(table), jnp.asarray(idx))))
    perm = rng.permutation(10).astype(np.int32)
    np.testing.assert_array_equal(
        ops.permutation_scatter_rows(t(table), t(perm)).numpy(),
        np.asarray(jax_perm_scatter(jnp.asarray(table), jnp.asarray(perm))))
