"""The plain arithmetic behind two card kernels, on the CPU:

- the flash-GAT forward (``csrc/flash_gat.cu``) takes each destination's
  row max from the masked max and min of ``score_r`` (``fl(sl + x)`` is
  monotone in ``x``, and LeakyReLU monotone or V-shaped, so the largest
  score is the LeakyReLU at one of the two ends); that must give the plain
  version's direct masked max (``flash_row_max_plain``) bit for bit, for
  any slope, rows with no edges included;
- the segment-softmax backward (``csrc/segment_softmax.cu``) on its edge
  layouts, no segment at all and segments of one or two rows, through its
  plain version against JAX's analytic VJP ``_segment_softmax_bwd``
  (``bignn_tpu/ops/pallas/segment.py:293-301``, its segment sum in
  interpret mode) and against the VJP of JAX's ``xla`` softmax (with the
  zero cotangent its padding rows get in use).

Tolerance for the backward: rtol = atol = 1e-4, as tests/test_torch_ops.py
holds gradients (sums of a segment's rows in another order); dropped rows
exactly +0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bignn_tpu import ops as jax_ops
from bignn_tpu.ops.pallas.segment import _segment_softmax_bwd

from bignn_tpu_torch import ops
from bignn_tpu_torch.ops.flash_gat import NEG, flash_row_max_plain

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many tiny tensor ops: one intra-op thread beside the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("slope", [0.2, 0.0, -0.1])
def test_flash_row_max_from_bounds_is_the_direct_max(slope):
    """Scores that cross 0 inside most rows (the LeakyReLU's kink), rows
    with no edges (NEG), multiplicities up to 3, and one row whose only
    edge is its self-loop: the two row maxima are equal value for value."""
    rng = np.random.default_rng(7)
    n, heads = 120, 3
    cnt = (rng.random((n, n)) < 0.08).astype(np.float32)
    cnt += (rng.random((n, n)) < 0.02) * 2
    cnt[[5, 40, 99]] = 0.0  # no edges
    cnt[17] = 0.0
    cnt[17, 17] = 1.0  # the self-loop alone
    sl, sr = (torch.from_numpy(rng.standard_normal((n, heads))
                               .astype(np.float32)) for _ in range(2))
    sr[::7] *= 40.0  # far from the kink: one side of it wins
    cnt = torch.from_numpy(cnt)
    e = F.leaky_relu(sl[:, None, :] + sr[None, :, :], slope)
    valid = (cnt > 0)[:, :, None]
    want = flash_row_max_plain(e, valid)
    # the kernel's arithmetic: the masked bounds of score_r, then the two
    # ends' LeakyReLU
    hi = torch.where(valid, sr[None], -torch.inf).amax(dim=1)
    lo = torch.where(valid, sr[None], torch.inf).amin(dim=1)
    got = torch.maximum(F.leaky_relu(sl + hi, slope),
                        F.leaky_relu(sl + lo, slope)).clamp_min(NEG)
    got = torch.where(valid.any(dim=1), got, NEG)
    assert torch.equal(got, want)
    assert bool((got[[5, 40, 99]] == NEG).all())
    assert bool((got[17] > NEG).all())
    # the max is attained: its row has an edge whose score is m exactly
    hit = ((e == got[:, None]) & valid).any(dim=1)
    assert bool(hit[cnt.sum(1) > 0].all())


def _short_ids(rng, num_segments):
    """Sorted ids, segments of 1 or 2 rows (the card walk's one row a
    lane) with one empty segment, and 10 padding rows (id num_segments)."""
    lengths = rng.integers(1, 3, num_segments)
    lengths[4] = 0
    ids = np.repeat(np.arange(num_segments), lengths)
    return np.concatenate([ids, np.full(10, num_segments)]).astype(np.int32)


@pytest.mark.parametrize("layout", ["short", "nosegments"])
def test_segment_softmax_bwd_plain_matches_jax(layout):
    """``short``: segments of 1-2 rows; ``nosegments``: every row's id is
    padding, so no segment holds a row (and with num_segments 0, which JAX
    does not take, the plain version alone)."""
    rng = np.random.default_rng(11)
    if layout == "short":
        n = 60
        ids = _short_ids(rng, n)
    else:
        n = 4
        ids = np.full(50, n, np.int32)
    e, heads = len(ids), 4
    x = (3 * rng.standard_normal((e, heads))).astype(np.float32)
    g = rng.standard_normal((e, heads)).astype(np.float32)
    ids_t, g_t = torch.from_numpy(ids), torch.from_numpy(g)
    alpha = ops.segment_softmax_plain(torch.from_numpy(x), ids_t, n)
    got = ops.segment_softmax_bwd_plain(alpha, g_t, ids_t, n).numpy()
    valid = ids < n
    assert np.all(got[~valid] == 0.0) and not np.signbit(got[~valid]).any()
    if layout == "nosegments":
        none = ops.segment_softmax_bwd_plain(alpha, g_t, ids_t, 0).numpy()
        assert np.all(none == 0.0) and not np.signbit(none).any()
    a = jnp.asarray(alpha.numpy())
    want, _ = _segment_softmax_bwd(n, True, (a, jnp.asarray(ids)),
                                   jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL)
    # the xla softmax leaves padding rows unspecified for downstream
    # reductions to drop, so their cotangent is 0 in its use; its VJP sends
    # theirs into the last segment (clipped ids), so it gets that 0 here
    _, vjp = jax.vjp(lambda s: jax_ops.segment_softmax(
        s, jnp.asarray(ids), n, backend="xla"), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(np.where(valid[:, None], g, 0.0)))
    np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL)
