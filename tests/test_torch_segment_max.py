"""The segment max's VJP (Queue 2 row 5's backward) against the JAX
package on the same NumPy inputs.

On the CPU ``ops.segment_max``'s autograd backward takes the plain version,
``segment_max_bwd_plain``: the composed rule of JAX's
``_segment_max_diff_bwd`` (``bignn_tpu/ops/pallas/segment.py:499-512``),
which the card's one-launch kernel (``csrc/segment_max.cu``) is held to bit
for bit in ``tests/test_torch_kernels.py``. Here it is held against JAX's
VJP of the ``xla`` path (rtol = atol = 1e-4, bf16 within 1e-1 x max |g|
and a cosine of 0.99, as ``tests/test_torch_streaming.py``), on any ids,
and against JAX's composed rule itself, called on the port's stored max,
exactly (it sums its tie counts with ``segment_sum_pallas`` in interpret
mode, which is right only for sorted ids: ROADMAP F1). Where the two JAX
rules part (a segment whose max is NaN or +-inf is stored as 0; its rows
equal to 0 share the cotangent under the composed rule and get none under
``xla``'s), the port holds the composed rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vjp

from bignn_tpu import ops as jax_ops
from bignn_tpu.ops.pallas.segment import _segment_max_diff_bwd

from bignn_tpu_torch import ops

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
S = 40


def _hole_ids(rng, num_segments):
    """Valid id runs in order with padding-id runs between them (the
    block-local readout layout, ROADMAP F1/F2), segment 5 empty."""
    parts = []
    for s in range(num_segments):
        if s != 5:
            parts.append(np.full(rng.integers(1, 6), s))
        if rng.random() < 0.5:
            parts.append(np.full(rng.integers(1, 40), num_segments))
    return np.concatenate(parts).astype(np.int32)


def _sorted_ids(rng, empty=(3, 7, S - 1)):
    """Sorted valid ids with the segments ``empty`` left out, then a run of
    padding ids."""
    ids = np.sort(rng.integers(0, S, 400))
    ids = ids[~np.isin(ids, empty)]
    return np.concatenate([ids, np.full(30, S)]).astype(np.int32)


def _case(case: str):
    """(x, ids, g, whether the ids are sorted) of a case: values on a coarse
    grid, so that segments hold ties."""
    rng = np.random.default_rng(7)
    feat = 6
    ids = _sorted_ids(rng)
    is_sorted = True
    if case == "holes":
        ids, is_sorted = _hole_ids(rng, S), False
    elif case == "shuffled":
        ids, is_sorted = rng.permutation(ids), False
    elif case == "dropped":  # ids past S and negative ones among the rows
        ids = ids.copy()
        pick = rng.random(len(ids)) < 0.2
        ids[pick] = rng.choice([-1, S, S + 5], int(pick.sum()))
        is_sorted = False
    elif case == "empty":  # most segments empty
        ids = _sorted_ids(rng, empty=np.arange(1, S, 2))
    x = (rng.integers(-4, 5, (len(ids), feat)) / 2).astype(np.float32)
    if case == "1d":
        x = x[:, 0].copy()
    elif case == "bf16":  # values that need bf16's bits; the grid is exact
        x = x + (rng.random(x.shape) < 0.3) / 128
    elif case == "signed_zero":  # segments whose max is a -0.0 / 0.0 tie
        for s in (0, 1, 2):
            rows = np.flatnonzero(ids == s)
            x[rows] = -1.0
            x[rows[0]] = -0.0
            x[rows[-1]] = 0.0
    elif case == "nonfinite":  # maxima NaN, +inf, -inf; 0s among their rows
        for s, v in ((0, np.nan), (1, np.inf), (2, -np.inf), (4, np.nan)):
            rows = np.flatnonzero(ids == s)
            x[rows] = -np.inf if v == -np.inf else -1.0
            x[rows[0], :3] = v
            x[rows[-1]] = 0.0 if s != 2 else -np.inf
    g = rng.standard_normal((S,) + x.shape[1:]).astype(np.float32)
    return x, ids, g, is_sorted


CASES = ["ties", "holes", "shuffled", "dropped", "empty", "1d", "bf16",
         "signed_zero", "nonfinite"]


@pytest.mark.parametrize("case", CASES)
def test_segment_max_vjp_matches_jax(case):
    x, ids, g, is_sorted = _case(case)
    dt = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else (
        jnp.float32, torch.float32)
    xt = torch.from_numpy(x).to(dt[1]).requires_grad_()
    ids_t, g_t = torch.from_numpy(ids), torch.from_numpy(g).to(dt[1])
    before = ops.segment_max_bwd.launches
    out = ops.segment_max(xt, ids_t, S)
    (got,) = torch.autograd.grad(out, xt, g_t)
    out = out.detach()
    assert got.dtype == dt[1] and got.shape == xt.shape
    # the op's own call takes the same plain route; nothing launches here
    assert torch.equal(ops.segment_max_bwd(xt.detach(), ids_t, out, g_t, S),
                       got)
    assert ops.segment_max_bwd.launches == before
    dropped = (ids < 0) | (ids >= S)
    assert np.all(got.float().numpy()[dropped] == 0.0)
    xj, gj = jnp.asarray(x, dt[0]), jnp.asarray(g, dt[0])
    if is_sorted:
        # JAX's composed rule on the port's stored max, exactly (bf16: its
        # float32 result rounded once, as the port rounds)
        want, _ = _segment_max_diff_bwd(
            S, True, (xj, jnp.asarray(ids), jnp.asarray(out.float().numpy(),
                                                         dt[0])), gj)
        want = torch.tensor(np.asarray(want, np.float32)).to(dt[1])
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.float().numpy())
    if case == "nonfinite":
        # the stored max is 0; the rows equal to 0 share g, others get 0
        for s in (0, 1, 2, 4):
            rows = np.flatnonzero(ids == s)
            o = out.numpy()[s]
            assert np.all(o == 0.0)
            hit = x[rows] == 0.0
            share = g[s] / np.maximum(hit.sum(0), 1)
            np.testing.assert_array_equal(
                got.numpy()[rows], np.where(hit, share, 0.0))
        return
    _, jvp_fn = vjp(lambda d: jax_ops.segment_max(
        d, jnp.asarray(ids), S, backend="xla"), xj)
    (want,) = jvp_fn(gj)
    if case == "bf16":
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        assert np.abs(got - want).max() <= 1e-1 * np.abs(want).max()
        cos = (got * want).sum() / (np.linalg.norm(got)
                                    * np.linalg.norm(want))
        assert cos >= 0.99
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
