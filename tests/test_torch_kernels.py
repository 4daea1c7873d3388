"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the device routing of their wrappers.

This file imports no JAX, so it also runs on the machine with the card,
which has none (``--noconftest`` skips tests/conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Without a card the ``gpu`` tests skip. Tolerance: rtol = atol = 1e-5 in
f32, since kernel and plain version sum in different orders; counts exact;
gradients rtol = atol = 1e-4 (sums over whole rows and columns), and a
whole step's gradients rtol 2e-4 / atol 2e-5 x max |g|, as the CPU tests
hold the port against JAX. bf16 forms: both sum in float32 and round once,
so they differ by at most one bf16 rounding of nearly equal sums (BF16_TOL,
rtol 1e-2 > 2**-7).
"""

import ctypes
import itertools
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

from bignn_tpu_torch import ops
from bignn_tpu_torch.ops import cuda_lib
from bignn_tpu_torch.ops.segment import (segment_bounds_plain,
                                         segment_sum_launch)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-5)


def _hole_ids(rng, num_segments):
    """Valid id runs in order with padding-id runs between them (the
    block-local readout layout, ROADMAP F1)."""
    parts = []
    for s in range(num_segments):
        parts.append(np.full(rng.integers(1, 6), s))
        if rng.random() < 0.5:
            parts.append(np.full(rng.integers(1, 40), num_segments))
    return np.concatenate(parts).astype(np.int32)


def _block_local_edges(rng, nblk):
    """Dst-sorted block-local edges, one duplicate, padding at the end;
    block 1 has no edges."""
    src, dst = [], []
    for b in range(nblk):
        n_e = 0 if b == 1 else int(rng.integers(10, 500))
        src.append(rng.integers(b * 128, (b + 1) * 128, n_e))
        dst.append(np.sort(rng.integers(b * 128, (b + 1) * 128, n_e)))
    src = np.concatenate(src).astype(np.int32)
    dst = np.concatenate(dst).astype(np.int32)
    src[1], dst[1] = src[0], dst[0]
    n = nblk * 128
    src = np.concatenate([src, np.zeros(100, np.int32)])
    dst = np.concatenate([dst, np.full(100, n, np.int32)])
    estarts = np.searchsorted(dst, np.arange(0, n + 1, 128)).astype(np.int32)
    return src, dst, estarts, n


def _gat_inputs(rng, n, heads, head_dim):
    cnt = (rng.random((n, n)) < 0.1).astype(np.float32)
    cnt += rng.random((n, n)) < 0.02  # multiplicity 2
    cnt[3] = 0.0  # a row with no edges
    return (rng.standard_normal((n, heads)).astype(np.float32),
            rng.standard_normal((n, heads)).astype(np.float32),
            rng.standard_normal((n, heads, head_dim)).astype(np.float32),
            cnt)


def _bwd_inputs(rng, n, heads, head_dim, device):
    """Backward inputs: the forward's inputs (with an empty tail of rows as
    well), its lse and out from the plain forward, and a cotangent g."""
    sl, sr, v, cnt = _gat_inputs(rng, n, heads, head_dim)
    cnt[(7 * n) // 10:] = 0.0
    g = rng.standard_normal((n, heads, head_dim)).astype(np.float32)
    sl, sr, v, cnt, g = _on(device, sl, sr, v, cnt, g)
    out, lse = ops.flash_gat_attention_plain(sl, sr, v, cnt)
    return sl, sr, v, cnt, lse, out, g


def _on(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where NaN (a +inf score gives NaN rows)."""
    try:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    except AssertionError:
        return False
    return True


def _cases(device):
    """name -> (kernel call, plain call) on small inputs on ``device``."""
    rng = np.random.default_rng(0)
    ids = _hole_ids(rng, 60)
    data, ids_t = _on(device, rng.standard_normal(
        (len(ids), 130)).astype(np.float32), ids)  # 130: two column sweeps
    vec = data[:, 0].contiguous()
    src, dst, est, n = _block_local_edges(rng, 3)
    w = np.where(dst < n, rng.random(len(src)), 0).astype(np.float32)
    src_t, dst_t, est_t, w_t = _on(device, src, dst, est, w)
    gat4 = _on(device, *_gat_inputs(rng, 75, 4, 32))
    gat8 = _on(device, *_gat_inputs(rng, 40, 8, 64))
    gat_small = _on(device, *_gat_inputs(rng, 9, 2, 3))
    bwd200 = _bwd_inputs(rng, 200, 4, 16, device)
    bwd8 = _bwd_inputs(rng, 40, 8, 64, device)
    bwd_small = _bwd_inputs(rng, 9, 2, 3, device)
    return {
        "segment_sum": (lambda: ops.segment_sum(data, ids_t, 60),
                        lambda: ops.segment_sum_plain(data, ids_t, 60)),
        "segment_sum_1d": (lambda: ops.segment_sum(vec, ids_t, 60),
                           lambda: ops.segment_sum_plain(vec, ids_t, 60)),
        "block_adjacency_count": (
            lambda: ops.block_adjacency(src_t, dst_t, None, est_t, n),
            lambda: ops.block_adjacency_plain(src_t, dst_t, None, n)),
        "block_adjacency_weighted": (
            lambda: ops.block_adjacency(src_t, dst_t, w_t, est_t, n),
            lambda: ops.block_adjacency_plain(src_t, dst_t, w_t, n)),
        "flash_gat_h4": (lambda: ops.flash_gat_attention(*gat4),
                         lambda: ops.flash_gat_attention_plain(*gat4)),
        "flash_gat_h8": (lambda: ops.flash_gat_attention(*gat8, 0.1),
                         lambda: ops.flash_gat_attention_plain(*gat8, 0.1)),
        "flash_gat_small": (lambda: ops.flash_gat_attention(*gat_small),
                            lambda: ops.flash_gat_attention_plain(*gat_small)),
        "flash_gat_bwd_n200": (
            lambda: ops.flash_gat_attention_bwd(*bwd200),
            lambda: ops.flash_gat_attention_bwd_plain(*bwd200)),
        "flash_gat_bwd_h8": (
            lambda: ops.flash_gat_attention_bwd(*bwd8, 0.1),
            lambda: ops.flash_gat_attention_bwd_plain(*bwd8, 0.1)),
        "flash_gat_bwd_small": (
            lambda: ops.flash_gat_attention_bwd(*bwd_small),
            lambda: ops.flash_gat_attention_bwd_plain(*bwd_small)),
    }


@pytest.mark.parametrize("op", ["segment_sum", "block_adjacency",
                                "flash_gat_attention",
                                "flash_gat_attention_bwd", "segment_softmax",
                                "segment_softmax_bwd", "spmm_multihead",
                                "spmm_multihead_bwd",
                                "gather_rows_sorted_grad_bwd",
                                "spmm_sorted_coo", "spmm_sorted_coo_bwd",
                                "block_spmm", "block_spmm_bwd",
                                "segment_max", "all_to_all"])
def test_non_cpu_tensor_never_takes_plain_path(op):
    """Only a CPU tensor takes the plain version: a tensor on another device
    goes to the kernel wrapper, which refuses it rather than falling back."""
    meta = torch.zeros(256, 4, device="meta")
    ids = torch.zeros(256, dtype=torch.int32, device="meta")
    call = {
        "segment_sum": lambda: ops.segment_sum(meta, ids, 8),
        "block_adjacency": lambda: ops.block_adjacency(
            ids, ids, None, ids[:3], 256),
        "flash_gat_attention": lambda: ops.flash_gat_attention(
            meta[:, :2], meta[:, :2], meta.view(256, 2, 2),
            torch.zeros(256, 256, device="meta")),
        "flash_gat_attention_bwd": lambda: ops.flash_gat_attention_bwd(
            meta[:, :2], meta[:, :2], meta.view(256, 2, 2),
            torch.zeros(256, 256, device="meta"), meta[:, :2],
            meta.view(256, 2, 2), meta.view(256, 2, 2)),
        "segment_softmax": lambda: ops.segment_softmax(meta, ids, 8),
        "segment_softmax_bwd": lambda: ops.segment_softmax_bwd(
            meta, meta, ids, 8),
        "spmm_multihead": lambda: ops.spmm_multihead(
            meta.view(256, 2, 2), ids, ids, meta[:, :2], 256),
        "spmm_multihead_bwd": lambda: ops.spmm_multihead_bwd(
            meta.view(256, 2, 2), ids, ids, meta[:, :2], 256,
            meta.view(256, 2, 2), ids, ids),
        "gather_rows_sorted_grad_bwd": lambda: ops.gather_rows_sorted_grad_bwd(
            meta, ids, 8),
        "spmm_sorted_coo": lambda: ops.spmm_sorted_coo(meta, ids, ids, None,
                                                       256),
        "spmm_sorted_coo_bwd": lambda: ops.spmm_sorted_coo_bwd(
            meta, ids, ids, None, 256, ids, ids),
        "block_spmm": lambda: ops.block_spmm(meta, ids, ids, None, ids[:3],
                                             ids, ids, None, ids[:3], 256),
        "block_spmm_bwd": lambda: ops.block_spmm_bwd(meta, ids, ids, None,
                                                     ids[:3], 256),
        "segment_max": lambda: ops.segment_max(meta, ids, 8),
        "all_to_all": lambda: ops.all_to_all([meta.view(2, 128, 4)] * 2),
    }[op]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


def _edge_list(rng, n, e, pad=37, sort=True):
    """An edge list over n nodes: a duplicate edge, node n-1 with only its
    self-loop, nodes n-3 and n-2 with no edges, and ``pad`` padding edges
    (src 0, dst n); dst-sorted unless ``sort`` is False."""
    src = rng.integers(0, n, e - 2)
    dst = rng.integers(0, n - 3, e - 2)
    src = np.concatenate([src, [src[0], n - 1]])
    dst = np.concatenate([dst, [dst[0], n - 1]])
    src = np.concatenate([src, np.zeros(pad)]).astype(np.int32)
    dst = np.concatenate([dst, np.full(pad, n)]).astype(np.int32)
    order = np.argsort(dst, kind="stable") if sort else rng.permutation(
        len(dst))
    src, dst = src[order], dst[order]
    perm = np.argsort(src, kind="stable").astype(np.int32)
    return src, dst, perm, src[perm]


def _mh_hard_cases(rng, device, dtype, tag):
    """The multi-head SpMM on inputs its backward finds hard, in ``dtype``
    (case names ``spmm_multihead{,_bwd}{tag}_<case>``): ``hub``, a source
    with 100,000 edges among short ones (a block's warps share it; g is
    positive, so its 100,000-term sums do not cancel), backward only;
    ``empty``, no edges; ``unaligned``, v and g as views 4 (f32) or 2
    (bf16) bytes off 16 (single values, not 16-byte words); H 4, D 32."""
    n, heads, head_dim = 300, 4, 32
    cases = {}
    src, dst, _, _ = _edge_list(rng, n, 3000)
    src = np.concatenate([src, np.full(100_000, 5, np.int32)])
    dst = np.concatenate([dst, rng.integers(0, n - 3, 100_000).astype(
        np.int32)])
    order = np.argsort(dst, kind="stable")  # the padding stays last
    src, dst = src[order], dst[order]
    perm = np.argsort(src, kind="stable").astype(np.int32)
    v, alpha, g = (rng.standard_normal((n, heads, head_dim)),
                   rng.random((len(src), heads)),
                   rng.random((n, heads, head_dim)) + 0.5)
    ids = _on(device, src, dst, perm, src[perm])
    v, alpha, g = (x.to(dtype) for x in _on(
        device, *(a.astype(np.float32) for a in (v, alpha, g))))
    cases[f"spmm_multihead_bwd{tag}_hub"] = (
        lambda: ops.spmm_multihead_bwd(v, ids[0], ids[1], alpha, n, g,
                                       ids[2], ids[3]),
        lambda: ops.spmm_multihead_bwd_plain(v, ids[0], ids[1], alpha, n, g))
    none = torch.zeros(0, dtype=torch.int32, device=device)
    a0 = torch.zeros(0, heads, dtype=dtype, device=device)
    for name, args, sort in (
            ("empty", (v, none, none, a0, n), (none, none)),
            ("unaligned", (_off16(v), ids[0], ids[1], alpha, n),
             (ids[2], ids[3]))):
        gg = _off16(g) if name == "unaligned" else g
        cases[f"spmm_multihead{tag}_{name}"] = (
            lambda a=args: ops.spmm_multihead(*a),
            lambda a=args: ops.spmm_multihead_plain(*a))
        cases[f"spmm_multihead_bwd{tag}_{name}"] = (
            lambda a=args, g=gg, s=sort: ops.spmm_multihead_bwd(*a, g, *s),
            lambda a=args, g=gg: ops.spmm_multihead_bwd_plain(*a, g))
    # hubdst: destination 7 on 1,000 more edges among short ones (the
    # forward shares it among a block's warps); alpha positive, so its
    # 1,000-term sums do not cancel
    src, dst, _, _ = _edge_list(rng, n, 3000)
    src = np.concatenate([src, rng.integers(0, n, 1000).astype(np.int32)])
    dst = np.concatenate([dst, np.full(1000, 7, np.int32)])
    order = np.argsort(dst, kind="stable")  # the padding stays last
    hub_ids = _on(device, src[order], dst[order])
    (hub_alpha,) = _on(device, rng.random((len(src), heads)).astype(
        np.float32))
    hub = (v, *hub_ids, hub_alpha.to(dtype), n)
    cases[f"spmm_multihead{tag}_hubdst"] = (
        lambda: ops.spmm_multihead(*hub),
        lambda: ops.spmm_multihead_plain(*hub))
    return cases


def _softmax_ids(rng, lengths, num_segments):
    """Sorted segment ids with the given run lengths (segment s has
    ``lengths[s]`` rows, then one or two rows each up to num_segments - 1),
    where half the segments have a run of padding ids (num_segments) inside
    their range (holes, ROADMAP F1), and 20 padding rows at the end."""
    parts = []
    for s in range(num_segments):
        rows = lengths[s] if s < len(lengths) else int(rng.integers(1, 3))
        cut = int(rng.integers(0, rows + 1))
        parts.append(np.full(cut, s))
        if rng.random() < 0.5 and 0 < cut < rows:
            parts.append(np.full(rng.integers(1, 40), num_segments))
        parts.append(np.full(rows - cut, s))
    parts.append(np.full(20, num_segments))
    return np.concatenate(parts).astype(np.int32)


def _softmax_hard_cases(rng, device, dtype, tag):
    """The segment softmax on inputs its walks find hard, in ``dtype``
    (case names ``segment_softmax{,_bwd}{tag}_<case>``): ``lengths_h<H>``,
    segments of 1, 32, 256, 257 and 1,000 rows (the register path and the
    long path) with holes, H 1, 3 and 8; ``short``, 200 segments of 1-2
    rows on average (one row a lane) with some of 32, 33 and 100 rows and
    holes; ``span256``, segments spanning exactly 255, 256 and 257 rows
    without holes, among others (8 rows a lane: 256 positions a warp in
    registers, 257 the long path); ``inf`` (forward only), an all--inf
    segment, a segment with one +inf score and a -inf score among finite
    ones; ``unaligned``, x, alpha and g as views 4 (f32) or 2 (bf16) bytes
    off 16 (off 8 and 4: single values, not pairs or words); and
    ``nosegments``, no segment at all, every row dropped."""
    cases = {}
    ids = _softmax_ids(rng, (1, 32, 256, 257, 1000), 40)
    (ids_t,) = _on(device, ids)
    for heads in (1, 3, 8):
        x, g = (t.to(dtype) for t in _on(device, *(
            (4 * rng.standard_normal((len(ids), heads))).astype(np.float32)
            for _ in range(2))))
        alpha = ops.segment_softmax_plain(x, ids_t, 40)
        cases[f"segment_softmax{tag}_lengths_h{heads}"] = (
            lambda x=x: ops.segment_softmax(x, ids_t, 40),
            lambda x=x: ops.segment_softmax_plain(x, ids_t, 40))
        cases[f"segment_softmax_bwd{tag}_lengths_h{heads}"] = (
            lambda a=alpha, g=g: ops.segment_softmax_bwd(a, g, ids_t, 40),
            lambda a=alpha, g=g: ops.segment_softmax_bwd_plain(a, g, ids_t,
                                                               40))
    x = 4 * rng.standard_normal((len(ids), 4)).astype(np.float32)
    x[ids == 0] = -np.inf
    x[np.flatnonzero(ids == 1)[0], 2] = np.inf
    x[np.flatnonzero(ids == 2)[3], 1] = -np.inf
    x[np.flatnonzero(ids == 4)[500], 0] = -np.inf  # the long path
    (xi,) = _on(device, x)
    xi = xi.to(dtype)
    cases[f"segment_softmax{tag}_inf"] = (
        lambda: ops.segment_softmax(xi, ids_t, 40),
        lambda: ops.segment_softmax_plain(xi, ids_t, 40))
    x, g = (t.to(dtype) for t in _on(device, *(
        rng.standard_normal((len(ids), 4)).astype(np.float32)
        for _ in range(2))))
    alpha = ops.segment_softmax_plain(x, ids_t, 40)
    xo, ao, go = _off16(x), _off16(alpha), _off16(g)
    cases[f"segment_softmax{tag}_unaligned"] = (
        lambda: ops.segment_softmax(xo, ids_t, 40),
        lambda: ops.segment_softmax_plain(xo, ids_t, 40))
    cases[f"segment_softmax_bwd{tag}_unaligned"] = (
        lambda: ops.segment_softmax_bwd(ao, go, ids_t, 40),
        lambda: ops.segment_softmax_bwd_plain(ao, go, ids_t, 40))
    cases[f"segment_softmax{tag}_nosegments"] = (
        lambda: ops.segment_softmax(x, ids_t, 0),
        lambda: ops.segment_softmax_plain(x, ids_t, 0))
    a0 = ops.segment_softmax_plain(x, ids_t, 0)
    cases[f"segment_softmax_bwd{tag}_nosegments"] = (
        lambda: ops.segment_softmax_bwd(a0, g, ids_t, 0),
        lambda: ops.segment_softmax_bwd_plain(a0, g, ids_t, 0))
    for name, lengths, n_seg in SOFTMAX_LAYOUTS:
        ids_n = _softmax_layout_ids(rng, name, lengths, n_seg)
        xs, gs, ids_s = _on(device, 4 * rng.standard_normal(
            (len(ids_n), 4)).astype(np.float32), rng.standard_normal(
            (len(ids_n), 4)).astype(np.float32), ids_n)
        xs, gs = xs.to(dtype), gs.to(dtype)
        a_s = ops.segment_softmax_plain(xs, ids_s, n_seg)
        cases[f"segment_softmax{tag}_{name}"] = (
            lambda xs=xs, i=ids_s, n=n_seg: ops.segment_softmax(xs, i, n),
            lambda xs=xs, i=ids_s, n=n_seg: ops.segment_softmax_plain(xs, i,
                                                                      n))
        cases[f"segment_softmax_bwd{tag}_{name}"] = (
            lambda a=a_s, gs=gs, i=ids_s, n=n_seg: ops.segment_softmax_bwd(
                a, gs, i, n),
            lambda a=a_s, gs=gs, i=ids_s, n=n_seg:
                ops.segment_softmax_bwd_plain(a, gs, i, n))
    return cases


# name, lengths, segments: ``short``, segments of 1-2 rows on average (one
# row a lane in registers) with some of 32, 33 and 100 rows and holes (the
# sweeps); ``span256``, segments spanning 256, 257 and 255 rows with no
# holes, 145 rows a segment on average (8 rows a lane)
SOFTMAX_LAYOUTS = (
    ("short", (1, 32, 33, 100), 200),
    ("span256", (256, 257, 255, 1, 2, 3, 32, 33, 100, 512), 10))


def _softmax_layout_ids(rng, name, lengths, num_segments):
    if name == "short":
        return _softmax_ids(rng, lengths, num_segments)
    return np.concatenate([np.repeat(np.arange(num_segments), lengths),
                           np.full(20, num_segments)]).astype(np.int32)


def _off16(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous view one element past the start of its
    storage, so that it does not start on 16 bytes."""
    flat = torch.cat([t.new_zeros(1), t.flatten()])
    return flat[1:].view(t.shape)


def _transposed_plan(bsrc, bdst, bn):
    """The source-sorted plan ``(tsrc, tdst, tstarts, order)`` of a
    dst-sorted block-local edge list (``order`` takes a forward weight to
    the plan's), as the backward of ``block_spmm`` takes it."""
    order = np.argsort(bsrc, kind="stable")
    real = bdst < bn
    tdst = np.where(real[order], bsrc[order], bn).astype(np.int32)
    tsrc = np.where(real[order], bdst[order], 0).astype(np.int32)
    tord = np.argsort(tdst, kind="stable")
    tst = np.searchsorted(tdst[tord], np.arange(0, bn + 1, 128)).astype(
        np.int32)
    return tsrc[tord], tdst[tord], tst, order[tord]


# the widths and head counts past the kernels' former caps (8 heads, 256
# columns of a multi-head row or a block-local row, head_dim 64 of the
# flash-GAT kernels): (H, D) of the multi-head SpMM, H of the softmax, F
# of the block-local SpMM, head_dim of the flash-GAT pair. The multi-head
# backward's strips pad a head's words to a power of two of lanes (D 24 in
# bf16: 3 words in 4 lanes; D 72 f32: 18 in 32; H 9, D 8: 9 heads in a
# strip), or to a multiple of 32 past 32 words (D 256 f32: 64; D 60 in
# bf16, single values: 64), and cut a head above 256 columns (D 300, 512);
# the tiled block SpMM sweeps F in chunks of 64 columns with a ragged last
# chunk (F 300: 44) and words of 16, 8, 4 or 2 bytes (F 1,024, 300, 258,
# 301 in bf16)
WIDE_MH = ((4, 256), (32, 24), (2, 512), (4, 72), (9, 8), (3, 300),
           (5, 60), (12, 40))
WIDE_SOFTMAX = (9, 16, 32)
WIDE_BLOCK = (300, 1024, 258, 301)
WIDE_FLASH = ((2, 72), (3, 128), (2, 256), (1, 300))
# the flash-GAT pair's wide tiling at N that spans several of its row
# blocks (64 rows), feature strips, source tiles and parts of the backward's
# sweep, with ragged tails (300 = 4 x 64 + 44, 1,030 = 16 x 64 + 6): (N, H,
# D); the forward's mask has an empty row and an empty tail of rows, as the
# backward's
WIDE_FLASH_TILED = tuple((n, h, d) for n in (300, 1030)
                         for h, d in ((4, 256), (2, 136), (1, 300)))


def _wide_cases(device):
    """name -> (kernel call, plain call) at the wide shapes (``WIDE_*``),
    float32 and bf16 where the form exists, forward and backward, on small
    inputs on ``device``. Its own generator: the other cases' draws stay as
    they were."""
    rng = np.random.default_rng(23)
    bf = torch.bfloat16
    cases = {}
    for heads in WIDE_SOFTMAX:
        ids = np.sort(np.concatenate([rng.integers(0, 37, 700),
                                      np.full(30, 40)])).astype(np.int32)
        x, g, ids_t = _on(device, 4 * rng.standard_normal(
            (len(ids), heads)).astype(np.float32), rng.standard_normal(
            (len(ids), heads)).astype(np.float32), ids)
        for dt, xt, gt in (("f32", x, g), ("bf16", x.to(bf), g.to(bf))):
            alpha = ops.segment_softmax_plain(xt, ids_t, 40)
            cases[f"wide_softmax_{dt}_h{heads}"] = (
                lambda x=xt, i=ids_t: ops.segment_softmax(x, i, 40),
                lambda x=xt, i=ids_t: ops.segment_softmax_plain(x, i, 40))
            cases[f"wide_softmax_bwd_{dt}_h{heads}"] = (
                lambda a=alpha, g=gt, i=ids_t: ops.segment_softmax_bwd(
                    a, g, i, 40),
                lambda a=alpha, g=gt, i=ids_t: ops.segment_softmax_bwd_plain(
                    a, g, i, 40))
    for heads, head_dim in WIDE_MH:
        n = 40
        src, dst, perm, ssorted = _on(device, *_edge_list(rng, n, 400))
        v, alpha, g = _on(device, rng.standard_normal(
            (n, heads, head_dim)).astype(np.float32), rng.random(
            (len(src), heads)).astype(np.float32), rng.standard_normal(
            (n, heads, head_dim)).astype(np.float32))
        for dt, cast in (("f32", lambda t: t), ("bf16", lambda t: t.to(bf))):
            args = (cast(v), src, dst, cast(alpha), n)
            tag = f"{dt}_h{heads}d{head_dim}"
            cases[f"wide_mh_{tag}"] = (
                lambda a=args: ops.spmm_multihead(*a),
                lambda a=args: ops.spmm_multihead_plain(*a))
            cases[f"wide_mh_bwd_{tag}"] = (
                lambda a=args, g=cast(g), p=perm, s=ssorted:
                    ops.spmm_multihead_bwd(*a, g, p, s),
                lambda a=args, g=cast(g): ops.spmm_multihead_bwd_plain(*a, g))
    # the strips' other paths: a source of 300 positions (the block's
    # warps share it, strip by strip) and v, g and d_v off 16 bytes (single
    # values), at W2's and W1's outer shapes
    for heads, head_dim in ((32, 24), (4, 256)):
        n = 40
        src, dst, _, _ = _edge_list(rng, n, 400)
        src = np.concatenate([src, np.full(300, 5, np.int32)])
        dst = np.concatenate([dst, rng.integers(0, n, 300).astype(np.int32)])
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        perm = np.argsort(src, kind="stable").astype(np.int32)
        src_t, dst_t, perm_t, ss_t = _on(device, src, dst, perm, src[perm])
        v, alpha, g = (rng.standard_normal((n, heads, head_dim)).astype(
            np.float32), rng.random((len(src), heads)).astype(np.float32),
            rng.standard_normal((n, heads, head_dim)).astype(np.float32))
        for dt, cast in (("f32", lambda t: t), ("bf16", lambda t: t.to(bf))):
            vt, at, gt = (cast(t) for t in _on(device, v, alpha, g))
            tag = f"{dt}_h{heads}d{head_dim}"
            cases[f"wide_mh_bwd_hub_{tag}"] = (
                lambda a=(vt, src_t, dst_t, at, n, gt, perm_t, ss_t):
                    ops.spmm_multihead_bwd(*a),
                lambda a=(vt, src_t, dst_t, at, n, gt):
                    ops.spmm_multihead_bwd_plain(*a))
            # the same values one element past a 16-byte boundary
            vu, gu = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(
                t.shape) for t in (vt, gt))
            cases[f"wide_mh_bwd_unaligned_{tag}"] = (
                lambda a=(vu, src_t, dst_t, at, n, gu, perm_t, ss_t):
                    ops.spmm_multihead_bwd(*a),
                lambda a=(vu, src_t, dst_t, at, n, gu):
                    ops.spmm_multihead_bwd_plain(*a))
    for feat in WIDE_BLOCK:
        bsrc, bdst, best, bn = _block_local_edges(rng, 3)
        bsrc[5] = (bsrc[5] + 200) % bn  # a source outside its block: dropped
        tsrc, tdst, tst, order = _transposed_plan(bsrc, bdst, bn)
        w = np.where(bdst < bn, rng.random(len(bsrc)), 0).astype(np.float32)
        s_, d_, e_, ts_, td_, tt_, w_, tw_, x = _on(
            device, bsrc, bdst, best, tsrc, tdst, tst, w, w[order],
            rng.standard_normal((bn, feat)).astype(np.float32))
        for (dt, xt), (wt, twt, wname) in itertools.product(
                (("f32", x), ("bf16", x.to(bf))),
                ((None, None, ""), (w_, tw_, "_weighted"))):
            cases[f"wide_block_spmm{wname}_{dt}_f{feat}"] = (
                lambda a=(xt, s_, d_, wt, e_, ts_, td_, twt, tt_, bn):
                    ops.block_spmm(*a),
                lambda a=(xt, s_, d_, wt): ops.block_spmm_plain(
                    *a, num_nodes=bn))
            cases[f"wide_block_spmm_bwd{wname}_{dt}_f{feat}"] = (
                lambda a=(xt, ts_, td_, twt, tt_, bn): ops.block_spmm_bwd(*a),
                lambda a=(xt, ts_, td_, twt): ops.block_spmm_plain(
                    *a, num_nodes=bn))
    for heads, head_dim in WIDE_FLASH:
        fwd = _on(device, *_gat_inputs(rng, 45, heads, head_dim))
        bwd = _bwd_inputs(rng, 70, heads, head_dim, device)
        cases[f"wide_flash_d{head_dim}"] = (
            lambda a=fwd: ops.flash_gat_attention(*a),
            lambda a=fwd: ops.flash_gat_attention_plain(*a))
        cases[f"wide_flash_bwd_d{head_dim}"] = (
            lambda a=bwd: ops.flash_gat_attention_bwd(*a),
            lambda a=bwd: ops.flash_gat_attention_bwd_plain(*a))
    for n, heads, head_dim in WIDE_FLASH_TILED:
        sl, sr, v, cnt = _gat_inputs(rng, n, heads, head_dim)
        cnt[(7 * n) // 10:] = 0.0
        fwd = _on(device, sl, sr, v, cnt)
        bwd = _bwd_inputs(rng, n, heads, head_dim, device)
        tag = f"n{n}_h{heads}d{head_dim}"
        cases[f"wide_flash_{tag}"] = (
            lambda a=fwd: ops.flash_gat_attention(*a),
            lambda a=fwd: ops.flash_gat_attention_plain(*a))
        cases[f"wide_flash_bwd_{tag}"] = (
            lambda a=bwd: ops.flash_gat_attention_bwd(*a),
            lambda a=bwd: ops.flash_gat_attention_bwd_plain(*a))
    return cases


# wide case prefix -> the wrapper that counts its launches
WIDE_OPS = (("wide_softmax_bwd", "segment_softmax_bwd"),
            ("wide_softmax", "segment_softmax"),
            ("wide_mh_bwd", "spmm_multihead_bwd"),
            ("wide_mh", "spmm_multihead"),
            ("wide_block_spmm_bwd", "block_spmm_bwd"),
            ("wide_block_spmm", "block_spmm"),
            ("wide_flash_bwd", "flash_gat_attention_bwd"),
            ("wide_flash", "flash_gat_attention"))


def _wide_op(case: str):
    return getattr(ops, next(op for pre, op in WIDE_OPS
                             if case.startswith(pre + "_")))


def _sparse_cases(device):
    """name -> (kernel call, plain call) for the sparse-outer GAT kernels,
    on small inputs on ``device``, and the wide cases (``_wide_cases``)."""
    rng = np.random.default_rng(3)
    cases = {}
    for tag, n_seg, heads, ids in (
            ("sorted_h4", 50, 4, np.sort(np.concatenate(
                [rng.integers(0, 47, 900), np.full(40, 50)]))),  # 47-49 empty
            ("holes_h8", 60, 8, _hole_ids(rng, 60)),
            ("shuffled_h1", 50, 1, rng.permutation(np.concatenate(
                [rng.integers(0, 50, 700), np.full(20, 50)])))):
        x, g, ids_t = _on(device, 4 * rng.standard_normal(
            (len(ids), heads)).astype(np.float32), rng.standard_normal(
            (len(ids), heads)).astype(np.float32), ids.astype(np.int32))
        alpha = ops.segment_softmax_plain(x, ids_t, n_seg)
        cases[f"segment_softmax_{tag}"] = (
            lambda x=x, i=ids_t, n=n_seg: ops.segment_softmax(x, i, n),
            lambda x=x, i=ids_t, n=n_seg: ops.segment_softmax_plain(x, i, n))
        cases[f"segment_softmax_bwd_{tag}"] = (
            lambda a=alpha, g=g, i=ids_t, n=n_seg: ops.segment_softmax_bwd(
                a, g, i, n),
            lambda a=alpha, g=g, i=ids_t, n=n_seg:
                ops.segment_softmax_bwd_plain(a, g, i, n))
    x1, ids1 = _on(device, rng.standard_normal(300).astype(np.float32),
                   np.sort(rng.integers(0, 30, 300)).astype(np.int32))
    cases["segment_softmax_1d"] = (
        lambda: ops.segment_softmax(x1, ids1, 30),
        lambda: ops.segment_softmax_plain(x1, ids1, 30))
    for tag, n, e, heads, head_dim, sort in (
            ("h4d32", 80, 1500, 4, 32, True), ("h8d32", 40, 600, 8, 32, True),
            ("h2d3", 30, 300, 2, 3, True), ("unsorted", 40, 500, 4, 8, False),
            ("h1d32", 60, 600, 1, 32, True), ("h1d3", 30, 300, 1, 3, True),
            ("h4d3", 30, 300, 4, 3, True), ("h8d3", 30, 300, 8, 3, True)):
        src, dst, perm, ssorted = _on(device, *_edge_list(rng, n, e,
                                                          sort=sort))
        v, alpha, g = _on(device, rng.standard_normal(
            (n, heads, head_dim)).astype(np.float32), rng.random(
            (len(src), heads)).astype(np.float32), rng.standard_normal(
            (n, heads, head_dim)).astype(np.float32))
        args = (v, src, dst, alpha, n)
        cases[f"spmm_multihead_{tag}"] = (
            lambda a=args: ops.spmm_multihead(*a),
            lambda a=args: ops.spmm_multihead_plain(*a))
        cases[f"spmm_multihead_bwd_{tag}"] = (
            lambda a=args, g=g, p=perm, s=ssorted: ops.spmm_multihead_bwd(
                *a, g, p, s),
            lambda a=args, g=g: ops.spmm_multihead_bwd_plain(*a, g))
    cases["spmm_multihead_bwd_argsort"] = (
        lambda a=args, g=g: ops.spmm_multihead_bwd(*a, g),
        lambda a=args, g=g: ops.spmm_multihead_bwd_plain(*a, g))
    cases.update(_mh_hard_cases(np.random.default_rng(13), device,
                                torch.float32, ""))
    cases.update(_softmax_hard_cases(np.random.default_rng(15), device,
                                     torch.float32, ""))
    src, dst, perm, ssorted = _on(device, *_edge_list(rng, 40, 400))
    (table,) = _on(device, rng.standard_normal((len(src), 4)).astype(
        np.float32))
    cases["gather_bwd_sorted"] = (
        lambda: ops.gather_rows_sorted_grad_bwd(table, dst, 40),
        lambda: ops.gather_rows_sorted_grad_bwd_plain(table, dst, 40))
    cases["gather_bwd_perm"] = (
        lambda: ops.gather_rows_sorted_grad_bwd(table, src, 40, perm, ssorted),
        lambda: ops.gather_rows_sorted_grad_bwd_plain(table, src, 40, perm,
                                                      ssorted))
    cases.update(_wide_cases(device))
    return cases


WIDE_CASES = [
    *(f"wide_softmax{b}_{d}_h{h}" for b in ("", "_bwd")
      for d in ("f32", "bf16") for h in WIDE_SOFTMAX),
    *(f"wide_mh{b}_{d}_h{h}d{k}" for b in ("", "_bwd")
      for d in ("f32", "bf16") for h, k in WIDE_MH),
    *(f"wide_mh_bwd_{c}_{d}_{t}" for c in ("hub", "unaligned")
      for d in ("f32", "bf16") for t in ("h32d24", "h4d256")),
    *(f"wide_block_spmm{b}{w}_{d}_f{f}" for b in ("", "_bwd")
      for w in ("", "_weighted") for d in ("f32", "bf16") for f in WIDE_BLOCK),
    *(f"wide_flash{b}_d{k}" for b in ("", "_bwd") for _, k in WIDE_FLASH),
    *(f"wide_flash{b}_n{n}_h{h}d{k}" for b in ("", "_bwd")
      for n, h, k in WIDE_FLASH_TILED)]
MH_TAGS = ("h4d32", "h8d32", "h2d3", "unsorted", "h1d32", "h1d3", "h4d3",
           "h8d3")
SOFTMAX_HARD = ("lengths_h1", "lengths_h3", "lengths_h8", "unaligned",
                "nosegments", "short", "span256")
SPARSE_CASES = [
    *(f"segment_softmax_{t}" for t in ("sorted_h4", "holes_h8", "shuffled_h1",
                                       "1d", "inf") + SOFTMAX_HARD),
    *(f"segment_softmax_bwd_{t}" for t in ("sorted_h4", "holes_h8",
                                           "shuffled_h1") + SOFTMAX_HARD),
    *(f"spmm_multihead_{t}" for t in MH_TAGS + ("empty", "unaligned",
                                                "hubdst")),
    *(f"spmm_multihead_bwd_{t}" for t in MH_TAGS + (
        "argsort", "hub", "empty", "unaligned")),
    "gather_bwd_sorted", "gather_bwd_perm", *WIDE_CASES]


def test_sparse_case_names_are_complete():
    assert sorted(_sparse_cases("cpu")) == sorted(SPARSE_CASES)


def test_sparse_plain_cases_run_on_cpu():
    """On CPU tensors each wrapper takes its plain version: both calls of a
    case agree exactly, and no launch is counted."""
    counted = (ops.segment_softmax, ops.segment_softmax_bwd,
               ops.spmm_multihead, ops.spmm_multihead_bwd,
               ops.gather_rows_sorted_grad_bwd, ops.block_spmm,
               ops.block_spmm_bwd, ops.flash_gat_attention,
               ops.flash_gat_attention_bwd)
    before = [k.launches for k in counted]
    for name, (kernel, plain) in _sparse_cases("cpu").items():
        got, want = kernel(), plain()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert _equal(a, b), name
    assert [k.launches for k in counted] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "segment_sum", "segment_sum_1d", "block_adjacency_count",
    "block_adjacency_weighted", "flash_gat_h4", "flash_gat_h8",
    "flash_gat_small", "flash_gat_bwd_n200", "flash_gat_bwd_h8",
    "flash_gat_bwd_small"])
def test_kernel_matches_plain_on_card(cuda_device, case):
    kernel, plain = _cases(cuda_device)[case]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    tol = GRAD_TOL if "bwd" in case else TOL
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["segment_sum", "flash_gat_attention"])
def test_autograd_through_kernels_on_card(cuda_device, op):
    """On CUDA tensors both ops carry gradients through their autograd
    Function: every input that requires one gets one, equal to the plain
    version's autograd."""
    rng = np.random.default_rng(1)
    if op == "segment_sum":
        ids = _hole_ids(rng, 60)
        (x,) = _on(cuda_device, rng.standard_normal(
            (len(ids), 24)).astype(np.float32))
        (ids_t,) = _on(cuda_device, ids)
        w = torch.randn(60, 24, device=cuda_device)
        inputs = [x.requires_grad_()]
        kernel = lambda a: ops.segment_sum(a, ids_t, 60)  # noqa: E731
        plain = lambda a: ops.segment_sum_plain(a, ids_t, 60)  # noqa: E731
        fn_name = "_SegmentSumBackward"
    else:
        sl, sr, v, cnt, _, _, w = _bwd_inputs(rng, 200, 4, 32, cuda_device)
        inputs = [a.requires_grad_() for a in (sl, sr, v)]
        kernel = lambda *a: ops.flash_gat_attention(*a, cnt)[0]  # noqa: E731
        plain = lambda *a: ops.flash_gat_attention_plain(  # noqa: E731
            *a, cnt)[0]
        fn_name = "_FlashGATAttentionBackward"
    out = kernel(*inputs)
    assert type(out.grad_fn).__name__ == fn_name
    got = torch.autograd.grad((out * w).sum(), inputs)
    want = torch.autograd.grad((plain(*inputs) * w).sum(), inputs)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g is not None and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.cpu().numpy(), w_.cpu().numpy(),
                                   **GRAD_TOL)


@pytest.mark.gpu
def test_train_step_through_all_four_kernels_on_card(cuda_device):
    """One Trainer step on the card launches all four kernels, and every
    parameter's gradient equals the same step run with the plain
    versions."""
    from bignn_tpu_torch.config import TrainConfig
    from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
    from bignn_tpu_torch.models import BiGNN, BiGNNConfig
    from bignn_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    data = prepare_device_data(make_synthetic_ddi(
        num_drugs=48, feat_dim=8, avg_degree=6.0, min_atoms=4, max_atoms=10,
        seed=0))
    cfg = BiGNNConfig.full_bignn(feat_dim=8, dim=16, heads=2)
    pairs = data.train_pairs[:32]
    mask = np.ones(32, np.float32)

    def step():
        trainer = Trainer(BiGNN(cfg), data, TrainConfig(), cuda_device)
        trainer.init(1)
        trainer.train_step(pairs, mask, 0, 0)
        return {k: p.grad.clone() for k, p in
                trainer.model.named_parameters()}

    kernels = (ops.segment_sum, ops.block_adjacency, ops.flash_gat_attention,
               ops.flash_gat_attention_bwd)
    before = [k.launches for k in kernels]
    got = step()
    assert all(k.launches > b for k, b in zip(kernels, before))
    with mock.patch.multiple(
            ops, segment_sum=ops.segment_sum_plain,
            block_adjacency=lambda s, d, w, e, n: ops.block_adjacency_plain(
                s, d, w, n),
            flash_gat_attention=ops.flash_gat_attention_plain):
        want = step()
    for name, g in got.items():
        scale = want[name].abs().max().item()
        np.testing.assert_allclose(g.cpu().numpy(), want[name].cpu().numpy(),
                                   rtol=2e-4, atol=2e-5 * max(scale, 1.0),
                                   err_msg=name)


@pytest.mark.gpu
def test_launch_counts_and_limits_on_card(cuda_device):
    cases = _cases(cuda_device)
    before = (ops.segment_sum.launches, ops.flash_gat_attention.launches)
    cases["segment_sum"][0]()
    cases["flash_gat_h4"][0]()
    cases["flash_gat_h4"][1]()  # the plain version counts nothing
    assert (ops.segment_sum.launches, ops.flash_gat_attention.launches) == (
        before[0] + 1, before[1] + 1)
    # head_dim 72 (once over the kernels' limit of 64): the kernel, as the
    # plain version computes it
    sl, sr, v, cnt = _on(cuda_device, *_gat_inputs(np.random.default_rng(5),
                                                   8, 2, 72))
    before = ops.flash_gat_attention.launches
    got = ops.flash_gat_attention(sl, sr, v, cnt)
    assert ops.flash_gat_attention.launches == before + 1
    for g, w in zip(got, ops.flash_gat_attention_plain(sl, sr, v, cnt)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ops.segment_sum(torch.zeros(4, 2, dtype=torch.float16,
                                    device=cuda_device),
                        torch.zeros(4, dtype=torch.int32,
                                    device=cuda_device), 1)


@pytest.mark.gpu
def test_backward_kernel_counts_and_refuses_on_card(cuda_device):
    rng = np.random.default_rng(2)
    args = _bwd_inputs(rng, 50, 2, 8, cuda_device)
    before = ops.flash_gat_attention_bwd.launches
    ops.flash_gat_attention_bwd(*args)
    ops.flash_gat_attention_bwd_plain(*args)  # the plain version counts nothing
    assert ops.flash_gat_attention_bwd.launches == before + 1
    sl, sr, v, cnt, lse, out, g = args
    strided = g.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_gat_attention_bwd(sl, sr, v, cnt, lse, out, strided)
    # head_dim 72 (once over the kernel's limit of 64)
    wide = _bwd_inputs(rng, 50, 2, 72, cuda_device)
    before = ops.flash_gat_attention_bwd.launches
    got = ops.flash_gat_attention_bwd(*wide)
    assert ops.flash_gat_attention_bwd.launches == before + 1
    for g, w in zip(got, ops.flash_gat_attention_bwd_plain(*wide)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **GRAD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_kernel_matches_plain_on_card(cuda_device, case):
    kernel, plain = _sparse_cases(cuda_device)[case]
    before = _wide_op(case).launches if case.startswith("wide_") else 0
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if case.startswith("wide_"):  # the kernel ran, at the wide shape
        assert _wide_op(case).launches == before + 1, case
    tol = (BF16_TOL if "bf16" in case else GRAD_TOL if "bwd" in case
           else TOL)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape, case
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **tol,
                                   err_msg=case)


@pytest.mark.gpu
def test_sparse_kernels_repeat_bit_for_bit_and_count(cuda_device):
    """No float atomics: two launches give the same bits. Each wrapper
    counts one launch per call, its plain version none."""
    cases = _sparse_cases(cuda_device)
    for name, kernel in (("segment_softmax", "segment_softmax_sorted_h4"),
                         ("segment_softmax_bwd",
                          "segment_softmax_bwd_sorted_h4"),
                         ("segment_softmax", "segment_softmax_lengths_h8"),
                         ("segment_softmax_bwd",
                          "segment_softmax_bwd_lengths_h3"),
                         ("spmm_multihead", "spmm_multihead_h4d32"),
                         ("spmm_multihead", "spmm_multihead_hubdst"),
                         ("spmm_multihead_bwd", "spmm_multihead_bwd_h4d32"),
                         ("spmm_multihead_bwd", "spmm_multihead_bwd_hub"),
                         ("gather_rows_sorted_grad_bwd", "gather_bwd_perm"),
                         *((_wide_op(c).__name__, c) for c in WIDE_CASES)):
        op = getattr(ops, name)
        before = op.launches
        a, b = cases[kernel][0](), cases[kernel][0]()
        cases[kernel][1]()
        assert op.launches == before + 2, name
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), name


@pytest.mark.gpu
def test_wide_flash_bwd_repeats_bit_for_bit_on_card(cuda_device):
    """The wide flash backward adds its dv, dsl and dsr in a fixed order
    whether its sweep runs in one part or several (through the scratch): two
    runs give the same bits, the second over freed memory filled with NaN,
    so that a partial read before it is written shows."""
    cases = _sparse_cases(cuda_device)
    for n, heads, head_dim in WIDE_FLASH_TILED:
        kernel = cases[f"wide_flash_bwd_n{n}_h{heads}d{head_dim}"][0]
        first = kernel()
        junk = torch.full((64 << 20,), float("nan"), device=cuda_device)
        del junk
        second = kernel()
        for x, y in zip(first, second):
            assert torch.equal(x, y), (n, heads, head_dim)


@pytest.mark.gpu
def test_sparse_kernels_refuse_on_card(cuda_device):
    rng = np.random.default_rng(6)
    z, alpha = _on(cuda_device, rng.standard_normal((16, 9)).astype(
        np.float32), rng.random((16, 4)).astype(np.float32))
    ids = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    # 9 heads and H * D = 288 (once over the kernels' limits of 8 and 256):
    # each kernel launches and agrees with its plain version
    before = (ops.segment_softmax.launches, ops.spmm_multihead.launches)
    np.testing.assert_allclose(
        ops.segment_softmax(z, ids, 4).cpu().numpy(),
        ops.segment_softmax_plain(z, ids, 4).cpu().numpy(), **TOL)
    (v,) = _on(cuda_device, rng.standard_normal((8, 4, 72)).astype(
        np.float32))
    np.testing.assert_allclose(
        ops.spmm_multihead(v, ids, ids, alpha, 8).cpu().numpy(),
        ops.spmm_multihead_plain(v, ids, ids, alpha, 8).cpu().numpy(), **TOL)
    assert (ops.segment_softmax.launches, ops.spmm_multihead.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="int32"):
        ops.segment_softmax(z[:, :4].contiguous(), ids.long(), 4)
    v = torch.zeros(8, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.spmm_multihead(v, ids, ids, z[:, :8:2], 8)
    # the backward of a head wider than a strip (D 300: two strips) takes
    # a scratch of the size its query gives, and refuses a shorter one
    size = ctypes.c_int64()
    cuda_lib.launch("bignn_spmm_multihead_bwd_scratch", cuda_device, 16, 2,
                    300, ctypes.addressof(size))
    assert size.value == 2 * 16 * 2
    v, g = (torch.zeros(8, 2, 300, device=cuda_device) for _ in range(2))
    a2 = alpha[:, :2].contiguous()
    d_v, d_a = torch.empty_like(v), torch.zeros_like(a2)
    first, last = (torch.empty(8, dtype=torch.int32, device=cuda_device)
                   for _ in range(2))
    part = torch.zeros(size.value - 1, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_lib.launch("bignn_spmm_multihead_bwd_f32", cuda_device,
                        v.data_ptr(), g.data_ptr(), ids.data_ptr(),
                        a2.data_ptr(), ids.data_ptr(), ids.data_ptr(), 16, 8,
                        8, 2, 300, first.data_ptr(), last.data_ptr(),
                        d_v.data_ptr(), d_a.data_ptr(), part.data_ptr(),
                        size.value - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["segment_softmax", "spmm_multihead",
                                "gather_rows_sorted_grad"])
def test_sparse_autograd_through_kernels_on_card(cuda_device, op):
    """The autograd Functions of the sparse-outer GAT ops on CUDA tensors:
    gradients equal the plain versions' autograd, and the backward
    kernels run."""
    rng = np.random.default_rng(4)
    src, dst, perm, ssorted = _on(cuda_device, *_edge_list(rng, 60, 900))
    e = len(src)
    if op == "segment_softmax":
        (x,) = _on(cuda_device, rng.standard_normal((e, 4)).astype(np.float32))
        inputs = [x.requires_grad_()]
        kernel = lambda a: ops.segment_softmax(a, dst, 60)  # noqa: E731
        plain = lambda a: ops.segment_softmax_plain(a, dst, 60)  # noqa: E731
        bwd = ops.segment_softmax_bwd
    elif op == "spmm_multihead":
        v, alpha = _on(cuda_device, rng.standard_normal(
            (60, 4, 16)).astype(np.float32), rng.random((e, 4)).astype(
            np.float32))
        inputs = [v.requires_grad_(), alpha.requires_grad_()]
        kernel = lambda a, b: ops.spmm_multihead(  # noqa: E731
            a, src, dst, b, 60, src_perm=perm, src_sorted=ssorted)
        plain = lambda a, b: ops.spmm_multihead_plain(  # noqa: E731
            a, src, dst, b, 60)
        bwd = ops.spmm_multihead_bwd
    else:
        (table,) = _on(cuda_device, rng.standard_normal((60, 4)).astype(
            np.float32))
        inputs = [table.requires_grad_()]
        kernel = lambda a: ops.gather_rows_sorted_grad(  # noqa: E731
            a, src, perm=perm, ids_sorted=ssorted)
        plain = lambda a: ops.gather_rows_sorted_grad_plain(a, src)  # noqa
        bwd = ops.gather_rows_sorted_grad_bwd
    out = kernel(*inputs)
    w = torch.randn(out.shape, device=cuda_device)
    before = bwd.launches
    got = torch.autograd.grad((out * w).sum(), inputs)
    assert bwd.launches == before + 1
    want = torch.autograd.grad((plain(*inputs) * w).sum(), inputs)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w_.cpu().numpy(),
                                   **GRAD_TOL)


@pytest.mark.gpu
def test_sparse_gat_train_step_on_card(cuda_device):
    """One Trainer step on an outer graph without dense masks runs every
    sparse-outer kernel, forward and backward, and no flash-GAT kernel;
    its gradients equal the same step with the plain versions."""
    from bignn_tpu_torch.config import TrainConfig
    from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
    from bignn_tpu_torch.models import BiGNN, BiGNNConfig
    from bignn_tpu_torch.sparse import build_outer_graph
    from bignn_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    data = prepare_device_data(make_synthetic_ddi(
        num_drugs=300, feat_dim=8, avg_degree=12.0, min_atoms=4,
        max_atoms=10, seed=0))
    tr = data.train_pairs
    data.outer = build_outer_graph(tr[:, 0], tr[:, 1], data.num_drugs,
                                   dense_max_nodes=0)
    cfg = BiGNNConfig.full_bignn(feat_dim=8, dim=32, heads=4)
    pairs = data.train_pairs[:64]
    mask = np.ones(64, np.float32)

    def step():
        trainer = Trainer(BiGNN(cfg), data, TrainConfig(), cuda_device)
        trainer.init(1)
        trainer.train_step(pairs, mask, 0, 0)
        return {k: p.grad.clone() for k, p in
                trainer.model.named_parameters()}

    kernels = (ops.segment_softmax, ops.segment_softmax_bwd,
               ops.spmm_multihead, ops.spmm_multihead_bwd,
               ops.gather_rows_sorted_grad_bwd, ops.flash_gat_attention)
    before = [k.launches for k in kernels]
    got = step()
    counts = [k.launches - b for k, b in zip(kernels, before)]
    assert all(c > 0 for c in counts[:-1]) and counts[-1] == 0, counts
    with mock.patch.multiple(
            ops, segment_sum=ops.segment_sum_plain,
            block_adjacency=lambda s, d, w, e, n: ops.block_adjacency_plain(
                s, d, w, n),
            segment_softmax=ops.segment_softmax_plain,
            spmm_multihead=ops.spmm_multihead_plain,
            gather_rows_sorted_grad=ops.gather_rows_sorted_grad_plain):
        want = step()
    for name, g in got.items():
        scale = want[name].abs().max().item()
        np.testing.assert_allclose(g.cpu().numpy(), want[name].cpu().numpy(),
                                   rtol=2e-4, atol=2e-5 * max(scale, 1.0),
                                   err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_multihead_fwd_unaligned_out_on_card(cuda_device, dtype):
    """The forward's entry point with out (and then v too) 4 (f32) or 2
    (bf16) bytes off 16, which the wrapper never passes: single values, the
    plain version's result."""
    rng = np.random.default_rng(17)
    n, heads, head_dim = 60, 4, 32
    src, dst, _, _ = _on(cuda_device, *_edge_list(rng, n, 600))
    v, alpha = (t.to(dtype) for t in _on(
        cuda_device, rng.standard_normal((n, heads, head_dim)).astype(
            np.float32), rng.random((len(src), heads)).astype(np.float32)))
    want = ops.spmm_multihead_plain(v, src, dst, alpha, n)
    for vv in (v, _off16(v)):
        out = _off16(torch.zeros_like(want))
        first, last = (torch.empty(n, dtype=torch.int32, device=cuda_device)
                       for _ in range(2))
        cuda_lib.launch(
            f"bignn_spmm_multihead_fwd_{cuda_lib.dtype_name(dtype)}",
            cuda_device, vv.data_ptr(), src.data_ptr(), dst.data_ptr(),
            alpha.data_ptr(), len(src), n, n, heads, head_dim,
            first.data_ptr(), last.data_ptr(), out.data_ptr())
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            out.float().cpu().numpy(), want.float().cpu().numpy(),
            **(TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.gpu
def test_spmm_multihead_past_int32_offsets_on_card(cuda_device):
    """E * H * D = 17M * 128 > 2**31: the [E, H*D] offsets of the plain
    version and every flat offset of the kernels are 64-bit. The forward is
    held to the plain version whole; the backward to the plain backward
    summed over chunks of edges (whole, it would hold ~50 GB)."""
    n, e, heads, head_dim = 2048, 17_000_000, 4, 32
    assert e * heads * head_dim > 2**31
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    dst = torch.sort(torch.randint(0, n, (e,), device=cuda_device,
                                   generator=gen, dtype=torch.int32)).values
    src = torch.randint(0, n, (e,), device=cuda_device, generator=gen,
                        dtype=torch.int32)
    v = torch.randn(n, heads, head_dim, device=cuda_device, generator=gen)
    alpha = torch.rand(e, heads, device=cuda_device, generator=gen) / 4096
    g = torch.randn(n, heads, head_dim, device=cuda_device, generator=gen)
    got = ops.spmm_multihead(v, src, dst, alpha, n)
    want = ops.spmm_multihead_plain(v, src, dst, alpha, n)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **GRAD_TOL)
    del got, want
    d_v, d_alpha = ops.spmm_multihead_bwd(v, src, dst, alpha, n, g)
    want_dv = torch.zeros_like(v)
    for s in range(0, e, 1 << 21):
        part_dv, part_da = ops.spmm_multihead_bwd_plain(
            v, src[s:s + (1 << 21)], dst[s:s + (1 << 21)],
            alpha[s:s + (1 << 21)], n, g)
        want_dv += part_dv
        np.testing.assert_allclose(d_alpha[s:s + (1 << 21)].cpu().numpy(),
                                   part_da.cpu().numpy(), **GRAD_TOL)
    scale = want_dv.abs().max().item()
    np.testing.assert_allclose(d_v.cpu().numpy(), want_dv.cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * max(scale, 1.0))


def _count_edges(rng, nblk, max_mult=16):
    """Dst-sorted block-local edges in which one (d, s) pair repeats
    ``max_mult`` times (config4's superrow bound r_node**2 = 16), plus
    padding."""
    src, dst, est, n = _block_local_edges(rng, nblk)
    real = dst < n
    # _block_local_edges already holds the pair (dst[0], src[0]) twice
    src = np.concatenate([src[real], np.full(max_mult - 2, src[0])])
    dst = np.concatenate([dst[real], np.full(max_mult - 2, dst[0])])
    order = np.argsort(dst, kind="stable")
    src = np.concatenate([src[order], np.zeros(50, np.int32)])
    dst = np.concatenate([dst[order], np.full(50, n, np.int32)])
    est = np.searchsorted(dst, np.arange(0, n + 1, 128)).astype(np.int32)
    return src.astype(np.int32), dst.astype(np.int32), est, n


def _dtype_cases(device):
    """name -> (kernel call, plain call) for the bf16 forms of the segment
    sum, softmax, multi-head SpMM and gather backward, and the bf16, int8
    and int16 block adjacencies; on small inputs on ``device``."""
    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    cases = {}
    ids = _hole_ids(rng, 60)
    ids_t = _on(device, ids)[0]
    for feat in (130, 3):  # pairs of bf16, and single values
        (x,) = _on(device, rng.standard_normal((len(ids), feat)).astype(
            np.float32))
        x = x.to(bf)
        cases[f"segment_sum_bf16_f{feat}"] = (
            lambda x=x: ops.segment_sum(x, ids_t, 60),
            lambda x=x: ops.segment_sum_plain(x, ids_t, 60))
    bsrc, bdst, best = _on(device, *_count_edges(rng, 3)[:3])
    w = torch.rand(bsrc.shape[0], device=device) * (bdst < 384)
    for dt in (torch.int8, torch.int16, bf):
        cases[f"block_adjacency_{dt}"] = (
            lambda dt=dt: ops.block_adjacency(bsrc, bdst, None, best, 384,
                                              dt),
            lambda dt=dt: ops.block_adjacency_plain(bsrc, bdst, None, 384,
                                                    dt))
    cases["block_adjacency_bf16_weighted"] = (
        lambda: ops.block_adjacency(bsrc, bdst, w, best, 384, bf),
        lambda: ops.block_adjacency_plain(bsrc, bdst, w, 384, bf))
    for tag, n_seg, heads, sids in (
            ("holes_h4", 60, 4, _hole_ids(rng, 60)),
            ("shuffled_h3", 50, 3, rng.permutation(np.concatenate(
                [rng.integers(0, 50, 700), np.full(20, 50)])))):
        x, g, i = _on(device, 4 * rng.standard_normal(
            (len(sids), heads)).astype(np.float32), rng.standard_normal(
            (len(sids), heads)).astype(np.float32), sids.astype(np.int32))
        x, g = x.to(bf), g.to(bf)
        alpha = ops.segment_softmax_plain(x, i, n_seg)
        cases[f"segment_softmax_bf16_{tag}"] = (
            lambda x=x, i=i, n=n_seg: ops.segment_softmax(x, i, n),
            lambda x=x, i=i, n=n_seg: ops.segment_softmax_plain(x, i, n))
        cases[f"segment_softmax_bwd_bf16_{tag}"] = (
            lambda a=alpha, g=g, i=i, n=n_seg: ops.segment_softmax_bwd(
                a, g, i, n),
            lambda a=alpha, g=g, i=i, n=n_seg:
                ops.segment_softmax_bwd_plain(a, g, i, n))
    for tag, n, e, heads, head_dim, sort in (
            ("h4d32", 80, 1500, 4, 32, True), ("h2d3", 30, 300, 2, 3, True),
            ("unsorted", 40, 500, 4, 8, False),
            ("h1d32", 60, 600, 1, 32, True), ("h8d32", 40, 600, 8, 32, True),
            ("h8d3", 30, 300, 8, 3, True)):
        src, dst, perm, ssorted = _on(device, *_edge_list(rng, n, e,
                                                          sort=sort))
        v, alpha, g = _on(device, rng.standard_normal(
            (n, heads, head_dim)).astype(np.float32), rng.random(
            (len(src), heads)).astype(np.float32), rng.standard_normal(
            (n, heads, head_dim)).astype(np.float32))
        args = (v.to(bf), src, dst, alpha.to(bf), n)
        g = g.to(bf)
        cases[f"spmm_multihead_bf16_{tag}"] = (
            lambda a=args: ops.spmm_multihead(*a),
            lambda a=args: ops.spmm_multihead_plain(*a))
        cases[f"spmm_multihead_bwd_bf16_{tag}"] = (
            lambda a=args, g=g, p=perm, s=ssorted: ops.spmm_multihead_bwd(
                *a, g, p, s),
            lambda a=args, g=g: ops.spmm_multihead_bwd_plain(*a, g))
    cases["spmm_multihead_bwd_bf16_argsort"] = (
        lambda a=args, g=g: ops.spmm_multihead_bwd(*a, g),
        lambda a=args, g=g: ops.spmm_multihead_bwd_plain(*a, g))
    cases.update(_mh_hard_cases(np.random.default_rng(14), device, bf,
                                "_bf16"))
    cases.update(_softmax_hard_cases(np.random.default_rng(16), device, bf,
                                     "_bf16"))
    src, dst, perm, ssorted = _on(device, *_edge_list(rng, 40, 400))
    (table,) = _on(device, rng.standard_normal((len(src), 4)).astype(
        np.float32))
    table = table.to(bf)
    cases["gather_bwd_bf16_sorted"] = (
        lambda: ops.gather_rows_sorted_grad_bwd(table, dst, 40),
        lambda: ops.gather_rows_sorted_grad_bwd_plain(table, dst, 40))
    cases["gather_bwd_bf16_perm"] = (
        lambda: ops.gather_rows_sorted_grad_bwd(table, src, 40, perm, ssorted),
        lambda: ops.gather_rows_sorted_grad_bwd_plain(table, src, 40, perm,
                                                      ssorted))
    return cases


DTYPE_CASES = [
    "segment_sum_bf16_f130", "segment_sum_bf16_f3",
    "block_adjacency_torch.int8", "block_adjacency_torch.int16",
    "block_adjacency_torch.bfloat16", "block_adjacency_bf16_weighted",
    *(f"segment_softmax{b}_bf16_{t}" for b in ("", "_bwd")
      for t in ("holes_h4", "shuffled_h3") + SOFTMAX_HARD),
    "segment_softmax_bf16_inf",
    *(f"spmm_multihead{b}_bf16_{t}" for b in ("", "_bwd")
      for t in ("h4d32", "h2d3", "unsorted", "h1d32", "h8d32", "h8d3",
                "empty", "unaligned")),
    "spmm_multihead_bf16_hubdst",
    "spmm_multihead_bwd_bf16_argsort", "spmm_multihead_bwd_bf16_hub",
    "gather_bwd_bf16_sorted", "gather_bwd_bf16_perm"]


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def test_dtype_case_names_are_complete():
    assert sorted(_dtype_cases("cpu")) == sorted(DTYPE_CASES)


def test_dtype_plain_cases_run_on_cpu():
    """On CPU tensors every bf16/int form takes its plain version: the
    output keeps the input's type (or the asked one), both calls agree
    exactly, no launch is counted, and int8 counts reach 16."""
    counted = (ops.segment_sum, ops.block_adjacency, ops.segment_softmax,
               ops.segment_softmax_bwd, ops.spmm_multihead,
               ops.spmm_multihead_bwd, ops.gather_rows_sorted_grad_bwd)
    before = [k.launches for k in counted]
    for name, (kernel, plain) in _dtype_cases("cpu").items():
        got, want = kernel(), plain()
        for a, b in zip(_outputs(got), _outputs(want)):
            assert _equal(a, b), name
            assert a.dtype != torch.float32, name
    assert [k.launches for k in counted] == before
    cnt = _dtype_cases("cpu")["block_adjacency_torch.int8"][0]()
    assert int(cnt.max()) == 16


@pytest.mark.gpu
@pytest.mark.parametrize("case", DTYPE_CASES)
def test_dtype_kernel_matches_plain_on_card(cuda_device, case):
    kernel, plain = _dtype_cases(cuda_device)[case]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for g, w in zip(_outputs(got), _outputs(want)):
        assert g.dtype == w.dtype, case
        if not g.dtype.is_floating_point:  # counts: exact
            assert torch.equal(g, w), case
        else:
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().cpu().numpy(), **BF16_TOL,
                                       err_msg=case)


@pytest.mark.gpu
def test_dtype_kernels_repeat_bit_for_bit_and_count_by_dtype(cuda_device):
    """Two launches of each bf16/int form give the same bits, and each
    counts under its element type in ``launches_by_dtype``."""
    cases = _dtype_cases(cuda_device)
    for op, case, key in (
            ("segment_sum", "segment_sum_bf16_f130", "bf16"),
            ("block_adjacency", "block_adjacency_torch.int8", "int8"),
            ("block_adjacency", "block_adjacency_torch.int16", "int16"),
            ("block_adjacency", "block_adjacency_bf16_weighted", "bf16"),
            ("segment_softmax", "segment_softmax_bf16_holes_h4", "bf16"),
            ("segment_softmax_bwd", "segment_softmax_bwd_bf16_holes_h4",
             "bf16"),
            ("segment_softmax", "segment_softmax_bf16_lengths_h8", "bf16"),
            ("spmm_multihead", "spmm_multihead_bf16_h4d32", "bf16"),
            ("spmm_multihead", "spmm_multihead_bf16_hubdst", "bf16"),
            ("spmm_multihead_bwd", "spmm_multihead_bwd_bf16_h4d32", "bf16"),
            ("spmm_multihead_bwd", "spmm_multihead_bwd_bf16_hub", "bf16"),
            ("gather_rows_sorted_grad_bwd", "gather_bwd_bf16_perm", "bf16")):
        fn = getattr(ops, op)
        before = fn.launches_by_dtype.get(key, 0)
        a, b = cases[case][0](), cases[case][0]()
        cases[case][1]()
        assert fn.launches_by_dtype[key] == before + 2, case
        for x, y in zip(_outputs(a), _outputs(b)):
            assert torch.equal(x, y), case


@pytest.mark.gpu
def test_dtype_kernels_refuse_on_card(cuda_device):
    ids = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ops.segment_softmax(torch.zeros(16, 4, dtype=torch.float16,
                                        device=cuda_device), ids, 4)
    v = torch.zeros(8, 4, 8, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="torch.bfloat16"):
        ops.spmm_multihead(v, ids, ids, torch.zeros(16, 4, device=cuda_device),
                           8)  # alpha in float32, v in bf16
    est = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float output"):
        ops.block_adjacency(ids, ids, torch.zeros(16, device=cuda_device),
                            est, 128, torch.int8)
    with pytest.raises(NotImplementedError, match="int16"):
        ops.block_adjacency(ids, ids, None, est, 128, torch.int32)


def _streaming_cases(device):
    """name -> (kernel call, plain call) for the sorted-COO SpMM, the
    block-local SpMM and the segment max (forward and backward, weighted
    and unweighted, float32 and the ``_bf16`` forms with float32 weights),
    on small inputs on ``device``: row widths that take 16-byte loads with
    1, 2 and 4 edges a warp (f32 F 128, 64, 32; bf16 F 128 and 64 take 2
    and 4), single values (F 3), bf16 pairs (F 130), two sweeps (F 256);
    padding edges (dst = N), an unsorted dst with padding between runs, an
    out-of-block edge."""
    rng = np.random.default_rng(11)
    bf = torch.bfloat16
    cases = {}
    for tag, n, e, feat, sort in (
            ("f128", 90, 900, 128, True), ("f64", 70, 700, 64, True),
            ("f32", 60, 500, 32, True), ("f3", 40, 300, 3, True),
            ("f130", 40, 300, 130, True), ("f256", 30, 200, 256, True),
            ("unsorted_f32", 50, 400, 32, False)):
        src, dst, perm, ssorted = _on(device, *_edge_list(rng, n, e,
                                                          sort=sort))
        x, g = _on(device, rng.standard_normal((n, feat)).astype(np.float32),
                   rng.standard_normal((n, feat)).astype(np.float32))
        (w,) = _on(device, rng.random(len(src)).astype(np.float32))
        forms = [("", x, g)]
        if tag in STREAMING_BF16_TAGS:
            forms.append(("_bf16", x.to(bf), g.to(bf)))
        for (dt, xt, gt), (wt, wname) in itertools.product(
                forms, ((None, ""), (w, "_weighted"))):
            cases[f"spmm{wname}{dt}_{tag}"] = (
                lambda a=(xt, src, dst, wt, n): ops.spmm_sorted_coo(*a),
                lambda a=(xt, src, dst, wt, n): ops.spmm_sorted_coo_plain(*a))
            cases[f"spmm_bwd{wname}{dt}_{tag}"] = (
                lambda a=(gt, src, dst, wt, n, perm, ssorted):
                    ops.spmm_sorted_coo_bwd(*a),
                lambda a=(gt, src, dst, wt, n):
                    ops.spmm_sorted_coo_bwd_plain(*a))
    cases["spmm_bwd_argsort_f32"] = (  # no source-sort arrays: one sort
        lambda a=(g, src, dst, None, n): ops.spmm_sorted_coo_bwd(*a),
        lambda a=(g, src, dst, None, n): ops.spmm_sorted_coo_bwd_plain(*a))
    def block_cases(tag, feat, dense, bf16_only):
        bsrc, bdst, best, bn = _block_local_edges(rng, 4)
        bsrc[5] = (bsrc[5] + 200) % bn  # a source outside its block: dropped
        if dense:  # block 2 every (d, s) pair; block 3 one pair 300 times
            every = np.arange(256, 384)
            real = bdst < bn
            bsrc = np.concatenate([bsrc[real], np.tile(every, 128),
                                   np.full(300, 3 * 128 + 9)])
            bdst = np.concatenate([bdst[real], np.repeat(every, 128),
                                   np.full(300, 3 * 128 + 100)])
            o = np.argsort(bdst, kind="stable")
            bsrc = np.concatenate([bsrc[o], np.zeros(100)]).astype(np.int32)
            bdst = np.concatenate([bdst[o], np.full(100, bn)]).astype(
                np.int32)
            best = np.searchsorted(bdst, np.arange(0, bn + 1, 128)).astype(
                np.int32)
        tsrc, tdst, tst, order = _transposed_plan(bsrc, bdst, bn)
        w = np.where(bdst < bn, rng.random(len(bsrc)), 0).astype(np.float32)
        t = _on(device, bsrc, bdst, best, tsrc, tdst, tst, w, w[order],
                rng.standard_normal((bn, feat)).astype(np.float32))
        s_, d_, e_, ts_, td_, tt_, w_, tw_, x32 = t
        forms = ([] if bf16_only else [("", x32)]) + (
            [("_bf16", x32.to(bf))] if feat != 32 else [])
        for (dt, xb), (wt, twt, wname) in itertools.product(
                forms, ((None, None, ""), (w_, tw_, "_weighted"))):
            cases[f"block_spmm{wname}{dt}_{tag}"] = (
                lambda a=(xb, s_, d_, wt, e_, ts_, td_, twt, tt_, bn):
                    ops.block_spmm(*a),
                lambda a=(xb, s_, d_, wt): ops.block_spmm_plain(
                    *a, num_nodes=bn))
            cases[f"block_spmm_bwd{wname}{dt}_{tag}"] = (
                lambda a=(xb, ts_, td_, twt, tt_, bn): ops.block_spmm_bwd(*a),
                lambda a=(xb, ts_, td_, twt): ops.block_spmm_plain(
                    *a, num_nodes=bn))

    for feat in (128, 32, 3):
        block_cases(f"f{feat}", feat, False, False)
    # the segment max's cotangents and its non-finite case draw from
    # generators of their own, so that rng's draws stay as they were
    grng = np.random.default_rng(21)

    def max_cases(tag, x, i, n, op_call=False):
        """The segment max forward and its backward at data x, ids i, n
        segments: from autograd (one launch on the forward's bounds) and,
        with ``op_call``, the op's own call (its bounds pass, then the same
        kernel); each against the composed plain rule."""
        g = torch.from_numpy(grng.standard_normal(
            (n,) + tuple(x.shape[1:])).astype(np.float32)).to(x.device,
                                                              x.dtype)
        cases[f"segment_max_{tag}"] = (
            lambda: ops.segment_max(x, i, n),
            lambda: ops.segment_max_plain(x, i, n))
        plain = (lambda: ops.segment_max_bwd_plain(
            x, i, ops.segment_max_plain(x, i, n), g, n))
        cases[f"segment_max_bwd_{tag}"] = (
            lambda: _max_vjp(x, i, n, g), plain)
        if op_call:
            def op(x=x, i=i, n=n, g=g):
                out = ops.segment_max_plain(x, i, n)
                _dirty(x)
                return ops.segment_max_bwd(x, i, out, g, n)

            cases[f"segment_max_bwd_op_{tag}"] = (op, plain)

    for tag, n_seg, ids, feat in (
            ("holes_f128", 60, _hole_ids(rng, 60), 128),
            ("holes_f130", 60, _hole_ids(rng, 60), 130),
            ("shuffled_f8", 50, rng.permutation(np.concatenate(
                [rng.integers(0, 47, 700), np.full(20, 50)])), 8)):
        x, i = _on(device, (rng.integers(-4, 5, (len(ids), feat)) / 2).astype(
            np.float32), ids.astype(np.int32))  # many ties
        max_cases(tag, x, i, n_seg, op_call=tag == "holes_f128")
        if tag.startswith("holes"):  # bf16 pairs (F 128, 130)
            max_cases(f"bf16_{tag}", x.to(bf), i, n_seg,
                      op_call=tag == "holes_f130")
    x1, i1 = _on(device, rng.standard_normal(300).astype(np.float32),
                 np.sort(rng.integers(0, 30, 300)).astype(np.int32))
    max_cases("1d", x1, i1, 30)
    x, i = _on(device, *_nonfinite_max_inputs(np.random.default_rng(22)))
    for dt, name in ((torch.float32, ""), (bf, "bf16_")):
        max_cases(f"{name}nonfinite_f128", x.to(dt), i, 60)
    # the bf16 tensor-core widths: one n-tile pair (8), whole chunks (64,
    # 256: two), a chunk and a tail (136); a dense block and a repeated pair
    for feat in BLOCK_BF16_FEATS:
        block_cases(f"f{feat}", feat, False, True)
    block_cases("dense", 128, True, False)
    # data as a view 4 (f32) or 2 (bf16) bytes off 16: single values, not
    # bf16 pairs
    rng = np.random.default_rng(18)
    ids = _hole_ids(rng, 60)
    x, i = _on(device, rng.standard_normal((len(ids), 128)).astype(
        np.float32), ids)
    for dt, name in ((torch.float32, ""), (bf, "bf16_")):
        max_cases(f"{name}unaligned", _off16(x.to(dt)), i, 60)
    return cases


def _max_vjp(x, ids, n, g):
    """``d_x`` of ``ops.segment_max(x, ids, n)`` for the cotangent ``g``,
    through autograd, as the max readout's backward runs; NaN left in the
    allocator's block that d takes, so that a row the kernel leaves
    unwritten does not read as 0."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        out = ops.segment_max(xr, ids, n)
        _dirty(x)
        return torch.autograd.grad(out, xr, g)[0]


def _nonfinite_max_inputs(rng):
    """Hole-interleaved ids over 60 segments, F 128, values on a coarse grid
    (0s among them), and segments whose max is NaN (0, 4), +inf (1) or
    -inf (2: every row), stored as 0: their rows equal to 0 share the
    cotangent (the composed rule's compare against the stored max)."""
    ids = _hole_ids(rng, 60)
    x = (rng.integers(-4, 5, (len(ids), 128)) / 2).astype(np.float32)
    for s, v in ((0, np.nan), (1, np.inf), (2, -np.inf), (4, np.nan)):
        rows = np.flatnonzero(ids == s)
        x[rows] = -np.inf if v == -np.inf else -1.0
        x[rows[0], :64] = v
        if v != -np.inf:
            x[rows[-1], 32:] = 0.0
    return x, ids


STREAMING_BF16_TAGS = ("f128", "f64", "f3", "f130", "unsorted_f32")
BLOCK_BF16_FEATS = (8, 64, 136, 256)
STREAMING_CASES = [
    *(f"spmm{b}{w}_{t}" for b in ("", "_bwd") for w in ("", "_weighted")
      for t in ("f128", "f64", "f32", "f3", "f130", "f256", "unsorted_f32")),
    *(f"spmm{b}{w}_bf16_{t}" for b in ("", "_bwd") for w in ("", "_weighted")
      for t in STREAMING_BF16_TAGS),
    "spmm_bwd_argsort_f32",
    *(f"block_spmm{b}{w}{d}_{t}" for b in ("", "_bwd")
      for w in ("", "_weighted") for d in ("", "_bf16")
      for t in ("f128", "f32", "f3", "dense") if not (d and t == "f32")),
    *(f"block_spmm{b}{w}_bf16_f{f}" for b in ("", "_bwd")
      for w in ("", "_weighted") for f in BLOCK_BF16_FEATS),
    *(f"segment_max{b}_{t}" for b in ("", "_bwd")
      for t in ("holes_f128", "holes_f130", "shuffled_f8", "1d",
                "bf16_holes_f128", "bf16_holes_f130", "nonfinite_f128",
                "bf16_nonfinite_f128", "unaligned", "bf16_unaligned")),
    "segment_max_bwd_op_holes_f128", "segment_max_bwd_op_bf16_holes_f130"]


def test_streaming_case_names_are_complete():
    assert sorted(_streaming_cases("cpu")) == sorted(STREAMING_CASES)


def test_streaming_plain_cases_run_on_cpu():
    """On CPU tensors each wrapper takes its plain version: both calls of a
    case agree exactly, and no launch is counted."""
    counted = (ops.spmm_sorted_coo, ops.spmm_sorted_coo_bwd, ops.block_spmm,
               ops.block_spmm_bwd, ops.segment_max, ops.segment_max_bwd)
    before = [k.launches for k in counted]
    for name, (kernel, plain) in _streaming_cases("cpu").items():
        assert torch.equal(kernel(), plain()), name
    assert [k.launches for k in counted] == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", STREAMING_CASES)
def test_streaming_kernel_matches_plain_on_card(cuda_device, case):
    kernel, plain = _streaming_cases(cuda_device)[case]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    assert got.dtype == want.dtype, case
    if case.startswith("segment_max"):
        # a max is one of its inputs, and its backward does the composed
        # rule's operations (an integer count, one float32 divide): the
        # same bits, the sign of every 0 included
        bits = torch.int32 if got.dtype == torch.float32 else torch.int16
        assert got.shape == want.shape, case
        assert torch.equal(got.view(bits), want.view(bits)), case
        return
    tol = BF16_TOL if "_bf16" in case else GRAD_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol,
                               err_msg=case)


@pytest.mark.gpu
def test_streaming_kernels_repeat_bit_for_bit_and_count(cuda_device):
    """No float atomics: two launches give the same bits. Each wrapper
    counts one launch per call under its form (``f32`` or ``bf16``, with
    ``:weighted`` for a weighted SpMM), its plain version none."""
    cases = _streaming_cases(cuda_device)
    for op, case, key in (
            ("spmm_sorted_coo", "spmm_f128", "f32"),
            ("spmm_sorted_coo", "spmm_weighted_f32", "f32:weighted"),
            ("spmm_sorted_coo_bwd", "spmm_bwd_f64", "f32"),
            ("spmm_sorted_coo_bwd", "spmm_bwd_weighted_f3", "f32:weighted"),
            ("block_spmm", "block_spmm_f128", "f32"),
            ("block_spmm", "block_spmm_weighted_f32", "f32:weighted"),
            ("block_spmm_bwd", "block_spmm_bwd_weighted_f128",
             "f32:weighted"),
            ("segment_max", "segment_max_holes_f128", "f32"),
            ("spmm_sorted_coo", "spmm_bf16_f128", "bf16"),
            ("spmm_sorted_coo", "spmm_weighted_bf16_f64", "bf16:weighted"),
            ("spmm_sorted_coo_bwd", "spmm_bwd_bf16_f128", "bf16"),
            ("spmm_sorted_coo_bwd", "spmm_bwd_weighted_bf16_f3",
             "bf16:weighted"),
            ("block_spmm", "block_spmm_bf16_f128", "bf16"),
            ("block_spmm", "block_spmm_bf16_dense", "bf16"),
            ("block_spmm_bwd", "block_spmm_bwd_bf16_f136", "bf16"),
            ("block_spmm", "block_spmm_weighted_bf16_f128", "bf16:weighted"),
            ("block_spmm_bwd", "block_spmm_bwd_bf16_f3", "bf16"),
            ("block_spmm_bwd", "block_spmm_bwd_weighted_bf16_f128",
             "bf16:weighted"),
            ("segment_max", "segment_max_bf16_holes_f130", "bf16"),
            ("segment_max_bwd", "segment_max_bwd_holes_f128", "f32"),
            ("segment_max_bwd", "segment_max_bwd_op_bf16_holes_f130",
             "bf16")):
        fn = getattr(ops, op)
        before = fn.launches_by_dtype.get(key, 0)
        a, b = cases[case][0](), cases[case][0]()
        cases[case][1]()
        assert fn.launches_by_dtype[key] == before + 2, case
        assert torch.equal(a, b), case


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["spmm_sorted_coo", "block_spmm",
                                "segment_max"])
def test_streaming_autograd_through_kernels_on_card(cuda_device, op):
    """The autograd Functions on CUDA tensors: gradients (of x and of the
    weights) equal the plain versions' autograd, and the backward kernel
    runs once (segment max: its one launch on the forward's bounds, and no
    segment sum)."""
    rng = np.random.default_rng(12)
    if op == "spmm_sorted_coo":
        src, dst, perm, ssorted = _on(cuda_device, *_edge_list(rng, 60, 900))
        x, w = _on(cuda_device, rng.standard_normal((60, 64)).astype(
            np.float32), rng.random(len(src)).astype(np.float32))
        inputs = [x.requires_grad_(), w.requires_grad_()]
        kernel = lambda a, b: ops.spmm_sorted_coo(  # noqa: E731
            a, src, dst, b, 60, src_perm=perm, src_sorted=ssorted)
        plain = lambda a, b: ops.spmm_sorted_coo_plain(  # noqa: E731
            a, src, dst, b, 60)
        bwd = ops.spmm_sorted_coo_bwd
    elif op == "block_spmm":
        case = _streaming_cases(cuda_device)["block_spmm_weighted_f128"]
        xb, s_, d_, w_, e_, ts_, td_, tw_, tt_, bn = case[0].__defaults__[0]
        inputs = [xb.clone().requires_grad_(), w_.clone().requires_grad_()]
        kernel = lambda a, b: ops.block_spmm(  # noqa: E731
            a, s_, d_, b, e_, ts_, td_, tw_, tt_, bn)
        plain = lambda a, b: ops.block_spmm_plain(  # noqa: E731
            a, s_, d_, b, num_nodes=bn)
        bwd = ops.block_spmm_bwd
    else:
        ids = _hole_ids(rng, 60)
        x, ids_t = _on(cuda_device, (rng.integers(-4, 5, (len(ids), 32))
                                     / 2).astype(np.float32), ids)
        inputs = [x.requires_grad_()]
        kernel = lambda a: ops.segment_max(a, ids_t, 60)  # noqa: E731
        plain = lambda a: ops.segment_max_plain(a, ids_t, 60)  # noqa: E731
        bwd = ops.segment_max_bwd
    out = kernel(*inputs)
    g = torch.randn(out.shape, device=cuda_device)
    before, sums = bwd.launches, ops.segment_sum.launches
    got = torch.autograd.grad((out * g).sum(), inputs)
    assert bwd.launches == before + 1
    assert ops.segment_sum.launches == sums
    want = torch.autograd.grad((plain(*inputs) * g).sum(), inputs)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   **GRAD_TOL)


@pytest.mark.gpu
def test_streaming_kernels_refuse_on_card(cuda_device):
    ids = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    half = torch.zeros(16, 8, dtype=torch.float16, device=cuda_device)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ops.spmm_sorted_coo(half, ids, ids, None, 16)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ops.segment_max(half, ids, 4)
    x8 = torch.zeros(16, 8, device=cuda_device)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ops.segment_max_bwd(half, ids, half[:4], half[:4], 4)
    with pytest.raises(ValueError, match="g must be"):
        ops.segment_max_bwd(x8, ids, x8[:4], half[:4], 4)
    with pytest.raises(ValueError, match="out"):
        ops.segment_max_bwd(x8, ids, x8[:3], x8[:4], 4)
    x = torch.zeros(128, 8, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        ops.spmm_sorted_coo(x, ids.long(), ids, None, 16)
    est = torch.tensor([0, 16], dtype=torch.int32, device=cuda_device)
    # F 300 (once over the kernel's limit of 256): it launches, counted as
    # its tiled form, and every edge (0 -> 0) sums row 0 sixteen times
    (wide,) = _on(cuda_device, np.random.default_rng(8).standard_normal(
        (128, 300)).astype(np.float32))
    before = ops.block_spmm.launches
    tiled = ops.block_spmm.launches_by_dtype.get("f32:tiled", 0)
    got = ops.block_spmm(wide, ids, ids, None, est, ids, ids, None, est, 128)
    assert ops.block_spmm.launches == before + 1
    assert ops.block_spmm.launches_by_dtype["f32:tiled"] == tiled + 1
    np.testing.assert_allclose(
        got.cpu().numpy(), ops.block_spmm_plain(wide, ids, ids, None,
                                                num_nodes=128).cpu().numpy(),
        **GRAD_TOL)
    with pytest.raises(ValueError, match="128-row"):
        ops.block_spmm(x[:100], ids, ids, None, est, ids, ids, None, est,
                       100)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ops.block_spmm(torch.zeros(128, 8, dtype=torch.float16,
                                   device=cuda_device), ids, ids, None, est,
                       ids, ids, None, est, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["spmm", "block_spmm", "segment_max"])
def test_streaming_train_step_on_card(cuda_device, route, monkeypatch):
    """One Trainer step through the streaming kernels: molecules over 128
    atoms (sorted-COO SpMM, GIN and GCN), a bucket above the block-dense
    threshold (block-local SpMM), or the max readout; every parameter's
    gradient equals the same step with the plain versions."""
    from bignn_tpu_torch.config import TrainConfig
    from bignn_tpu_torch.data import make_synthetic_ddi, prepare_device_data
    from bignn_tpu_torch.models import BiGNN, BiGNNConfig
    from bignn_tpu_torch.sparse import formats as formats_mod
    from bignn_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    big = route == "spmm"
    if route == "block_spmm":
        monkeypatch.setattr(formats_mod, "BLOCK_DENSE_MAX_NODES", 0)
    data = prepare_device_data(make_synthetic_ddi(
        num_drugs=60, feat_dim=8, avg_degree=6.0, min_atoms=100 if big else 4,
        max_atoms=160 if big else 40, seed=0))
    inner = ("gin:16", "gcn:16")
    cfg = BiGNNConfig(feat_dim=8, inner_layers=inner,
                      readout="max" if route == "segment_max" else "sum",
                      outer_layers=("gat:16:2",), scorer="mlp:16")
    pairs = data.train_pairs[:32]
    mask = np.ones(32, np.float32)

    def step():
        trainer = Trainer(BiGNN(cfg), data, TrainConfig(), cuda_device)
        trainer.init(1)
        trainer.train_step(pairs, mask, 0, 0)
        return {k: p.grad.clone() for k, p in
                trainer.model.named_parameters()}

    kernels = {"spmm": (ops.spmm_sorted_coo, ops.spmm_sorted_coo_bwd),
               "block_spmm": (ops.block_spmm, ops.block_spmm_bwd),
               "segment_max": (ops.segment_max, ops.segment_max_bwd)}[route]
    before = [k.launches for k in kernels]
    got = step()
    assert all(k.launches > b for k, b in zip(kernels, before))
    with mock.patch.multiple(
            ops, segment_sum=ops.segment_sum_plain,
            block_adjacency=lambda s, d, w, e, n: ops.block_adjacency_plain(
                s, d, w, n),
            flash_gat_attention=ops.flash_gat_attention_plain,
            spmm_sorted_coo=ops.spmm_sorted_coo_plain,
            segment_max=ops.segment_max_plain):
        want = step()
    for name, g in got.items():
        scale = want[name].abs().max().item()
        np.testing.assert_allclose(g.cpu().numpy(), want[name].cpu().numpy(),
                                   rtol=2e-4, atol=2e-5 * max(scale, 1.0),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# all_to_all, the halo exchange of the edge-partitioned path: bit for bit
# against its plain version (a copy), at every route of the kernel's word
# (16 bytes for config5's 132-float payloads; 4, 2 and 1 bytes for chunks
# that are not multiples of 16)
# ---------------------------------------------------------------------------

A2A_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int32": torch.int32, "int8": torch.int8}
A2A_CASES = {
    **{f"g{g}_{t}": (g, t, 430, 132) for g in (1, 2, 4, 8)
       for t in ("f32", "bf16", "int32")},
    "g4_f32_narrow": (4, "f32", 5, 3),  # 60-byte chunks: 4-byte words
    "g4_bf16_narrow": (4, "bf16", 5, 3),  # 30 bytes: 2-byte words
    "g3_int8_odd": (3, "int8", 5, 3),  # 15 bytes: 1-byte words
    "g4_f32_empty": (4, "f32", 0, 132),  # S = 0: nothing to move
}


def _a2a_bufs(device, g, t, s, f, seed=0):
    gen = torch.Generator().manual_seed(seed)
    dtype = A2A_DTYPES[t]
    if dtype.is_floating_point:
        host = [torch.randn(g, s, f, generator=gen).to(dtype)
                for _ in range(g)]
    else:
        info = torch.iinfo(dtype)
        host = [torch.randint(info.min, info.max, (g, s, f), generator=gen,
                              dtype=dtype) for _ in range(g)]
    return [b.to(device) for b in host]


def test_all_to_all_plain_cases_run_on_cpu():
    for name, (g, t, s, f) in A2A_CASES.items():
        bufs = _a2a_bufs("cpu", g, t, s, f)
        got = ops.all_to_all(bufs)
        for j in range(g):
            for i in range(g):
                assert torch.equal(got[j][i], bufs[i][j]), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(A2A_CASES))
def test_all_to_all_matches_plain_on_card(cuda_device, case):
    g, t, s, f = A2A_CASES[case]
    bufs = _a2a_bufs(cuda_device, g, t, s, f)
    before = ops.all_to_all.launches_by_dtype.get(t, 0)
    got = ops.all_to_all(bufs)
    want = ops.all_to_all_plain(bufs)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.device == b.device and torch.equal(a, b), case
    launched = ops.all_to_all.launches_by_dtype.get(t, 0) - before
    assert launched == (1 if s else 0), case


@pytest.mark.gpu
@pytest.mark.parametrize("t", ["f32", "bf16"])
def test_all_to_all_backward_on_card(cuda_device, t):
    """The backward is the exchange of the cotangents (one more launch); an
    output without a cotangent sends zeros."""
    bufs = [b.requires_grad_() for b in _a2a_bufs(cuda_device, 4, t, 7, 33)]
    ct = _a2a_bufs(cuda_device, 4, t, 7, 33, seed=1)
    before = ops.all_to_all.launches_by_dtype.get(t, 0)
    out = ops.all_to_all(bufs)
    torch.autograd.backward(out[:3], ct[:3])
    torch.cuda.synchronize()
    assert ops.all_to_all.launches_by_dtype.get(t, 0) - before == 2
    want = ops.all_to_all_plain([*ct[:3], torch.zeros_like(ct[3])])
    for b, w in zip(bufs, want):
        assert torch.equal(b.grad, w)


# past the 32 shards whose pointers a launch takes by value: the launch's
# pointer table on the card (G, S, F)
A2A_MANY = {"g33": (33, 3, 5), "g64": (64, 2, 33), "g300": (300, 1, 4)}


@pytest.mark.gpu
def test_all_to_all_refuses_on_card(cuda_device):
    """Buffers on the card and on the CPU together raise; any number of
    shards runs (the name is kept from when more than 32 shards raised):
    G 33, 64 and 300 equal the plain version bit for bit, one launch each,
    forward and backward."""
    bufs = _a2a_bufs(cuda_device, 2, "f32", 3, 4)
    with pytest.raises(NotImplementedError):
        ops.all_to_all([bufs[0], bufs[1].cpu()])
    for name, (g, s, f) in A2A_MANY.items():
        many = [b.requires_grad_() for b in _a2a_bufs(cuda_device, g, "f32",
                                                      s, f)]
        ct = _a2a_bufs(cuda_device, g, "f32", s, f, seed=1)
        before = ops.all_to_all.launches_by_dtype.get("f32", 0)
        got = ops.all_to_all(many)
        torch.autograd.backward(got, ct)
        torch.cuda.synchronize()
        want = ops.all_to_all_plain([b.detach() for b in many])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        want_g = ops.all_to_all_plain(ct)
        assert all(torch.equal(b.grad, w) for b, w in zip(many, want_g)), name
        assert ops.all_to_all.launches_by_dtype.get("f32", 0) - before == 2


@pytest.mark.gpu
def test_all_to_all_many_shards_across_cards():
    """G 64 spread over the call's cards (16 a card on four): bit for bit
    against the plain version, forward and backward, one launch a card
    each way. Skips with fewer than two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from bignn_tpu_torch.parallel import spread_devices

    g, s, f = A2A_MANY["g64"]
    cards = [torch.device("cuda", i)
             for i in range(min(torch.cuda.device_count(), 4))]
    devices = spread_devices(g, cards)
    host = _a2a_bufs("cpu", g, "f32", s, f)
    ct = _a2a_bufs("cpu", g, "f32", s, f, seed=1)
    bufs = [b.to(d).requires_grad_() for b, d in zip(host, devices)]
    before = ops.all_to_all.launches_by_dtype.get("f32:cards", 0)
    out = ops.all_to_all(bufs)
    torch.autograd.backward(out, [c.to(d) for c, d in zip(ct, devices)])
    for d in set(devices):
        torch.cuda.synchronize(d)
    want, want_g = ops.all_to_all_plain(host), ops.all_to_all_plain(ct)
    for o, w, d in zip(out, want, devices):
        assert o.device == d and torch.equal(o.detach().cpu(), w)
    for b, w in zip(bufs, want_g):
        assert torch.equal(b.grad.cpu(), w)
    assert (ops.all_to_all.launches_by_dtype.get("f32:cards", 0) - before
            == 2 * len(set(devices)))


# across the cards of one process (a mesh over distinct cards): each card
# launches on its own destinations, reading peers' buffers through peer
# access; (G, S, F, shards a card): config5's (one a card), two a card
# (local and peer chunks in one launch), and a narrow bf16 payload
A2A_CARDS_CASES = {"config5": (4, "f32", 432, 132, 1),
                   "two_a_card": (8, "f32", 33, 132, 2),
                   "bf16_narrow": (4, "bf16", 5, 3, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(A2A_CARDS_CASES))
def test_all_to_all_across_cards_matches_plain(case):
    """Bit for bit against the plain version, forward and backward (the
    exchange of the cotangents); one launch a card each way, counted under
    ``:cards``. Skips with fewer than two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    g, t, s, f, per = A2A_CARDS_CASES[case]
    n_cards = min(torch.cuda.device_count(), g // per)
    devices = [torch.device("cuda", j * n_cards // g) for j in range(g)]
    host = _a2a_bufs("cpu", g, t, s, f)
    ct = _a2a_bufs("cpu", g, t, s, f, seed=1)
    bufs = [b.to(d).requires_grad_() for b, d in zip(host, devices)]
    key = t + ":cards"
    before = ops.all_to_all.launches_by_dtype.get(key, 0)
    out = ops.all_to_all(bufs)
    torch.autograd.backward(out, [c.to(d) for c, d in zip(ct, devices)])
    for d in set(devices):
        torch.cuda.synchronize(d)
    want = ops.all_to_all_plain(host)
    want_g = ops.all_to_all_plain(ct)
    for o, w, d in zip(out, want, devices):
        assert o.device == d and torch.equal(o.cpu(), w), case
    for b, w in zip(bufs, want_g):
        assert torch.equal(b.grad.cpu(), w), case
    assert (ops.all_to_all.launches_by_dtype.get(key, 0) - before
            == 2 * len(set(devices)))


# the send buffers of chip_smoke.py's M_SHAPES: (G, S, F) of config5 and
# config5-large, spread over up to 4 cards
A2A_M_SHAPES = {"config5": (4, 432, 132), "config5-large": (8, 12504, 132)}
A2A_BACK_TO_BACK = 200


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(A2A_M_SHAPES))
def test_all_to_all_across_cards_back_to_back(shape):
    """A2A_BACK_TO_BACK exchanges across the cards with no host
    synchronisation between them, each one's send buffers rewritten (on
    their own cards' streams) right after it returns: every result equal
    to the plain version exactly, checked on the cards as it lands. What
    keeps a card from rewriting a send buffer that a peer still reads is
    the kernel's drain (each card waits for every card's "done" before it
    exits). Skips with fewer than two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    g, s, f = A2A_M_SHAPES[shape]
    n_cards = min(torch.cuda.device_count(), 4)
    devices = [torch.device("cuda", j * n_cards // g) for j in range(g)]
    gen = torch.Generator().manual_seed(0)
    host = [torch.randn(g, s, f, generator=gen) for _ in range(g)]
    base = [h.to(d) for h, d in zip(host, devices)]
    # what destination j receives from every source, on j's card
    want = [torch.stack([h[j] for h in host]).to(d)
            for j, d in enumerate(devices)]
    send = [b.clone() for b in base]
    bad = [torch.zeros((), dtype=torch.int64, device=d) for d in devices]
    before = ops.all_to_all.launches_by_dtype.get("f32:cards", 0)
    for t in range(A2A_BACK_TO_BACK):
        got = ops.all_to_all(send)
        for b, x in zip(base, send):
            torch.add(b, t + 1, out=x)
        for j, r in enumerate(got):
            bad[j] += (r != want[j] + t).sum()
    for d in set(devices):
        torch.cuda.synchronize(d)
    assert [int(x) for x in bad] == [0] * g
    assert (ops.all_to_all.launches_by_dtype.get("f32:cards", 0) - before
            == A2A_BACK_TO_BACK * len(set(devices)))


@pytest.mark.gpu
def test_all_to_all_missing_peer_raises_within_its_limit():
    """A launch of the kernel with the semaphores on the cards whose peer
    never launches, built through ``DeviceBarrier`` with a limit of 0.5 s:
    the card is free again within the limit (plus a second for the launch
    and the synchronisation), the next check raises, naming the card it
    waited on, and the chunk it did not copy is NaN. The peer's signal area lies on a second card where there
    is one, else beside this card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    import ctypes
    import time

    from bignn_tpu_torch.ops import collectives, cuda_lib

    cards = [torch.device("cuda", i) for i in range(
        min(torch.cuda.device_count(), 2))]
    collectives.enable_peer_access(cards)
    areas = []
    for q in range(2):
        ptr = ctypes.c_void_p()
        size = collectives.signal_bytes(2)
        cuda_lib.call("bignn_ipc_alloc", cards[q % len(cards)], size, size,
                      ctypes.byref(ptr))
        areas.append(ptr.value)
    barrier = collectives.DeviceBarrier(cards[:1], [0], [areas],
                                        ["cuda:0", "the peer card"],
                                        timeout_s=0.5)
    bufs = _a2a_bufs(cards[0], 2, "f32", 432, 132)
    recv = torch.empty_like(bufs[0])
    torch.cuda.synchronize(cards[0])
    t0 = time.perf_counter()
    barrier.launch([[b.data_ptr() for b in bufs]], [recv.data_ptr(), 0],
                   [0, 1], 432 * 132 * 4)
    torch.cuda.synchronize(cards[0])
    secs = time.perf_counter() - t0
    assert 0.4 < secs < 1.5, secs
    with pytest.raises(RuntimeError, match="all_to_all on cuda:0 waited "
                       "past 0.5 s for the peer card to arrive"):
        barrier.check()
    assert torch.equal(recv[0], bufs[0][0])  # the local pair was copied
    assert torch.isnan(recv[1]).all()  # the peer's was not
    with pytest.raises(RuntimeError, match="the peer card"):
        barrier.close()
    for q, ptr in enumerate(areas):
        cuda_lib.call("bignn_ipc_free", cards[q % len(cards)], ptr)


# ---------------------------------------------------------------------------
# segment sum: the row widths, alignments and id layouts of csrc/segment_sum.cu
# ---------------------------------------------------------------------------

SEGSUM_WIDTHS = (1, 3, 4, 8, 9, 128, 130, 256)
# name -> (ids, F, type, permuted form, offset of the data's first row):
# the word each width is read in (16, 8, 4 or 2 bytes) and the sweeps of
# rows wider than 32 words; a base off 16 bytes ("row": a view one row in,
# "value": one value in); one segment of 100,000 rows among short ones;
# few segments of ~33 rows (several warps a segment); unsorted ids with
# out-of-range and empty segments; E = 0.
SEGSUM_SPECS = {
    **{f"w{f}_{t}{'_perm' if p else ''}": ("holes" if not p else "edges",
                                          f, t, p, None)
       for f in SEGSUM_WIDTHS for t in ("f32", "bf16") for p in (False,
                                                                 True)},
    **{f"unaligned_w{f}_{t}": ("holes", f, t, False, "row")
       for f in (3, 9) for t in ("f32", "bf16")},
    "unaligned_value_w4_f32": ("holes", 4, "f32", False, "value"),
    "unaligned_value_w4_f32_perm": ("edges", 4, "f32", True, "value"),
    "unaligned_value_w8_bf16": ("holes", 8, "bf16", False, "value"),
    "long_w4_f32": ("long", 4, "f32", False, None),
    "long_w4_f32_perm": ("long", 4, "f32", True, None),
    "long_w128_f32": ("long", 128, "f32", False, None),
    "long_w128_bf16": ("long", 128, "bf16", False, None),
    "molecules_w128_f32": ("molecules", 128, "f32", False, None),
    "molecules_w128_bf16": ("molecules", 128, "bf16", False, None),
    "unsorted_w4_f32": ("unsorted", 4, "f32", False, None),
    "unsorted_w4_f32_perm": ("unsorted", 4, "f32", True, None),
    "unsorted_w128_f32": ("unsorted", 128, "f32", False, None),
    "unsorted_w16_bf16": ("unsorted", 16, "bf16", False, None),
    "empty_rows_w8_f32": ("empty", 8, "f32", False, None),
    "empty_rows_w4_bf16_perm": ("empty", 4, "bf16", True, None),
}
SEGSUM_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _segsum_ids(rng, kind):
    """``(ids, num_segments)`` of one id layout."""
    if kind == "holes":
        return _hole_ids(rng, 60), 60
    if kind == "edges":  # a gather's indices: any order, 30 padding rows
        return np.concatenate([rng.integers(0, 40, 400),
                               np.full(30, 40)]).astype(np.int32), 40
    if kind == "long":  # segment 20 has 100,000 rows, padding runs between
        parts = []
        for s in range(50):
            parts.append(np.full(100_000 if s == 20 else rng.integers(1, 40),
                                 s))
            if rng.random() < 0.5:
                parts.append(np.full(rng.integers(1, 20), 50))
        return np.concatenate(parts).astype(np.int32), 50
    if kind == "molecules":  # config2's readout: 40 of ~33 atoms, padding
        parts = []
        for s in range(40):
            parts.append(np.full(rng.integers(20, 46), s))
            parts.append(np.full(rng.integers(0, 30), 40))
        return np.concatenate(parts).astype(np.int32), 40
    if kind == "unsorted":  # 45-49 empty; -1, 50 and 57 dropped
        return rng.permutation(np.concatenate([
            rng.integers(0, 45, 600), np.full(5, -1), np.full(5, 50),
            np.full(5, 57)])).astype(np.int32), 50
    assert kind == "empty"
    return np.zeros(0, np.int32), 30


def _segsum_case(device, name):
    """(kernel call, plain call) of one ``SEGSUM_SPECS`` case. The long
    segment's data are small integers, so that any order of the sums is
    exact (100,000 normal values summed in two orders can differ by more
    than the f32 tolerance); the others are normal."""
    kind, feat, t, permuted, offset = SEGSUM_SPECS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    ids, n = _segsum_ids(rng, kind)
    e = len(ids)
    flat = (rng.integers(-4, 5, (e + 1) * feat) if kind == "long" else
            rng.standard_normal((e + 1) * feat)).astype(np.float32)
    x = torch.from_numpy(flat).to(device).to(SEGSUM_TYPES[t])
    start = {None: 0, "row": feat, "value": 1}[offset]
    x = x[start:start + e * feat].view(e, feat)
    (ids_t,) = _on(device, ids)
    if not permuted:
        return (lambda: ops.segment_sum(x, ids_t, n),
                lambda: ops.segment_sum_plain(x, ids_t, n))
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    perm_t, sorted_t = _on(device, perm, ids[perm])
    args = (x, ids_t, n, perm_t, sorted_t)
    return (lambda: ops.gather_rows_sorted_grad_bwd(*args),
            lambda: ops.gather_rows_sorted_grad_bwd_plain(*args))


def test_segsum_plain_cases_run_on_cpu():
    """On CPU tensors every case takes the plain version (same bits, the
    data's type, zeros for empty segments) and counts no launch."""
    counted = (ops.segment_sum, ops.gather_rows_sorted_grad_bwd)
    before = [k.launches for k in counted]
    for name, (kind, feat, t, _, _) in SEGSUM_SPECS.items():
        kernel, plain = _segsum_case("cpu", name)
        got, want = kernel(), plain()
        assert torch.equal(got, want), name
        assert got.dtype == SEGSUM_TYPES[t] and got.shape[1] == feat, name
        if kind == "unsorted":
            assert not got[45:].any(), name
    assert [k.launches for k in counted] == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SEGSUM_SPECS))
def test_segment_sum_kernel_matches_plain_on_card(cuda_device, case):
    kernel, plain = _segsum_case(cuda_device, case)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape, case
    tol = TOL if SEGSUM_SPECS[case][2] == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol,
                               err_msg=case)


@pytest.mark.gpu
def test_segment_sum_repeats_bit_for_bit_on_card(cuda_device):
    """No float atomics and a fixed order: two launches give the same bits,
    with one warp a segment, with several (few segments, one long one),
    and in the permuted form; each counts one launch."""
    for name in ("molecules_w128_f32", "molecules_w128_bf16", "w4_f32_perm",
                 "w130_bf16", "unsorted_w128_f32", "long_w4_f32_perm"):
        kernel, _ = _segsum_case(cuda_device, name)
        op = (ops.gather_rows_sorted_grad_bwd if name.endswith("_perm")
              else ops.segment_sum)
        before = op.launches
        a, b = kernel(), kernel()
        assert op.launches == before + 2, name
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["holes", "edges", "long", "unsorted",
                                  "empty", "sorted"])
def test_segment_bounds_on_card(cuda_device, kind):
    """The bounds pass's atomics only at the ends of runs give each
    segment's first and last row exactly, for sorted, holed and unsorted
    ids: the scratch ``segment_sum_launch`` passes in, read back."""
    rng = np.random.default_rng(5)
    ids, n = _segsum_ids(rng, "edges" if kind == "sorted" else kind)
    if kind == "sorted":
        ids = np.sort(ids)
    (ids_t,) = _on(cuda_device, ids)
    first = torch.full((n,), 7, dtype=torch.int32, device=cuda_device)
    last = torch.full((n,), 7, dtype=torch.int32, device=cuda_device)
    x = torch.ones(len(ids), 1, device=cuda_device)
    segment_sum_launch(x, ids_t, n, bounds=(first, last))
    want_first, want_last = segment_bounds_plain(ids_t, n)
    torch.cuda.synchronize()
    assert torch.equal(first, want_first), kind
    assert torch.equal(last, want_last), kind


# ---------------------------------------------------------------------------
# block adjacency (csrc/block_adj.cu) and the flash-GAT backward
# (csrc/flash_gat_bwd.cu): the layouts and shapes of their tiles
# ---------------------------------------------------------------------------

FLASH_BWD_TOL = 1e-4  # x max(1, max |plain|), chip_smoke.BWD_TOL
# name -> (edge layout, output type, weighted)
ADJ_SPECS = {
    **{f"molecules_{t}": ("molecules", dt, False) for t, dt in (
        ("int8", torch.int8), ("int16", torch.int16),
        ("f32", torch.float32), ("bf16", torch.bfloat16))},
    "molecules_f32_weighted": ("molecules", torch.float32, True),
    "molecules_bf16_weighted": ("molecules", torch.bfloat16, True),
    "one_row_int8": ("one_row", torch.int8, False),
    "one_row_f32": ("one_row", torch.float32, False),
    "one_row_f32_weighted": ("one_row", torch.float32, True),
    "unsorted_int16": ("unsorted", torch.int16, False),
    "unsorted_f32_weighted": ("unsorted", torch.float32, True),
}
# name -> (N, H, D, slope): config2's shape, an N no tile divides, config2's
# H 8 / D 64 attention at slope 0.1, a head_dim staged 4 bytes at a time
FLASH_BWD_SPECS = {
    "n1704_h4_d32": (1704, 4, 32, 0.2),
    "n1001_h4_d32": (1001, 4, 32, 0.2),
    "n300_h8_d64_slope01": (300, 8, 64, 0.1),
    "n130_h2_d5": (130, 2, 5, 0.2),
}


def _molecule_edges(rng, kind, nblk=5):
    """``(src, dst, estarts, n)``: block-local edges laid out as a bucket
    lays them out. ``molecules``: molecules of 8-40 atoms packed into
    128-row blocks, each one's edges dst-sorted with one (d, s) pair up to
    16 times (config4's r_node**2), and after most molecules a run of
    padding edges (dst == n, src 0) inside the block's range (ROADMAP F1);
    block 2 has no edges. ``one_row``: block 1 holds 2,048 edges, all on
    row 5 (each of its 128 sources 16 times), then a padding run.
    ``unsorted``: the molecules' edges shuffled within each block's range,
    so that every row's run holds other rows' edges and padding."""
    n = nblk * 128
    blocks = []
    for b in range(nblk):
        row0 = b * 128
        if kind == "one_row" and b == 1:
            s = rng.permutation(np.repeat(np.arange(128) + row0, 16))
            blocks.append((np.concatenate([s, np.zeros(7)]),
                           np.concatenate([np.full(len(s), row0 + 5),
                                           np.full(7, n)])))
            continue
        bs, bd = [], []
        row = 0
        while b != 2:
            size = int(rng.integers(8, 41))
            if row + size > 128:
                break
            atoms = row0 + row + np.arange(size)
            m = int(rng.integers(2 * size, 5 * size))
            k = 16 if row == 0 else int(rng.integers(2, 17))
            es, ed = rng.choice(atoms, m), rng.choice(atoms, m)
            other = (es != atoms[0]) | (ed != atoms[1])  # the pair: k times
            es = np.concatenate([es[other], np.full(k, atoms[0])])
            ed = np.concatenate([ed[other], np.full(k, atoms[1])])
            order = np.argsort(ed, kind="stable")
            bs += [es[order]]
            bd += [ed[order]]
            if rng.random() < 0.7:
                pad = int(rng.integers(1, 20))
                bs += [np.zeros(pad)]
                bd += [np.full(pad, n)]
            row += size
        bs, bd = np.concatenate(bs or [[]]), np.concatenate(bd or [[]])
        if kind == "unsorted":
            order = rng.permutation(len(bs))
            bs, bd = bs[order], bd[order]
        blocks.append((bs, bd))
    src = np.concatenate([bs for bs, _ in blocks]).astype(np.int32)
    dst = np.concatenate([bd for _, bd in blocks]).astype(np.int32)
    estarts = np.cumsum([0] + [len(bs) for bs, _ in blocks]).astype(np.int32)
    return src, dst, estarts, n


def _adj_case(device, name, edge_order=False):
    """(kernel call, plain call) of one ``ADJ_SPECS`` case; weights in
    (0, 1], zero on padding edges. ``edge_order``: also the blocks summed
    cell by cell in edge order in float32 (``np.add.at``, sequential), the
    order the kernel keeps, in the case's type."""
    kind, dtype, weighted = ADJ_SPECS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    src, dst, estarts, n = _molecule_edges(rng, kind)
    w = np.where(dst < n, 1.0 - rng.random(len(src)), 0).astype(np.float32)
    src_t, dst_t, est_t, w_t = _on(device, src, dst, estarts, w)
    w_t = w_t if weighted else None
    calls = (lambda: ops.block_adjacency(src_t, dst_t, w_t, est_t, n, dtype),
             lambda: ops.block_adjacency_plain(src_t, dst_t, w_t, n, dtype))
    if not edge_order:
        return calls
    if not weighted:
        w = np.ones_like(w)
    elif dtype == torch.bfloat16:
        w = torch.from_numpy(w).to(dtype).float().numpy()
    b, s_l = dst // 128, src - (dst // 128) * 128
    keep = (dst < n) & (s_l >= 0) & (s_l < 128)
    ref = np.zeros(n * 128, np.float32)
    np.add.at(ref, (dst * 128 + s_l)[keep], w[keep])
    ref = torch.from_numpy(ref.reshape(n // 128, 128, 128)).to(dtype)
    return (*calls, ref)


def _flash_bwd_case(device, name):
    """(kernel call, plain call) of one ``FLASH_BWD_SPECS`` case: a mask of
    density 4.5 % (config2's outer graph) with multiplicities 2, in which
    destination 7 and source 11 have no edges; lse and out from the plain
    forward; a normal cotangent."""
    n, heads, head_dim, slope = FLASH_BWD_SPECS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    cnt = (rng.random((n, n)) < 0.045).astype(np.float32)
    cnt += rng.random((n, n)) < 0.005
    cnt[7] = 0.0
    cnt[:, 11] = 0.0
    sl, sr, v, g = (rng.standard_normal(shape).astype(np.float32)
                    for shape in ((n, heads), (n, heads),
                                  (n, heads, head_dim), (n, heads, head_dim)))
    sl, sr, v, cnt, g = _on(device, sl, sr, v, cnt, g)
    out, lse = ops.flash_gat_attention_plain(sl, sr, v, cnt, slope)
    args = (sl, sr, v, cnt, lse, out, g, slope)
    return (lambda: ops.flash_gat_attention_bwd(*args),
            lambda: ops.flash_gat_attention_bwd_plain(*args))


def test_adj_and_flash_bwd_plain_cases_run_on_cpu():
    """On CPU tensors every case takes the plain version and counts no
    launch; the layouts hold what their names say: int8 counts reach 16,
    the one-row block's 2,048 edges all land on row 5, block 2 is empty,
    padding adds nothing; the flash cases' empty destination and source
    get zero gradients."""
    counted = (ops.block_adjacency, ops.flash_gat_attention_bwd)
    before = [k.launches for k in counted]
    for name, (kind, dtype, weighted) in ADJ_SPECS.items():
        kernel, plain, ref = _adj_case("cpu", name, edge_order=True)
        got, want = kernel(), plain()
        assert torch.equal(got, want) and got.dtype == dtype, name
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                   **(BF16_TOL if dtype == torch.bfloat16
                                      else TOL), err_msg=name)
        assert not got[2].float().any(), name
        if kind == "one_row":
            assert got[1, 5].float().sum() > 0 and not got[1, :5].any()
            assert not weighted or got[1, 5].sum() > 100, name
            if not weighted:
                assert got[1, 5].float().sum() == 2048, name
        if not weighted and dtype == torch.int8:
            assert int(got.max()) == 16, name
    for name in FLASH_BWD_SPECS:
        if name == "n1704_h4_d32":
            continue  # the plain version at config2's N is for the card
        kernel, plain = _flash_bwd_case("cpu", name)
        (dsl, dsr, dv), want = kernel(), plain()
        assert all(torch.equal(a, b) for a, b in zip((dsl, dsr, dv), want))
        assert not dsl[7].any() and not dsr[11].any() and not dv[11].any()
        assert bool(torch.isfinite(dv).all()) and dsl.abs().max() > 0, name
    assert [k.launches for k in counted] == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ADJ_SPECS))
def test_block_adjacency_layouts_match_plain_on_card(cuda_device, case):
    """Counts exactly. Weights: each cell summed in edge order, so bit for
    bit the sequential float32 sum of its edges (rounded once to bf16 in
    the bf16 form), and within TOL (bf16: one rounding) of the plain
    version, whose float atomics sum in another order."""
    kernel, plain, ref = _adj_case(cuda_device, case, edge_order=True)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape, case
    if not ADJ_SPECS[case][2]:
        assert torch.equal(got, want), case
        return
    assert torch.equal(got.cpu(), ref), case
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(),
        **(TOL if got.dtype == torch.float32 else BF16_TOL), err_msg=case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FLASH_BWD_SPECS))
def test_flash_gat_bwd_shapes_match_plain_on_card(cuda_device, case):
    """Each output within FLASH_BWD_TOL x max(1, max |plain|), as
    chip_smoke.py holds the kernel; the empty destination and source get
    exact zeros."""
    kernel, plain = _flash_bwd_case(cuda_device, case)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape, case
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= FLASH_BWD_TOL * scale, case
    dsl, dsr, dv = got
    assert not dsl[7].any() and not dsr[11].any() and not dv[11].any()


@pytest.mark.gpu
def test_adj_and_flash_bwd_repeat_bit_for_bit_on_card(cuda_device):
    """No float atomics and sums in a fixed order: two launches give the
    same bits, the weighted block sums and the flash backward's split sweep
    included; each counts one launch."""
    for name in ("molecules_int8", "molecules_f32", "unsorted_f32_weighted",
                 "molecules_bf16_weighted", "one_row_f32_weighted"):
        kernel, _ = _adj_case(cuda_device, name)
        before = ops.block_adjacency.launches
        a, b = kernel(), kernel()
        assert ops.block_adjacency.launches == before + 2, name
        assert torch.equal(a, b), name
    for name in ("n1704_h4_d32", "n130_h2_d5"):
        kernel, _ = _flash_bwd_case(cuda_device, name)
        before = ops.flash_gat_attention_bwd.launches
        a, b = kernel(), kernel()
        assert ops.flash_gat_attention_bwd.launches == before + 2, name
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name


# ---------------------------------------------------------------------------
# The sorted-COO SpMM's long rows (csrc/spmm.cu cuts a row that spans many
# positions into pieces over the whole card) and the weighted bf16 SpMMs'
# two roundings (rows 6 and 7)
# ---------------------------------------------------------------------------

# csrc/spmm.cu: with fewer than 128 x 4,096 positions a row spanning more
# than 128 positions is long; a piece is 64 positions for each slot of a
# block of 8 warps: 512 for rows of 32 words (f32 F 128), 1,024 for rows of
# 16 (bf16 F 128, f32 F 64)
SPMM_LONG_MIN = 128
# spans that meet the split's edges: at the threshold, one past it, one
# piece less one, one piece, one piece and one (a boundary right before the
# last position), two pieces and one, four pieces and one
SPAN_LENGTHS = (128, 129, 511, 512, 513, 1023, 1024, 1025, 2049, 4097)


def _gin_split(rng, b=48, n_halo=96, e=3000, pad=200, halo_share=0.7):
    """``dist_gin_apply``'s two SpMMs on a shard as parallel/halo.py builds
    them: ``(src, dst, weight, num_x, src_perm, src_sorted)`` of the
    owned-source SpMM (every halo source clamped to row b - 1, weight 0)
    and of the halo-source one (every owned source and the padding edges'
    source 0 on halo row 0, weight 0); dst-sorted over b rows, padding
    edges (src 0, dst b) last; the plan's one source sort serves both."""
    ext = np.where(rng.random(e) < halo_share, rng.integers(b, b + n_halo, e),
                   rng.integers(0, b, e))
    dst = np.sort(rng.integers(0, b, e))
    src = np.concatenate([ext, np.zeros(pad)]).astype(np.int32)
    dst = np.concatenate([dst, np.full(pad, b)]).astype(np.int32)
    perm = np.argsort(src, kind="stable").astype(np.int32)
    srt = src[perm]
    w_loc = (src < b).astype(np.float32)
    return [(np.minimum(src, b - 1), dst, w_loc, b, perm,
             np.minimum(srt, b - 1)),
            (np.clip(src - b, 0, n_halo - 1), dst, 1.0 - w_loc, n_halo, perm,
             np.clip(srt - b, 0, n_halo - 1))]


def _runs_layout(rng, lengths, n_out, hole_at=()):
    """Dst-sorted edges whose destination rows span ``lengths`` positions,
    each long one after three short rows of 1-4 edges and an empty row;
    inside each long row's span, 5 padding edges (dst = n_out) from each
    offset of ``hole_at`` that leaves its last position its own (holes,
    ROADMAP F1), and 50 padding edges last."""
    dst, row = [], 0
    for n in lengths:
        for _ in range(3):
            dst += [row] * int(rng.integers(1, 5))
            row += 1
        row += 1  # an empty row
        run = [row] * n
        for off in hole_at:
            if 0 < off and off + 5 < n:
                run[off:off + 5] = [n_out] * 5
        dst += run
        row += 1
    assert row < n_out
    dst = np.array(dst + [n_out] * 50, np.int32)
    return dst, row


def _long_layout(name, rng):
    """``(src, dst, weight, num_x, num_out, src_perm, src_sorted)`` of one
    ``SPMM_LONG_SPECS`` layout."""
    if name.startswith("gin"):
        lay = _gin_split(rng)[0 if name == "gin_local" else 1]
        src, dst, w, num_x, perm, srt = lay
        return src, dst, w, num_x, 48, perm, srt
    n_out = 400
    if name == "lengths":
        dst, _ = _runs_layout(rng, SPAN_LENGTHS, n_out, hole_at=(1, 511))
    else:  # a destination hub: 60 % of the edges on row 4, with holes
        dst, row = _runs_layout(rng, (2400,), n_out, hole_at=(511, 512, 1023))
        rest = np.sort(rng.integers(row + 1, n_out - 8, 1500))
        dst = np.concatenate([dst[:-50], rest, dst[-50:]]).astype(np.int32)
        if name == "unsorted_hub":  # any order: spans overlap
            dst = dst[rng.permutation(len(dst))]
    num_x = 300
    src = rng.integers(0, num_x, len(dst)).astype(np.int32)
    w = (1.0 - rng.random(len(dst))).astype(np.float32)
    perm = np.argsort(src, kind="stable").astype(np.int32)
    return src, dst, w, num_x, n_out, perm, src[perm]


# name -> (layout, dtype, F, weighted, x off 16 bytes): the GIN split's
# source hubs with its 0/1 weights; a destination hub with holes, also as
# views off 16 bytes (single values, four sweeps of 32) and in any order;
# spans at the split's edges, in both types and at F 64 (16 lanes a row)
SPMM_LONG_SPECS = {
    "gin_local_f32": ("gin_local", torch.float32, 128, True, False),
    "gin_halo_f32": ("gin_halo", torch.float32, 128, True, False),
    "gin_local_bf16": ("gin_local", torch.bfloat16, 128, True, False),
    "dst_hub_f32": ("dst_hub", torch.float32, 128, True, False),
    "dst_hub_bf16": ("dst_hub", torch.bfloat16, 128, False, False),
    "dst_hub_f32_unaligned": ("dst_hub", torch.float32, 128, True, True),
    "dst_hub_bf16_unaligned": ("dst_hub", torch.bfloat16, 128, True, True),
    "unsorted_hub_f32": ("unsorted_hub", torch.float32, 128, True, False),
    "lengths_f32": ("lengths", torch.float32, 128, False, False),
    "lengths_f32_f64_weighted": ("lengths", torch.float32, 64, True, False),
    "lengths_bf16": ("lengths", torch.bfloat16, 128, True, False),
}


def _long_case(device, name):
    """``(forward, plain forward, backward, plain backward, layout)`` of
    one ``SPMM_LONG_SPECS`` case: x and the cotangent normal, in the case's
    type."""
    kind, dtype, feat, weighted, off = SPMM_LONG_SPECS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    lay = _long_layout(kind, rng)
    src, dst, w, num_x, n_out, perm, srt = lay
    x = rng.standard_normal((num_x, feat)).astype(np.float32)
    g = rng.standard_normal((n_out, feat)).astype(np.float32)
    src_t, dst_t, w_t, perm_t, srt_t, x_t, g_t = _on(device, src, dst, w,
                                                     perm, srt, x, g)
    x_t, g_t = x_t.to(dtype), g_t.to(dtype)
    if off:
        x_t, g_t = _off16(x_t), _off16(g_t)
    w_t = w_t if weighted else None
    fwd = (x_t, src_t, dst_t, w_t, n_out)
    bwd = (g_t, src_t, dst_t, w_t, num_x, perm_t, srt_t)
    return (lambda: ops.spmm_sorted_coo(*fwd),
            lambda: ops.spmm_sorted_coo_plain(*fwd),
            lambda: ops.spmm_sorted_coo_bwd(*bwd),
            lambda: ops.spmm_sorted_coo_bwd_plain(*bwd[:5]), lay)


def _assert_close_scaled(got, want, dtype, name):
    """f32: sums of up to ~2,400 terms in another order, within 1e-5 of
    the value and of max(1, max |plain|); bf16: both round one float32 sum
    once, so within a bf16 step (rtol 1e-2) of the value, and 1e-4 of the
    scale for the float32 sums' own order."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    rtol, atol = (1e-5, 1e-5 * scale) if dtype == torch.float32 else (
        1e-2, 1e-4 * scale)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def test_spmm_long_layouts_hold_their_shape():
    """The layouts are what the cases say: the GIN split's owned-source
    order holds a hub row with at least half the edges, the halo-source
    order one with the other part and the padding, both with 0/1
    weights; the
    destination hub holds 60 % of its edges with holes inside its run;
    the lengths layout has rows of every span in SPAN_LENGTHS, empty rows
    and holes; the unsorted hub's dst is in no order."""
    rng = np.random.default_rng(0)
    for lay, share in zip(_gin_split(rng), (0.5, 0.25)):
        src, dst, w, num_x, perm, srt = lay
        assert np.bincount(srt).max() >= share * len(src)
        assert set(np.unique(w)) == {0.0, 1.0}
        assert np.all(np.diff(srt) >= 0)
        assert np.array_equal(np.sort(src[perm]), srt) or np.all(
            src[perm] == srt)
    for kind in ("dst_hub", "lengths", "unsorted_hub"):
        src, dst, w, num_x, n_out, perm, srt = _long_layout(
            kind, np.random.default_rng(1))
        valid = dst[dst < n_out]
        counts = np.bincount(valid, minlength=n_out)
        first = np.full(n_out, len(dst))
        last = np.full(n_out, -1)
        for i, d in enumerate(dst):
            if d < n_out:
                first[d], last[d] = min(first[d], i), i
        spans = np.where(counts > 0, last - first + 1, 0)
        assert (counts == 0).sum() > 0  # empty rows
        if kind == "dst_hub":
            assert counts.max() >= 0.6 * len(valid)
            assert spans.max() > counts.max()  # holes inside its run
        elif kind == "lengths":
            assert set(SPAN_LENGTHS) <= set(spans.tolist())
        else:
            assert np.any(np.diff(dst) < 0)


@pytest.mark.parametrize("case", sorted(SPMM_LONG_SPECS))
def test_spmm_long_plain_cases_run_on_cpu(case):
    """On CPU tensors both directions take the plain versions, count no
    launch and give what the plain calls give."""
    fwd, fwd_p, bwd, bwd_p, _ = _long_case("cpu", case)
    before = (ops.spmm_sorted_coo.launches, ops.spmm_sorted_coo_bwd.launches)
    assert torch.equal(fwd(), fwd_p()), case
    assert torch.equal(bwd(), bwd_p()), case
    assert (ops.spmm_sorted_coo.launches,
            ops.spmm_sorted_coo_bwd.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SPMM_LONG_SPECS))
def test_spmm_long_rows_match_plain_on_card(cuda_device, case):
    """Both directions against their plain versions where rows span up to
    2,400 positions: the hub rows' pieces and their partial sums, spans at
    the split's edges, holes inside a long run, empty rows, views off 16
    bytes, dst in any order."""
    fwd, fwd_p, bwd, bwd_p, _ = _long_case(cuda_device, case)
    dtype = SPMM_LONG_SPECS[case][1]
    for kernel, plain, tag in ((fwd, fwd_p, "fwd"), (bwd, bwd_p, "bwd")):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        _assert_close_scaled(got, want, dtype, f"{case} {tag}")


@pytest.mark.gpu
def test_spmm_long_rows_repeat_bit_for_bit_on_card(cuda_device):
    """The pieces' partial sums are added in piece order by whichever
    block completes a row last: two calls give the same bits."""
    for case in ("gin_local_f32", "gin_halo_f32", "gin_local_bf16",
                 "lengths_bf16", "dst_hub_f32_unaligned"):
        fwd, _, bwd, _, _ = _long_case(cuda_device, case)
        for call in (fwd, bwd):
            a, b = call(), call()
            torch.cuda.synchronize()
            assert torch.equal(a, b), case


def _cancel_layout(nblk=3, feat=64, seed=0):
    """Block-local edges whose weighted bf16 messages cancel exactly when
    the weight and each message are rounded to bf16 before the float32
    sum (JAX ``ops/pallas/block_spmm.py:142-144``, ``ops/pallas/spmm.py:55,
    :97``): row d < 64 of each block takes an edge from source row d
    (values a in [1, 2), weight w + 3 * 2**-10, which rounds to w in
    bf16) and one from source row 64 + d (values -bf16(w a), weight 1);
    rows 64-127 take none. Rounded as the kernels must round, every output
    is 0; a sum of unrounded products leaves nearly all of the first 64
    rows' outputs nonzero, and products of the unrounded weight over a
    third of them.
    Returns ``(x, src, dst, weight, estarts, n)`` as numpy, x bf16 values
    in float32."""
    rng = np.random.default_rng(seed)
    n = nblk * 128
    bf = torch.bfloat16
    a = torch.from_numpy(1 + rng.random((n, feat)).astype(np.float32)).to(bf)
    # bf16 weights of (1, 2): w a is rarely a bf16 value
    w = (1 + rng.integers(1, 128, n) / 128).astype(np.float32)
    w_bf = torch.from_numpy(w).to(bf)
    x = a.float().numpy().copy()
    src, dst, wt = [], [], []
    for b in range(nblk):
        r0 = b * 128
        for d in range(64):
            x[r0 + 64 + d] = -(a[r0 + d] * w_bf[r0 + d]).float().numpy()
            src += [r0 + d, r0 + 64 + d]
            dst += [r0 + d, r0 + d]
            wt += [w[r0 + d] + 3 * 2.0 ** -10, 1.0]
    src, dst = np.array(src, np.int32), np.array(dst, np.int32)
    wt = np.array(wt, np.float32)
    estarts = np.searchsorted(dst, np.arange(0, n + 1, 128)).astype(np.int32)
    return x, src, dst, wt, estarts, n


def _cancel_calls(device):
    """name -> (kernel call, plain call) over ``_cancel_layout``: the block
    SpMM forward and its backward entry (the same sum over the plan it is
    given), the sorted-COO forward, and its backward over the same edges
    with src and dst swapped."""
    x, src, dst, wt, estarts, n = _cancel_layout()
    x_t, s, d, w, est = _on(device, x, src, dst, wt, estarts)
    x_t = x_t.to(torch.bfloat16)
    perm = torch.argsort(d.long(), stable=True).to(torch.int32)
    blk = (x_t, s, d, w, est, s, d, w, est, n)
    return {
        "block_spmm": (lambda: ops.block_spmm(*blk),
                       lambda: ops.block_spmm_plain(x_t, s, d, w,
                                                    num_nodes=n)),
        "block_spmm_bwd": (lambda: ops.block_spmm_bwd(x_t, s, d, w, est, n),
                           lambda: ops.block_spmm_plain(x_t, s, d, w,
                                                        num_nodes=n)),
        "spmm_sorted_coo": (lambda: ops.spmm_sorted_coo(x_t, s, d, w, n),
                            lambda: ops.spmm_sorted_coo_plain(x_t, s, d, w,
                                                              n)),
        "spmm_sorted_coo_bwd": (
            lambda: ops.spmm_sorted_coo_bwd(x_t, d, s, w, n, perm, d[perm]),
            lambda: ops.spmm_sorted_coo_bwd_plain(x_t, d, s, w, n)),
    }


def test_bf16_roundings_cancel_layout_on_cpu():
    """The layout does what ``_cancel_layout`` says, checked on the CPU:
    the plain versions (bf16 weight, bf16 messages, float32 sums) give
    exact zeros, and so do the kernels' calls on CPU tensors; the same sum
    of unrounded products, or of products of the unrounded weights rounded
    to bf16, leaves over a quarter of the first 64 rows' outputs
    nonzero."""
    for name, (kernel, plain) in _cancel_calls("cpu").items():
        want = plain()
        assert want.dtype == torch.bfloat16
        assert torch.count_nonzero(want) == 0, name
        assert torch.equal(kernel(), want), name
    x, src, dst, wt, _, n = _cancel_layout()
    w_bf = torch.from_numpy(wt).to(torch.bfloat16).float().numpy()
    for w_used, round_msg in ((w_bf, False), (wt, True)):
        msgs = x[src] * w_used[:, None]
        if round_msg:
            msgs = torch.from_numpy(msgs).to(torch.bfloat16).float().numpy()
        out = np.zeros_like(x)
        np.add.at(out, dst, msgs)
        assert np.count_nonzero(out) > 0.25 * n // 2 * x.shape[1]


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["block_spmm", "block_spmm_bwd",
                                "spmm_sorted_coo", "spmm_sorted_coo_bwd"])
def test_bf16_weighted_roundings_on_card(cuda_device, op):
    """Every output of ``_cancel_layout`` is exactly 0 on the card, as in
    the plain version: a kernel that skips the weight's rounding to bf16 or
    a message's leaves many of them nonzero."""
    kernel, plain = _cancel_calls(cuda_device)[op]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    assert torch.count_nonzero(want) == 0
    assert torch.count_nonzero(got) == 0, op


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "block_spmm_weighted_bf16_f128", "block_spmm_bwd_weighted_bf16_f128",
    "block_spmm_weighted_bf16_f136", "block_spmm_weighted_bf16_dense",
    "spmm_weighted_bf16_f128", "spmm_bwd_weighted_bf16_f64"])
def test_bf16_weighted_value_by_value_on_card(cuda_device, case):
    """The weighted bf16 SpMMs value by value, as chip_smoke.py holds them
    (BF16_WEIGHTED): kernel and plain version add the same rounded
    messages in float32 in other orders and round each sum once, so every
    value lies within one bf16 step of its plain value and at most 1e-3 of
    them differ at all (where the two float32 sums straddle a rounding
    point)."""
    kernel, plain = _streaming_cases(cuda_device)[case]
    got, want = kernel().float(), plain().float()
    torch.cuda.synchronize()
    d, b = (got - want).abs(), want.abs()
    assert torch.all(d <= 2.0 ** -7 * (b + b.mean())), case
    assert int((d != 0).sum()) <= 1e-3 * d.numel(), case


# ---------------------------------------------------------------------------
# The flash-GAT forward (csrc/flash_gat.cu: row max from the masked bounds
# of score_r, p v on the tensor cores in 3xTF32) and the segment-softmax
# backward (csrc/segment_softmax.cu: a segment's rows in registers; with
# the forward's bounds, one launch)
# ---------------------------------------------------------------------------

FLASH_TOL = 1e-4  # chip_smoke.FLASH_TOL: |out - plain| and |lse - plain|
# name -> (N, H, D, slope): the backward's shapes, and a slope below 0 (the
# row max's V-shaped case) with multiplicities up to 3
FLASH_FWD_SPECS = {
    **FLASH_BWD_SPECS,
    "n300_h4_d32_slope_neg": (300, 4, 32, -0.1),
}


def _flash_fwd_case(device, name):
    """(kernel call, plain call) of one ``FLASH_FWD_SPECS`` case: a mask of
    density 4.5 % with multiplicities 2 and 3, in which destination 7 and
    source 11 have no edges."""
    n, heads, head_dim, slope = FLASH_FWD_SPECS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    cnt = (rng.random((n, n)) < 0.045).astype(np.float32)
    cnt += rng.random((n, n)) < 0.005
    cnt += rng.random((n, n)) < 0.002
    cnt[7] = 0.0
    cnt[:, 11] = 0.0
    sl, sr, v = (rng.standard_normal(shape).astype(np.float32)
                 for shape in ((n, heads), (n, heads), (n, heads, head_dim)))
    args = (*_on(device, sl, sr, v, cnt), slope)
    return (lambda: ops.flash_gat_attention(*args),
            lambda: ops.flash_gat_attention_plain(*args))


def test_flash_fwd_plain_cases_run_on_cpu():
    """The small cases on the CPU: the plain version, no launch counted;
    the empty destination gives 0 and lse NEG, multiplicities reach 3."""
    before = ops.flash_gat_attention.launches
    for name in ("n130_h2_d5", "n300_h4_d32_slope_neg"):
        kernel, plain = _flash_fwd_case("cpu", name)
        (out, lse), want = kernel(), plain()
        assert all(torch.equal(a, b) for a, b in zip((out, lse), want))
        assert not out[7].any() and bool((lse[7] == -1e30).all()), name
        assert bool((lse[8:] > -1e30).all()), name
    assert ops.flash_gat_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FLASH_FWD_SPECS))
def test_flash_gat_fwd_shapes_match_plain_on_card(cuda_device, case):
    """out and lse within FLASH_TOL of the plain version, as chip_smoke.py
    holds the kernel; the empty destination gives exact zeros and NEG."""
    kernel, plain = _flash_fwd_case(cuda_device, case)
    (out, lse), (out_p, lse_p) = kernel(), plain()
    torch.cuda.synchronize()
    assert out.shape == out_p.shape and lse.shape == lse_p.shape, case
    assert (out - out_p).abs().max().item() <= FLASH_TOL, case
    assert (lse - lse_p).abs().max().item() <= FLASH_TOL, case
    assert not out[7].any() and bool((lse[7] == -1e30).all()), case


def _softmax_bwd_layouts(device, dtype):
    """name -> (x, g, ids, num_segments) for the backward's two paths:
    holes (lengths), unsorted ids, short segments, spans across 256, and no
    segment at all; the cotangent negative everywhere, so that a dropped
    row computed as 0 * g would be -0."""
    rng = np.random.default_rng(17)
    layouts = {
        "lengths": (_softmax_ids(rng, (1, 32, 256, 257, 1000), 40), 40),
        "shuffled": (rng.permutation(np.concatenate([
            rng.integers(0, 50, 700), np.full(20, 50), [-1]])), 50),
        "nosegments": (np.zeros(64, np.int32), 0),
    }
    for name, lengths, n_seg in SOFTMAX_LAYOUTS:
        layouts[name] = (_softmax_layout_ids(rng, name, lengths, n_seg),
                         n_seg)
    out = {}
    for name, (ids, n_seg) in layouts.items():
        x, g, ids_t = _on(device, 4 * rng.standard_normal(
            (len(ids), 3)).astype(np.float32), -0.5 - rng.random(
            (len(ids), 3)).astype(np.float32), ids.astype(np.int32))
        out[name] = (x.to(dtype), g.to(dtype), ids_t, n_seg)
    return out


def _dirty(like: torch.Tensor) -> None:
    """Leave NaN in the caching allocator's next block of ``like``'s size,
    so that a row a kernel leaves unwritten does not read as 0."""
    torch.full_like(like, float("nan"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_bwd_saved_bounds_give_the_ops_bits_on_card(cuda_device,
                                                             dtype):
    """The autograd backward, which takes the forward's bounds and launches
    once, gives the op's own call (bounds pass, then the walk) bit for bit;
    each counts one launch; dropped rows read exactly +0 (sign bit clear)
    on both."""
    for name, (x, g, ids, n) in _softmax_bwd_layouts(cuda_device,
                                                     dtype).items():
        xr = x.clone().requires_grad_()
        alpha = ops.segment_softmax(xr, ids, n)
        before = ops.segment_softmax_bwd.launches
        _dirty(x)
        (auto,) = torch.autograd.grad(alpha, xr, g)
        _dirty(x)
        own = ops.segment_softmax_bwd(alpha.detach(), g, ids, n)
        assert ops.segment_softmax_bwd.launches == before + 2, name
        assert torch.equal(auto, own), name
        drop = (ids < 0) | (ids >= n)
        for d in (auto, own):
            assert bool((d[drop] == 0).all()), name
            assert not bool(torch.signbit(d[drop]).any()), name
        want = ops.segment_softmax_bwd_plain(alpha.detach(), g, ids, n)
        np.testing.assert_allclose(auto.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **(GRAD_TOL if dtype == torch.float32
                                      else BF16_TOL), err_msg=name)


@pytest.mark.gpu
def test_flash_fwd_and_softmax_bwd_repeat_bit_for_bit_on_card(cuda_device):
    """No float atomics and sums in a fixed order: two launches of the
    flash forward, and of either softmax backward, give the same bits."""
    for name in ("n1704_h4_d32", "n130_h2_d5", "n300_h8_d64_slope01"):
        kernel, _ = _flash_fwd_case(cuda_device, name)
        before = ops.flash_gat_attention.launches
        a, b = kernel(), kernel()
        assert ops.flash_gat_attention.launches == before + 2, name
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    for dtype in (torch.float32, torch.bfloat16):
        layouts = _softmax_bwd_layouts(cuda_device, dtype)
        for name in ("lengths", "span256", "short"):
            x, g, ids, n = layouts[name]
            alpha = ops.segment_softmax(x, ids, n)
            a, b = (ops.segment_softmax_bwd(alpha, g, ids, n)
                    for _ in range(2))
            assert torch.equal(a, b), name
            xr = x.clone().requires_grad_()
            out = ops.segment_softmax(xr, ids, n)
            a, b = (torch.autograd.grad(out, xr, g, retain_graph=True)[0]
                    for _ in range(2))
            assert torch.equal(a, b), name
