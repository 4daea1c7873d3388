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

from unittest import mock

import numpy as np
import pytest
import torch

from bignn_tpu_torch import ops

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
                                "gather_rows_sorted_grad_bwd"])
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


def _sparse_cases(device):
    """name -> (kernel call, plain call) for the sparse-outer GAT kernels,
    on small inputs on ``device``."""
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
            ("h2d3", 30, 300, 2, 3, True), ("unsorted", 40, 500, 4, 8, False)):
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
    return cases


SPARSE_CASES = [
    *(f"segment_softmax_{t}" for t in ("sorted_h4", "holes_h8", "shuffled_h1",
                                       "1d")),
    *(f"segment_softmax_bwd_{t}" for t in ("sorted_h4", "holes_h8",
                                           "shuffled_h1")),
    *(f"spmm_multihead_{t}" for t in ("h4d32", "h8d32", "h2d3", "unsorted")),
    *(f"spmm_multihead_bwd_{t}" for t in ("h4d32", "h8d32", "h2d3",
                                          "unsorted", "argsort")),
    "gather_bwd_sorted", "gather_bwd_perm"]


def test_sparse_case_names_are_complete():
    assert sorted(_sparse_cases("cpu")) == sorted(SPARSE_CASES)


def test_sparse_plain_cases_run_on_cpu():
    """On CPU tensors each wrapper takes its plain version: both calls of a
    case agree exactly, and no launch is counted."""
    counted = (ops.segment_softmax, ops.segment_softmax_bwd,
               ops.spmm_multihead, ops.spmm_multihead_bwd,
               ops.gather_rows_sorted_grad_bwd)
    before = [k.launches for k in counted]
    for name, (kernel, plain) in _sparse_cases("cpu").items():
        got, want = kernel(), plain()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), name
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
    s = torch.zeros(8, 2, device=cuda_device)
    v = torch.zeros(8, 2, 72, device=cuda_device)  # head_dim over the limit
    with pytest.raises(NotImplementedError, match="head_dim"):
        ops.flash_gat_attention(s, s, v, torch.zeros(8, 8, device=cuda_device))
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
    wide = torch.zeros(50, 2, 72, device=cuda_device)  # head_dim over 64
    with pytest.raises(NotImplementedError, match="head_dim"):
        ops.flash_gat_attention_bwd(sl, sr, wide, cnt, lse, wide, wide)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_kernel_matches_plain_on_card(cuda_device, case):
    kernel, plain = _sparse_cases(cuda_device)[case]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    tol = GRAD_TOL if "bwd" in case else TOL
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **tol)


@pytest.mark.gpu
def test_sparse_kernels_repeat_bit_for_bit_and_count(cuda_device):
    """No float atomics: two launches give the same bits. Each wrapper
    counts one launch per call, its plain version none."""
    cases = _sparse_cases(cuda_device)
    for name, kernel in (("segment_softmax", "segment_softmax_sorted_h4"),
                         ("segment_softmax_bwd",
                          "segment_softmax_bwd_sorted_h4"),
                         ("spmm_multihead", "spmm_multihead_h4d32"),
                         ("spmm_multihead_bwd", "spmm_multihead_bwd_h4d32"),
                         ("gather_rows_sorted_grad_bwd", "gather_bwd_perm")):
        op = getattr(ops, name)
        before = op.launches
        a, b = cases[kernel][0](), cases[kernel][0]()
        cases[kernel][1]()
        assert op.launches == before + 2, name
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), name


@pytest.mark.gpu
def test_sparse_kernels_refuse_on_card(cuda_device):
    z = torch.zeros(16, 9, device=cuda_device)
    ids = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="heads"):
        ops.segment_softmax(z, ids, 4)  # 9 heads, the kernel takes <= 8
    with pytest.raises(ValueError, match="int32"):
        ops.segment_softmax(z[:, :4].contiguous(), ids.long(), 4)
    v = torch.zeros(8, 4, 72, device=cuda_device)  # H * D = 288 > 256
    with pytest.raises(NotImplementedError, match="head_dim"):
        ops.spmm_multihead(v, ids, ids, z[:, :4].contiguous(), 8)
    v = torch.zeros(8, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.spmm_multihead(v, ids, ids, z[:, :8:2], 8)


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
            ("unsorted", 40, 500, 4, 8, False)):
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
      for t in ("holes_h4", "shuffled_h3")),
    *(f"spmm_multihead{b}_bf16_{t}" for b in ("", "_bwd")
      for t in ("h4d32", "h2d3", "unsorted")),
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
            assert torch.equal(a, b), name
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
            ("spmm_multihead", "spmm_multihead_bf16_h4d32", "bf16"),
            ("spmm_multihead_bwd", "spmm_multihead_bwd_bf16_h4d32", "bf16"),
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
