"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the device routing of their wrappers.

This file imports no JAX, so it also runs on the machine with the card,
which has none (``--noconftest`` skips tests/conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Without a card the ``gpu`` tests skip. Tolerance: rtol = atol = 1e-5 in
f32, since kernel and plain version sum in different orders; counts exact;
gradients rtol = atol = 1e-4 (sums over whole rows and columns), and a
whole step's gradients rtol 2e-4 / atol 2e-5 x max |g|, as the CPU tests
hold the port against JAX.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from bignn_tpu_torch import ops

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


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
                                "flash_gat_attention_bwd"])
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
    }[op]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


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
    with pytest.raises(NotImplementedError, match="float32"):
        ops.segment_sum(torch.zeros(4, 2, dtype=torch.bfloat16,
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
