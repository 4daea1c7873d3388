"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the device routing of their wrappers.

This file imports no JAX, so it also runs on the machine with the card,
which has none (``--noconftest`` skips tests/conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Without a card the ``gpu`` tests skip. Tolerance: rtol = atol = 1e-5 in
f32, since kernel and plain version sum in different orders; counts exact.
"""

import numpy as np
import pytest
import torch

from bignn_tpu_torch import ops

TOL = dict(rtol=1e-5, atol=1e-5)


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
    }


@pytest.mark.parametrize("op", ["segment_sum", "block_adjacency",
                                "flash_gat_attention"])
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
    "flash_gat_small"])
def test_kernel_matches_plain_on_card(cuda_device, case):
    kernel, plain = _cases(cuda_device)[case]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


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
