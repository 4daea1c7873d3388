"""Masked GAT attention over a dense multiplicity mask, forward
(counterpart of ``bignn_tpu/ops/pallas/flash_gat.py``).

``flash_gat_attention`` runs the CUDA kernel ``csrc/flash_gat.cu`` on CUDA
tensors and its plain version on CPU tensors. Both return ``(out, lse)``;
the logsumexp is what a flash backward recomputes the weights from (the
backward is still to port, ROADMAP Queue 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bignn_tpu_torch.ops import cuda_lib

NEG = -1e30  # "minus infinity" that survives f32 arithmetic
MAX_HEAD_DIM = 64  # limit of csrc/flash_gat.cu


def flash_gat_attention_plain(score_l, score_r, v, cnt, slope: float = 0.2):
    """Plain PyTorch version, mirroring ``_dense_masked_softmax_agg``
    (``bignn_tpu/models/convs.py:46-67``) plus the logsumexp of
    ``_fused_fwd_xla``; it materializes ``[N, N, H]``."""
    e = F.leaky_relu(score_l[:, None, :] + score_r[None, :, :], slope)
    valid = (cnt > 0)[:, :, None]
    m = torch.where(valid, e, -torch.inf).amax(dim=1).clamp_min(NEG)
    z = torch.where(valid, e - m[:, None, :], -1.0)
    p = cnt[:, :, None] * torch.exp(z)  # cnt == 0 exactly where invalid
    l = p.sum(dim=1)
    safe = l.clamp_min(1e-30)
    out = torch.einsum("dsh,shf->dhf", p / safe[:, None, :], v)
    lse = torch.where(l > 0, m + torch.log(safe), NEG)
    return out, lse


def flash_gat_attention(score_l: torch.Tensor, score_r: torch.Tensor,
                        v: torch.Tensor, cnt: torch.Tensor,
                        slope: float = 0.2):
    """``(out [N, H, D], lse [N, H])`` of masked additive attention.

    ``score_l``/``score_r`` ``[N, H]`` are the dst/src halves of the scores,
    ``v`` ``[N, H, D]`` the values, ``cnt`` ``[N, N]`` the edge multiplicity
    (``cnt[d, s]``). Rows with no edges give 0 and ``lse = NEG``. A CPU
    tensor takes the plain version; any other goes to the kernel."""
    if v.device.type == "cpu":
        return flash_gat_attention_plain(score_l, score_r, v, cnt, slope)
    dev = v.device
    cuda_lib.require_cuda(v, "v", torch.float32, 3, dev)
    n, heads, head_dim = v.shape
    for name, t in (("score_l", score_l), ("score_r", score_r)):
        cuda_lib.require_cuda(t, name, torch.float32, 2, dev)
        if tuple(t.shape) != (n, heads):
            raise ValueError(f"{name} must be [{n}, {heads}], "
                             f"got {tuple(t.shape)}")
    cuda_lib.require_cuda(cnt, "cnt", torch.float32, 2, dev)
    if tuple(cnt.shape) != (n, n):
        raise ValueError(f"cnt must be [{n}, {n}], got {tuple(cnt.shape)}")
    if head_dim > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_gat kernel takes head_dim <= {MAX_HEAD_DIM}, "
            f"got {head_dim}")
    out = torch.empty((n, heads, head_dim), dtype=torch.float32, device=dev)
    lse = torch.empty((n, heads), dtype=torch.float32, device=dev)
    cuda_lib.launch("bignn_flash_gat_fwd_f32", dev, score_l.data_ptr(),
                    score_r.data_ptr(), v.data_ptr(), cnt.data_ptr(), n,
                    heads, head_dim, float(slope), out.data_ptr(),
                    lse.data_ptr())
    flash_gat_attention.launches += 1
    return out, lse


flash_gat_attention.launches = 0
