"""Masked GAT attention over a dense multiplicity mask, forward and backward
(counterpart of ``bignn_tpu/ops/pallas/flash_gat.py``).

``flash_gat_attention`` is a ``torch.autograd.Function`` returning
``(out, lse)``. Its forward runs the CUDA kernel ``csrc/flash_gat.cu`` on
CUDA tensors and its plain version on CPU tensors; its backward recomputes
the attention weights from the saved logsumexp (the flash VJP, JAX
``_flash_bwd``) with the CUDA kernel ``csrc/flash_gat_bwd.cu``, or on CPU
tensors with :func:`flash_gat_attention_bwd_plain`. ``lse`` carries no
gradient, and ``cnt`` gets none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bignn_tpu_torch.ops import cuda_lib

NEG = -1e30  # "minus infinity" that survives f32 arithmetic
MAX_HEAD_DIM = 64  # limit of csrc/flash_gat.cu and csrc/flash_gat_bwd.cu


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


def flash_gat_attention_bwd_plain(score_l, score_r, v, cnt, lse, out, g,
                                  slope: float = 0.2):
    """Plain PyTorch flash VJP: ``(d_score_l, d_score_r, d_v)`` recomputed
    from ``lse`` as ``_bwd_kernel`` (``flash_gat.py:85-114``) does, with its
    NEG masking and ``min(e - lse, 0)``; it materializes ``[N, N, H]``.
    This is not the autograd of the plain forward (the tests compare the
    two)."""
    delta = (g * out).sum(-1)  # [N, H]
    z = score_l[:, None, :] + score_r[None, :, :]  # [dst, src, H]
    e = torch.where(z > 0, z, slope * z)
    # empty rows have lse == NEG and cnt == 0, and e - NEG overflows exp:
    # mask e to NEG there, so alpha = 0 * exp(0) = 0
    e = torch.where((cnt > 0)[:, :, None], e, NEG)
    alpha = cnt[:, :, None] * torch.exp(
        torch.clamp_max(e - lse[:, None, :], 0.0))
    d_alpha = torch.einsum("dhf,shf->dsh", g, v)
    d_e = alpha * (d_alpha - delta[:, None, :])
    d_z = torch.where(z > 0, d_e, slope * d_e)
    dv = torch.einsum("dsh,dhf->shf", alpha, g)
    return d_z.sum(dim=1), d_z.sum(dim=0), dv


def _check(score_l, score_r, v, cnt, *more) -> tuple[int, int, int]:
    """Check what the kernels take; returns ``(n, heads, head_dim)``.
    ``more`` holds further ``(name, tensor, rank)``: rank 2 is ``[N, H]``,
    rank 3 ``[N, H, D]``."""
    dev = v.device
    cuda_lib.require_cuda(v, "v", torch.float32, 3, dev)
    n, heads, head_dim = v.shape
    for name, t, ndim in (("score_l", score_l, 2), ("score_r", score_r, 2),
                          *more):
        cuda_lib.require_cuda(t, name, torch.float32, ndim, dev)
        want = (n, heads) if ndim == 2 else (n, heads, head_dim)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, "
                             f"got {tuple(t.shape)}")
    cuda_lib.require_cuda(cnt, "cnt", torch.float32, 2, dev)
    if tuple(cnt.shape) != (n, n):
        raise ValueError(f"cnt must be [{n}, {n}], got {tuple(cnt.shape)}")
    if head_dim > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_gat kernels take head_dim <= {MAX_HEAD_DIM}, "
            f"got {head_dim}")
    return n, heads, head_dim


def _flash_gat_fwd_cuda(score_l, score_r, v, cnt, slope: float):
    n, heads, head_dim = _check(score_l, score_r, v, cnt)
    dev = v.device
    out = torch.empty((n, heads, head_dim), dtype=torch.float32, device=dev)
    lse = torch.empty((n, heads), dtype=torch.float32, device=dev)
    cuda_lib.launch("bignn_flash_gat_fwd_f32", dev, score_l.data_ptr(),
                    score_r.data_ptr(), v.data_ptr(), cnt.data_ptr(), n,
                    heads, head_dim, float(slope), out.data_ptr(),
                    lse.data_ptr())
    cuda_lib.count(flash_gat_attention, torch.float32)
    return out, lse


def flash_gat_attention_bwd(score_l, score_r, v, cnt, lse, out, g,
                            slope: float = 0.2):
    """``(d_score_l [N, H], d_score_r [N, H], d_v [N, H, D])`` for the
    cotangent ``g`` of ``out`` (JAX ``_flash_bwd``). ``delta = sum_f g *
    out`` is taken here in torch, as ``_flash_bwd`` takes it outside its
    ``pallas_call``. A CPU tensor takes the plain version; any other goes to
    the kernel, which wants every tensor but ``out`` contiguous and raises
    otherwise."""
    if v.device.type == "cpu":
        return flash_gat_attention_bwd_plain(score_l, score_r, v, cnt, lse,
                                             out, g, slope)
    if out.shape != g.shape:
        raise ValueError(f"out {tuple(out.shape)} and g {tuple(g.shape)} "
                         "differ")
    delta = (g * out).sum(-1)  # out reaches no kernel: any layout will do
    n, heads, head_dim = _check(score_l, score_r, v, cnt, ("lse", lse, 2),
                                ("delta", delta, 2), ("g", g, 3))
    dev = v.device
    dsl = torch.empty((n, heads), dtype=torch.float32, device=dev)
    dsr = torch.empty((n, heads), dtype=torch.float32, device=dev)
    dv = torch.empty((n, heads, head_dim), dtype=torch.float32, device=dev)
    cuda_lib.launch("bignn_flash_gat_bwd_f32", dev, score_l.data_ptr(),
                    score_r.data_ptr(), v.data_ptr(), cnt.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), g.data_ptr(), n, heads,
                    head_dim, float(slope), dsl.data_ptr(), dsr.data_ptr(),
                    dv.data_ptr())
    cuda_lib.count(flash_gat_attention_bwd, torch.float32)
    return dsl, dsr, dv


cuda_lib.counter(flash_gat_attention_bwd)


class _FlashGATAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, score_l, score_r, v, cnt, slope):
        if v.device.type == "cpu":
            out, lse = flash_gat_attention_plain(score_l, score_r, v, cnt,
                                                 slope)
        else:
            out, lse = _flash_gat_fwd_cuda(score_l, score_r, v, cnt, slope)
        ctx.save_for_backward(score_l, score_r, v, cnt, lse, out)
        ctx.slope = slope
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        score_l, score_r, v, cnt, lse, out = ctx.saved_tensors
        # a reshape-made cotangent can be strided; the kernel wants it dense
        dsl, dsr, dv = flash_gat_attention_bwd(
            score_l, score_r, v, cnt, lse, out, g.contiguous(), ctx.slope)
        return dsl, dsr, dv, None, None


def flash_gat_attention(score_l: torch.Tensor, score_r: torch.Tensor,
                        v: torch.Tensor, cnt: torch.Tensor,
                        slope: float = 0.2):
    """``(out [N, H, D], lse [N, H])`` of masked additive attention.

    ``score_l``/``score_r`` ``[N, H]`` are the dst/src halves of the scores,
    ``v`` ``[N, H, D]`` the values, ``cnt`` ``[N, N]`` the edge multiplicity
    (``cnt[d, s]``). Rows with no edges give 0 and ``lse = NEG``. A CPU
    tensor takes the plain versions; any other goes to the kernels.
    Differentiable in ``score_l``, ``score_r`` and ``v``."""
    return _FlashGATAttention.apply(score_l, score_r, v, cnt, float(slope))


cuda_lib.counter(flash_gat_attention)
