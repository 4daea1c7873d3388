"""Multi-head weighted aggregation over an edge list (counterpart of
``bignn_tpu/ops/multihead.py:spmm_multihead``):
``out[d, h, :] = sum over edges e with dst_e = d of alpha[e, h] v[src_e, h, :]``.

``spmm_multihead`` is a ``torch.autograd.Function`` with gradients for
``v`` and ``alpha``. Per-edge values keep the JAX package's flat
``[E, H*D]`` layout. On CUDA tensors the forward runs the kernel of
``csrc/spmm_multihead.cu`` (one warp per destination, no ``[E, H*D]``
message tensor), and the backward its second kernel, which gives ``d_v``
and ``d_alpha`` in one walk over the source-sorted edge order
(``src_perm``/``src_sorted``, precomputed per graph, or an ``argsort`` of
``src`` when absent, as ``_mh_bwd`` does). On CPU tensors both take the
plain versions. Padding edges (``dst >= num_out``) take no part and get a
zero ``d_alpha``; every ``src`` must lie in ``[0, N)`` (the layouts pad
with 0), though the forward clips it as JAX's ``take`` does.

``v``, ``alpha`` and the cotangent take float32 or bf16 (one type): products
and sums run in float32 and each output is rounded once to that type, in the
kernels and in the plain versions alike. The JAX package rounds each bf16
message to bf16 before its sum (``multihead.py:81-83``), so in bf16 the two
packages differ by rounding.
"""

from __future__ import annotations

import torch

from bignn_tpu_torch.ops import cuda_lib

MAX_HEADS = 8  # limits of csrc/spmm_multihead.cu
MAX_WIDTH = 256  # H * D


def _alpha_wide(alpha: torch.Tensor, head_dim: int) -> torch.Tensor:
    """``[E, H] -> [E, H*D]``, each head's weight repeated over its D
    columns (``_alpha_wide``)."""
    return alpha.repeat_interleave(head_dim, dim=1)


def spmm_multihead_plain(v: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, alpha: torch.Tensor,
                         num_out: int, src_perm=None,
                         src_sorted=None) -> torch.Tensor:
    """Plain PyTorch version, mirroring ``_mh_forward``: gather, scale,
    ``index_add_`` over dst, in float32, rounded once to ``v``'s type; it
    materializes two ``[E, H*D]`` tensors. Differentiable by autograd.
    ``src_perm``/``src_sorted`` are accepted for the signature and not
    needed."""
    n, heads, head_dim = v.shape
    v2 = v.reshape(n, heads * head_dim).float()
    msgs = v2[src.long().clamp(0, n - 1)] * _alpha_wide(alpha.float(),
                                                        head_dim)
    ids = dst.long()
    keep = (ids >= 0) & (ids < num_out)
    out = msgs.new_zeros((num_out + 1, heads * head_dim))
    out = out.index_add(0, torch.where(keep, ids, num_out), msgs)
    return out[:num_out].view(num_out, heads, head_dim).to(v.dtype)


def _src_order(src: torch.Tensor, src_perm, src_sorted):
    """``(src_perm, src_sorted)``: as given, or by a stable argsort."""
    if (src_perm is None) != (src_sorted is None):
        raise ValueError("src_perm and src_sorted must be passed together")
    if src_perm is None:
        src_perm = torch.argsort(src, stable=True).to(torch.int32)
        src_sorted = src[src_perm.long()]
    return src_perm, src_sorted


def spmm_multihead_bwd_plain(v, src, dst, alpha, num_out, g, src_perm=None,
                             src_sorted=None):
    """Plain analytic VJP, mirroring ``_mh_bwd``: ``(d_v [N, H, D],
    d_alpha [E, H])`` for the cotangent ``g [num_out, H, D]``, in float32,
    each rounded once to ``v``'s type; it materializes four ``[E, H*D]``
    tensors."""
    n, heads, head_dim = v.shape
    width = heads * head_dim
    g2 = g.reshape(num_out, width).float()
    ids = dst.long()
    keep = ((ids >= 0) & (ids < num_out))[:, None]
    g_e = torch.where(keep, g2[ids.clamp(0, max(num_out - 1, 0))], 0.0)
    v_e = v.reshape(n, width).float()[src.long().clamp(0, n - 1)]
    d_alpha = (g_e * v_e).view(-1, heads, head_dim).sum(-1)
    m = g_e * _alpha_wide(alpha.float(), head_dim)
    src_perm, src_sorted = _src_order(src, src_perm, src_sorted)
    d_v = m.new_zeros((n + 1, width))
    s_ids = src_sorted.long()
    s_keep = (s_ids >= 0) & (s_ids < n)
    d_v.index_add_(0, torch.where(s_keep, s_ids, n), m[src_perm.long()])
    return (d_v[:n].view(n, heads, head_dim).to(v.dtype),
            d_alpha.to(alpha.dtype))


def _check(v, src, dst, alpha, *more) -> tuple[int, int, int, int, str]:
    """Check what the kernels take; returns ``(n, heads, head_dim, E,
    suffix)``. ``more`` holds further ``(name, tensor, dtype, shape)``; a
    dtype of None means ``v``'s."""
    suffix = cuda_lib.require_float(v, "v", "spmm_multihead")
    dev = v.device
    cuda_lib.require_cuda(v, "v", v.dtype, 3, dev)
    n, heads, head_dim = v.shape
    e = src.shape[0]
    checks = (("src", src, torch.int32, (e,)), ("dst", dst, torch.int32, (e,)),
              ("alpha", alpha, None, (e, heads)), *more)
    for name, t, dtype, shape in checks:
        cuda_lib.require_cuda(t, name, dtype or v.dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, "
                             f"got {tuple(t.shape)}")
    if n < 1 or heads > MAX_HEADS or heads * head_dim > MAX_WIDTH:
        raise NotImplementedError(
            f"spmm_multihead kernels take N >= 1, heads <= {MAX_HEADS} and "
            f"heads * head_dim <= {MAX_WIDTH}, got {tuple(v.shape)}")
    return n, heads, head_dim, e, suffix


def _spmm_multihead_fwd_cuda(v, src, dst, alpha, num_out):
    n, heads, head_dim, e, suffix = _check(v, src, dst, alpha)
    dev = v.device
    out = torch.empty((num_out, heads, head_dim), dtype=v.dtype, device=dev)
    first = torch.empty(num_out, dtype=torch.int32, device=dev)
    last = torch.empty(num_out, dtype=torch.int32, device=dev)
    cuda_lib.launch(f"bignn_spmm_multihead_fwd_{suffix}", dev, v.data_ptr(),
                    src.data_ptr(), dst.data_ptr(), alpha.data_ptr(), e, n,
                    num_out, heads, head_dim, first.data_ptr(),
                    last.data_ptr(), out.data_ptr())
    cuda_lib.count(spmm_multihead, v.dtype)
    return out


def spmm_multihead_bwd(v, src, dst, alpha, num_out, g, src_perm=None,
                       src_sorted=None):
    """``(d_v [N, H, D], d_alpha [E, H])`` for the cotangent ``g`` of the
    output (``[num_out, H, D]``). A CPU tensor takes the plain version; any
    other goes to the kernel, which raises on what it does not take."""
    if v.device.type == "cpu":
        return spmm_multihead_bwd_plain(v, src, dst, alpha, num_out, g,
                                        src_perm, src_sorted)
    src_perm, src_sorted = _src_order(src, src_perm, src_sorted)
    n, heads, head_dim, e, suffix = _check(
        v, src, dst, alpha,
        ("g", g, None, (num_out, v.shape[1], v.shape[2])),
        ("src_perm", src_perm, torch.int32, (src.shape[0],)),
        ("src_sorted", src_sorted, torch.int32, (src.shape[0],)))
    dev = v.device
    d_v = torch.empty_like(v)
    d_alpha = torch.zeros_like(alpha)  # rows of edges with src outside [0, N)
    first = torch.empty(n, dtype=torch.int32, device=dev)
    last = torch.empty(n, dtype=torch.int32, device=dev)
    cuda_lib.launch(f"bignn_spmm_multihead_bwd_{suffix}", dev, v.data_ptr(),
                    g.data_ptr(), dst.data_ptr(), alpha.data_ptr(),
                    src_perm.data_ptr(), src_sorted.data_ptr(), e, n, num_out,
                    heads, head_dim, first.data_ptr(), last.data_ptr(),
                    d_v.data_ptr(), d_alpha.data_ptr())
    cuda_lib.count(spmm_multihead_bwd, v.dtype)
    return d_v, d_alpha


cuda_lib.counter(spmm_multihead_bwd)


class _SpmmMultihead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, src, dst, alpha, num_out, src_perm, src_sorted):
        if v.device.type == "cpu":
            out = spmm_multihead_plain(v, src, dst, alpha, num_out)
        else:
            out = _spmm_multihead_fwd_cuda(v, src, dst, alpha, num_out)
        ctx.save_for_backward(v, src, dst, alpha, src_perm, src_sorted)
        ctx.num_out = num_out
        return out

    @staticmethod
    def backward(ctx, g):
        v, src, dst, alpha, src_perm, src_sorted = ctx.saved_tensors
        d_v, d_alpha = spmm_multihead_bwd(v, src, dst, alpha, ctx.num_out,
                                          g.contiguous(), src_perm,
                                          src_sorted)
        return d_v, None, None, d_alpha, None, None, None


def spmm_multihead(v: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   alpha: torch.Tensor, num_out: int, *,
                   src_perm: torch.Tensor | None = None,
                   src_sorted: torch.Tensor | None = None) -> torch.Tensor:
    """``[num_out, H, D]``: per destination, the ``alpha``-weighted sum of
    its edges' source rows of ``v`` (``[N, H, D]`` float32 or bf16), head
    by head, in ``v``'s type.

    ``src``/``dst`` are ``[E]`` int32 (dst sorted for speed, right in any
    order), ``alpha`` ``[E, H]`` in ``v``'s type; ``src_perm``/``src_sorted``
    (``argsort(src)``, ``src[src_perm]``) spare the backward its argsort.
    A CPU tensor takes the plain versions; any other goes to the kernels.
    Differentiable in ``v`` and ``alpha``."""
    return _SpmmMultihead.apply(v, src, dst, alpha, int(num_out), src_perm,
                                src_sorted)


cuda_lib.counter(spmm_multihead)
