"""Sorted-COO SpMM (counterpart of ``bignn_tpu/ops/spmm.py:spmm_sorted_coo``
and ``bignn_tpu/ops/pallas/spmm.py:spmm_pallas``):
``y[d] = sum over the edges e with dst_e = d of w_e x[src_e]``, ``w_e = 1``
when ``weight`` is None. The inner convs' aggregation on layouts that are
not block-local (molecules over 128 atoms), and the GCN outer conv on an
outer graph without dense masks.

``spmm_sorted_coo`` dispatches as the JAX function does: with a
``block_plan`` it is ``ops.block_spmm``, otherwise a
``torch.autograd.Function`` whose forward runs the kernel of
``csrc/spmm.cu`` on a CUDA tensor (a row slot per destination row, rows
that span many positions cut into pieces over the whole card; no ``[E,
F]`` message tensor; the wrappers allocate its scratch) and whose backward
(``spmm_sorted_coo_bwd``) runs
its permuted-read form for ``d_x`` over the source-sorted order
(``src_perm``/``src_sorted``, precomputed per graph, or one stable sort of
``src`` when absent), JAX's ``_dx_sorted`` fused. ``d_weight`` is a per-edge
dot in plain PyTorch, as in JAX. Padding edges (``dst >= num_out``) take no
part in either direction. A CPU tensor takes the plain versions. Both
wrappers count their launches per element type, the weighted forms under
``f32:weighted`` and ``bf16:weighted``. The kernels take float32 or bf16
rows (float32 weights) and raise on other types. In bf16 they round as the
JAX package does (``ops/pallas/spmm.py:55, :97``): the weight and each
weighted message to bf16, then a float32 sum; ``d_weight`` comes back in
the weight's type.
"""

from __future__ import annotations

import ctypes

import torch

from bignn_tpu_torch.ops import cuda_lib
from bignn_tpu_torch.ops.block_spmm import (
    block_spmm,
    block_spmm_plain,
    edge_weight_grad,
)
from bignn_tpu_torch.ops.multihead import _src_order
from bignn_tpu_torch.ops.segment import segment_sum_plain


def spmm_sorted_coo_plain(x: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, weight: torch.Tensor | None,
                          num_out: int, src_perm=None, src_sorted=None,
                          block_plan=None) -> torch.Tensor:
    """Plain PyTorch version, mirroring the JAX ``xla`` path: gather
    (clipped, as ``take(mode="clip")``), weight, ``index_add`` over dst in
    float32 (``segment_sum_plain``). Differentiable by autograd.
    ``src_perm``/``src_sorted`` are taken for the signature; with a
    ``block_plan`` it is ``block_spmm_plain``."""
    if block_plan is not None:
        return block_spmm_plain(x, src, dst, weight, num_nodes=num_out)
    msgs = x[src.long().clamp(0, max(x.shape[0] - 1, 0))]
    if weight is not None:
        msgs = msgs * weight[:, None].to(msgs.dtype)
    return segment_sum_plain(msgs, dst, num_out)


def spmm_sorted_coo_bwd_plain(g: torch.Tensor, src: torch.Tensor,
                              dst: torch.Tensor, weight: torch.Tensor | None,
                              num_x: int, src_perm=None,
                              src_sorted=None) -> torch.Tensor:
    """Plain ``d_x``, mirroring ``_masked_cotangent`` and ``_dx_sorted``:
    the per-edge cotangent ``g[dst] * w`` (0 on padding edges), permuted to
    source order and summed over ``src_sorted``."""
    num_out = g.shape[0]
    ids = dst.long()
    keep = ((ids >= 0) & (ids < num_out))[:, None]
    m = torch.where(keep, g[ids.clamp(0, max(num_out - 1, 0))], 0.0)
    if weight is not None:
        m = m * weight[:, None].to(m.dtype)
    src_perm, src_sorted = _src_order(src, src_perm, src_sorted)
    return segment_sum_plain(m[src_perm.long()], src_sorted, num_x)


def _check(x, src, dst, weight, name: str) -> tuple[int, int, str]:
    """Check what the kernels take; returns ``(rows of x, F, suffix)``, the
    last the entry points' element type."""
    suffix = cuda_lib.require_float(x, name, "spmm")
    dev = x.device
    cuda_lib.require_cuda(x, name, x.dtype, 2, dev)
    e = src.shape[0]
    cuda_lib.require_cuda(src, "src", torch.int32, 1, dev)
    cuda_lib.require_cuda(dst, "dst", torch.int32, 1, dev)
    if dst.shape[0] != e:
        raise ValueError(f"src has {e} edges, dst {dst.shape[0]}")
    if weight is not None:
        cuda_lib.require_cuda(weight, "weight", torch.float32, 1, dev)
        if weight.shape[0] != e:
            raise ValueError("weight must match the edge list")
    return x.shape[0], x.shape[1], suffix


def _scratch(dev, num_pos: int, num_out: int,
             feat: int) -> list[torch.Tensor]:
    """The kernels' scratch: each output row's bounds ``[num_out]`` int32
    twice, and the long-row list with its partial sums (as many bytes as
    ``bignn_spmm_scratch`` says). The caller holds it until the launch is
    queued."""
    size = ctypes.c_int64()
    cuda_lib.launch("bignn_spmm_scratch", dev, num_pos, feat,
                    ctypes.addressof(size))
    return [torch.empty(n, dtype=t, device=dev)
            for n, t in ((num_out, torch.int32), (num_out, torch.int32),
                         (size.value, torch.uint8))]


def _spmm_fwd_cuda(x, src, dst, weight, num_out):
    n, f, suffix = _check(x, src, dst, weight, "x")
    dev = x.device
    out = torch.empty((num_out, f), dtype=x.dtype, device=dev)
    scratch = _scratch(dev, src.shape[0], num_out, f)
    cuda_lib.launch(f"bignn_spmm_{suffix}", dev, x.data_ptr(), n, src.data_ptr(),
                    dst.data_ptr(),
                    None if weight is None else weight.data_ptr(),
                    src.shape[0], num_out, f,
                    *(t.data_ptr() for t in scratch), out.data_ptr())
    cuda_lib.count(spmm_sorted_coo, x.dtype, weight is not None)
    return out


def spmm_sorted_coo_bwd(g: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, weight: torch.Tensor | None,
                        num_x: int, src_perm: torch.Tensor | None = None,
                        src_sorted: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """``d_x [num_x, F]`` of ``spmm_sorted_coo`` for the output cotangent
    ``g [num_out, F]``. A CPU tensor takes the plain version; any other goes
    to the kernel, which raises on what it does not take."""
    if g.device.type == "cpu":
        return spmm_sorted_coo_bwd_plain(g, src, dst, weight, num_x, src_perm,
                                         src_sorted)
    src_perm, src_sorted = _src_order(src, src_perm, src_sorted)
    num_g, f, suffix = _check(g, src, dst, weight, "g")
    dev = g.device
    for name, t in (("src_perm", src_perm), ("src_sorted", src_sorted)):
        cuda_lib.require_cuda(t, name, torch.int32, 1, dev)
        if t.shape[0] != src.shape[0]:
            raise ValueError(f"{name} must match the edge list")
    d_x = torch.empty((num_x, f), dtype=g.dtype, device=dev)
    scratch = _scratch(dev, src.shape[0], num_x, f)
    cuda_lib.launch(f"bignn_spmm_bwd_{suffix}", dev, g.data_ptr(), num_g,
                    dst.data_ptr(),
                    None if weight is None else weight.data_ptr(),
                    src_perm.data_ptr(), src_sorted.data_ptr(), src.shape[0],
                    num_x, f, *(t.data_ptr() for t in scratch),
                    d_x.data_ptr())
    cuda_lib.count(spmm_sorted_coo_bwd, g.dtype, weight is not None)
    return d_x


cuda_lib.counter(spmm_sorted_coo_bwd)


class _SpmmSortedCoo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, src, dst, num_out, src_perm, src_sorted):
        if x.device.type == "cpu":
            out = spmm_sorted_coo_plain(x, src, dst, weight, num_out)
        else:
            out = _spmm_fwd_cuda(x, src, dst, weight, num_out)
        ctx.save_for_backward(x, weight, src, dst, src_perm, src_sorted)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, src, dst, src_perm, src_sorted = ctx.saved_tensors
        g = g.contiguous()
        d_x = d_w = None
        if ctx.needs_input_grad[0]:
            d_x = spmm_sorted_coo_bwd(g, src, dst, weight, x.shape[0],
                                      src_perm, src_sorted)
        if weight is not None and ctx.needs_input_grad[1]:
            d_w = edge_weight_grad(g, x, src, dst).to(weight.dtype)
        return d_x, d_w, None, None, None, None, None


def spmm_sorted_coo(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    weight: torch.Tensor | None, num_out: int, *,
                    src_perm: torch.Tensor | None = None,
                    src_sorted: torch.Tensor | None = None,
                    block_plan: tuple | None = None) -> torch.Tensor:
    """``[num_out, F]``: per destination, the ``weight``-weighted sum of its
    edges' source rows of ``x`` (``[N, F]``).

    ``src``/``dst`` are ``[E]`` int32, dst sorted for speed (right in any
    order; padding edges carry ``dst == num_out``), ``weight`` ``[E]`` or
    None; ``src_perm``/``src_sorted`` (``argsort(src)``, ``src[src_perm]``)
    spare the backward its sort. ``block_plan`` ``(estarts, tsrc, tdst,
    tweight, tstarts)`` of a block-local layout routes to ``block_spmm``. A
    CPU tensor takes the plain versions; any other goes to the kernels.
    Differentiable in ``x`` and ``weight``."""
    if block_plan is not None:
        estarts, tsrc, tdst, tweight, tstarts = block_plan
        return block_spmm(x, src, dst, weight, estarts, tsrc, tdst,
                          None if weight is None else tweight, tstarts,
                          num_out)
    return _SpmmSortedCoo.apply(x, weight, src, dst, int(num_out), src_perm,
                                src_sorted)


cuda_lib.counter(spmm_sorted_coo)
