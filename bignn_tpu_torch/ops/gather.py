"""Row gathers (counterpart of ``bignn_tpu/ops/gather.py``).

``gather_rows_sorted_grad`` is the gather whose backward is a sorted
segment sum, not a scatter: a ``torch.autograd.Function`` whose backward
runs the permuted-read entry point of ``csrc/segment_sum.cu`` on CUDA
tensors (summing ``g[perm]`` over ``ids_sorted`` in place, with no copy of
``g[perm]``) and the plain version on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from bignn_tpu_torch.ops import cuda_lib
from bignn_tpu_torch.ops.segment import segment_sum_launch, segment_sum_plain

NARROW = 8  # row width up to which gather_rows gathers element by element


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` with out-of-range indices clipped to the nearest
    row, as ``jnp.take(..., mode="clip")`` does (padding-safe).

    Rows of at most ``NARROW`` values (the GAT's ``[N, H]`` scores) go
    through ``torch.gather`` with a materialized index, one thread an
    element: on the card, ``table[...]``, ``index_select`` and a gather
    with an expanded index all launch one block per row: ~10 ms on an
    H100 for the 16.1M edges of the 100K-drug graph, against ~0.3 ms."""
    idx = indices.long().clamp(0, table.shape[0] - 1)
    if table.dim() == 2 and table.shape[1] <= NARROW:
        return torch.gather(
            table, 0, idx[:, None].expand(-1, table.shape[1]).contiguous())
    return table.index_select(0, idx)


def permutation_scatter_rows(values: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """``out[idx[j]] = values[j]`` for a permutation ``idx``, computed as the
    gather ``values[argsort(idx)]``."""
    return values[torch.argsort(idx)]


def gather_rows_sorted_grad_plain(table, indices, perm=None, ids_sorted=None):
    """Plain version: the clipped gather, differentiated by autograd (a
    scatter-add; clipped indices send their gradient to the edge row, as
    JAX's ``xla`` path does)."""
    return gather_rows(table, indices)


def gather_rows_sorted_grad_bwd_plain(g: torch.Tensor, indices: torch.Tensor,
                                      num_rows: int, perm=None,
                                      ids_sorted=None) -> torch.Tensor:
    """Plain backward, mirroring ``_gather_sorted_bwd``: the segment sum of
    ``g`` over ``indices``, or of ``g[perm]`` over ``ids_sorted``; ids
    outside ``[0, num_rows)`` (padding) are dropped."""
    if perm is None:
        return segment_sum_plain(g, indices, num_rows)
    return segment_sum_plain(g[perm.long()], ids_sorted, num_rows)


def gather_rows_sorted_grad_bwd(g: torch.Tensor, indices: torch.Tensor,
                                num_rows: int, perm=None,
                                ids_sorted=None) -> torch.Tensor:
    """The gradient of the table, ``[num_rows, ...]``, for the cotangent
    ``g`` (``[E, ...]`` float32 or bf16, summed in float32, in ``g``'s type)
    of the gather. A CPU tensor takes the plain
    version; any other goes to the kernel, which raises on what it does not
    take."""
    if g.device.type == "cpu":
        return gather_rows_sorted_grad_bwd_plain(g, indices, num_rows, perm,
                                                 ids_sorted)
    flat = g.reshape(g.shape[0], math.prod(g.shape[1:]))
    if perm is None:
        out = segment_sum_launch(flat, indices, num_rows)
    else:
        out = segment_sum_launch(flat, ids_sorted, num_rows, perm)
    cuda_lib.count(gather_rows_sorted_grad_bwd, g.dtype)
    return out.view((num_rows,) + tuple(g.shape[1:]))


cuda_lib.counter(gather_rows_sorted_grad_bwd)


class _GatherSortedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, perm, ids_sorted):
        ctx.save_for_backward(indices, perm, ids_sorted)
        ctx.num_rows = table.shape[0]
        return gather_rows(table, indices)

    @staticmethod
    def backward(ctx, g):
        indices, perm, ids_sorted = ctx.saved_tensors
        d = gather_rows_sorted_grad_bwd(g.contiguous(), indices, ctx.num_rows,
                                        perm, ids_sorted)
        return d, None, None, None


def gather_rows_sorted_grad(table: torch.Tensor, indices: torch.Tensor, *,
                            perm: torch.Tensor | None = None,
                            ids_sorted: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The clipped gather ``table[indices]`` whose backward is a sorted
    segment sum (``bignn_tpu/ops/gather.py:gather_rows_sorted_grad``).

    ``indices`` are sorted, or ``perm``/``ids_sorted`` give their sorting
    permutation (``argsort(indices)``, ``indices[perm]``; int32). Indices
    outside ``[0, N)`` (padding) gather the clipped row and send no
    gradient. The kernel is right for unsorted ids too (it checks every
    id), only slower."""
    if (perm is None) != (ids_sorted is None):
        raise ValueError("perm and ids_sorted must be passed together")
    return _GatherSortedGrad.apply(table, indices, perm, ids_sorted)
