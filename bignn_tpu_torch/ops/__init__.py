"""Sparse ops of the port (counterpart of ``bignn_tpu/ops``).

Hand-written CUDA kernels (``bignn_tpu_torch/csrc``) run on CUDA tensors:
``segment_sum``, ``block_adjacency``, ``flash_gat_attention`` and its
backward ``flash_gat_attention_bwd``, ``segment_softmax`` and its backward
``segment_softmax_bwd``, ``spmm_multihead`` and its backward
``spmm_multihead_bwd``, ``gather_rows_sorted_grad_bwd``, the backward of
``gather_rows_sorted_grad``, ``spmm_sorted_coo`` and its backward
``spmm_sorted_coo_bwd``, ``block_spmm`` and its backward ``block_spmm_bwd``
(the same kernel on the transposed plan), ``segment_max`` and its
backward ``segment_max_bwd``, and
``all_to_all``, the exchange of the graph shards' send buffers in the
halo layers of ``parallel/halo.py`` (its backward the same exchange;
across processes through a ``ProcessExchange``, ``PeerExchange`` on the
card).
``sddmm`` (the per-edge scores of ``DotAttnConv``) is plain PyTorch, as
the JAX package leaves it to XLA.
``segment_sum``, ``flash_gat_attention``, ``segment_softmax``,
``spmm_multihead``, ``gather_rows_sorted_grad``, ``spmm_sorted_coo``,
``block_spmm``, ``segment_max`` and ``all_to_all`` are
``torch.autograd.Function``s, so
gradients flow through the kernels; ``segment_mean`` is two segment sums.
The tensor's device decides: a CPU tensor takes the op's plain PyTorch
version (``*_plain``, in the same module), a CUDA tensor launches the kernel
or raises. Nothing falls back. Each kernel wrapper counts its launches in a
``launches`` attribute.

Models call these through this module (``ops.segment_sum(...)``), so a
caller can substitute the plain versions for a reference run.
"""

from bignn_tpu_torch.ops.block_adj import (
    block_adjacency,
    block_adjacency_plain,
    block_diag_spmm,
)
from bignn_tpu_torch.ops.block_spmm import (
    block_spmm,
    block_spmm_bwd,
    block_spmm_plain,
)
from bignn_tpu_torch.ops.collectives import (
    PeerExchange,
    ProcessExchange,
    all_to_all,
    all_to_all_plain,
)
from bignn_tpu_torch.ops.flash_gat import (
    flash_gat_attention,
    flash_gat_attention_bwd,
    flash_gat_attention_bwd_plain,
    flash_gat_attention_plain,
)
from bignn_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_sorted_grad,
    gather_rows_sorted_grad_bwd,
    gather_rows_sorted_grad_bwd_plain,
    gather_rows_sorted_grad_plain,
    permutation_scatter_rows,
    sort_ids,
)
from bignn_tpu_torch.ops.multihead import (
    spmm_multihead,
    spmm_multihead_bwd,
    spmm_multihead_bwd_plain,
    spmm_multihead_plain,
)
from bignn_tpu_torch.ops.sddmm import sddmm
from bignn_tpu_torch.ops.segment import (
    segment_max,
    segment_max_bwd,
    segment_max_bwd_plain,
    segment_max_plain,
    segment_mean,
    segment_softmax,
    segment_softmax_bwd,
    segment_softmax_bwd_plain,
    segment_softmax_plain,
    segment_sum,
    segment_sum_plain,
)
from bignn_tpu_torch.ops.spmm import (
    spmm_sorted_coo,
    spmm_sorted_coo_bwd,
    spmm_sorted_coo_bwd_plain,
    spmm_sorted_coo_plain,
)

__all__ = [
    "PeerExchange",
    "ProcessExchange",
    "all_to_all",
    "all_to_all_plain",
    "block_adjacency",
    "block_adjacency_plain",
    "block_diag_spmm",
    "block_spmm",
    "block_spmm_bwd",
    "block_spmm_plain",
    "flash_gat_attention",
    "flash_gat_attention_bwd",
    "flash_gat_attention_bwd_plain",
    "flash_gat_attention_plain",
    "gather_rows",
    "gather_rows_sorted_grad",
    "gather_rows_sorted_grad_bwd",
    "gather_rows_sorted_grad_bwd_plain",
    "gather_rows_sorted_grad_plain",
    "permutation_scatter_rows",
    "sort_ids",
    "sddmm",
    "segment_max",
    "segment_max_bwd",
    "segment_max_bwd_plain",
    "segment_max_plain",
    "segment_mean",
    "segment_softmax",
    "segment_softmax_bwd",
    "segment_softmax_bwd_plain",
    "segment_softmax_plain",
    "segment_sum",
    "segment_sum_plain",
    "spmm_multihead",
    "spmm_multihead_bwd",
    "spmm_multihead_bwd_plain",
    "spmm_multihead_plain",
    "spmm_sorted_coo",
    "spmm_sorted_coo_bwd",
    "spmm_sorted_coo_bwd_plain",
    "spmm_sorted_coo_plain",
]
