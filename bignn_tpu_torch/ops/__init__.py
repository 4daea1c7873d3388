"""Sparse ops of the port (counterpart of ``bignn_tpu/ops``).

Three ops run hand-written CUDA kernels (``bignn_tpu_torch/csrc``) on CUDA
tensors: ``segment_sum``, ``block_adjacency`` and ``flash_gat_attention``.
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
from bignn_tpu_torch.ops.flash_gat import (
    flash_gat_attention,
    flash_gat_attention_plain,
)
from bignn_tpu_torch.ops.gather import gather_rows, permutation_scatter_rows
from bignn_tpu_torch.ops.segment import segment_sum, segment_sum_plain

__all__ = [
    "block_adjacency",
    "block_adjacency_plain",
    "block_diag_spmm",
    "flash_gat_attention",
    "flash_gat_attention_plain",
    "gather_rows",
    "permutation_scatter_rows",
    "segment_sum",
    "segment_sum_plain",
]
