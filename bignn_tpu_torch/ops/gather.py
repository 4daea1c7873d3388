"""Row gathers (counterpart of ``bignn_tpu/ops/gather.py``)."""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` with out-of-range indices clipped to the nearest
    row, as ``jnp.take(..., mode="clip")`` does (padding-safe)."""
    return table[indices.long().clamp(0, table.shape[0] - 1)]


def permutation_scatter_rows(values: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """``out[idx[j]] = values[j]`` for a permutation ``idx``, computed as the
    gather ``values[argsort(idx)]``."""
    return values[torch.argsort(idx)]
