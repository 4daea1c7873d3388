"""SDDMM: per-edge scores from dense node factors (counterpart of
``bignn_tpu/ops/sddmm.py`` and ``bignn_tpu/ops/pallas/sddmm.py``).

For each edge s -> d, ``score[e] = <q[d], k[s]>``, per head for ``[N, H, D]``
factors: only existing edges are scored, never the dense ``[N, N]`` matrix.
The JAX package has no kernel for it either (its Pallas entry point is the
XLA composition: two clipped gathers and a dot, which XLA fuses), so this is
plain PyTorch on every device, differentiable by autograd.
"""

from __future__ import annotations

import torch

from bignn_tpu_torch.ops.gather import gather_rows


def sddmm(q: torch.Tensor, k: torch.Tensor, src: torch.Tensor,
          dst: torch.Tensor) -> torch.Tensor:
    """``[E]`` (for ``[N, D]`` factors) or ``[E, H]`` (for ``[N, H, D]``):
    ``sum_f q[dst_e, ..., f] * k[src_e, ..., f]``, with out-of-range ids
    clipped to the nearest row, as ``jnp.take(..., mode="clip")`` does.
    The result has the factors' type."""
    return (gather_rows(q, dst) * gather_rows(k, src)).sum(-1)
