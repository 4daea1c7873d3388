"""SDDMM: per-edge scores from dense node factors (counterpart of
``bignn_tpu/ops/sddmm.py`` and ``bignn_tpu/ops/pallas/sddmm.py``).

For each edge s -> d, ``score[e] = <q[d], k[s]>``, per head for ``[N, H, D]``
factors: only existing edges are scored, never the dense ``[N, N]`` matrix.
The JAX package has no kernel for it either (its Pallas entry point is the
XLA composition: two clipped gathers and a dot, which XLA fuses), so this is
that composition in PyTorch on every device. Its two gathers are
``gather_rows_sorted_grad``s, so their backward is a sorted segment sum
that repeats bit for bit on the card, where autograd's backward of a row
gather adds by float atomics (ROADMAP F7).
"""

from __future__ import annotations

import torch

from bignn_tpu_torch.ops.gather import gather_rows_sorted_grad, sort_ids


def sddmm(q: torch.Tensor, k: torch.Tensor, src: torch.Tensor,
          dst: torch.Tensor, src_perm: torch.Tensor | None = None,
          src_sorted: torch.Tensor | None = None) -> torch.Tensor:
    """``[E]`` (for ``[N, D]`` factors) or ``[E, H]`` (for ``[N, H, D]``):
    ``sum_f q[dst_e, ..., f] * k[src_e, ..., f]``, with out-of-range ids
    clipped to the nearest row, as ``jnp.take(..., mode="clip")`` does.
    The result has the factors' type. ``dst`` is sorted here
    (``sort_ids``), and so is ``src`` unless the caller gives its sort
    permutation and sorted ids (``src_perm``/``src_sorted``, int32: an
    edge list's plan)."""
    d_ids, d_perm, d_sorted = sort_ids(dst, q.shape[0])
    if src_perm is None:
        src, src_perm, src_sorted = sort_ids(src, k.shape[0])
    return (gather_rows_sorted_grad(q, d_ids, perm=d_perm, ids_sorted=d_sorted)
            * gather_rows_sorted_grad(k, src, perm=src_perm,
                                      ids_sorted=src_sorted)).sum(-1)
