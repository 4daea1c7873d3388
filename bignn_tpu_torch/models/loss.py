"""Link-prediction loss (counterpart of ``bignn_tpu/models/loss.py``):
BCE with logits in the stable log-sum-exp form, with an optional mask for
padded pair slots."""

from __future__ import annotations

from typing import Sequence

import torch


def bce_with_logits_elementwise(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """Per-example ``max(x, 0) - x * y + log(1 + exp(-|x|))``."""
    logits = logits.float()
    labels = labels.float()
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * labels + torch.log1p(torch.exp(-logits.abs())))


def masked_sums(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch's (sum of the masked per-example BCE, mask count): the
    pair whose ratio is its masked mean, and which data-parallel shards
    add."""
    per = bce_with_logits_elementwise(logits, labels)
    mask = mask.float()
    return (per * mask).sum(), mask.sum()


def union_loss(parts: Sequence[tuple[torch.Tensor, torch.Tensor]]
               ) -> torch.Tensor:
    """``sum_s num_s / max(sum_s den_s, 1)`` of ``masked_sums`` pairs, added
    in order: the masked mean over the union of their batches."""
    num, den = parts[0]
    for n, d in parts[1:]:
        num, den = num + n, den + d
    return num / den.clamp_min(1.0)


def bce_with_logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean binary cross-entropy; ``labels`` in {0, 1}, optional 0/1 mask
    (the mean over the unmasked entries)."""
    if mask is None:
        return bce_with_logits_elementwise(logits, labels).mean()
    return union_loss([masked_sums(logits, labels, mask)])
