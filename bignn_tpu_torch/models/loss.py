"""Link-prediction loss (counterpart of ``bignn_tpu/models/loss.py``):
BCE with logits in the stable log-sum-exp form, with an optional mask for
padded pair slots."""

from __future__ import annotations

import torch


def bce_with_logits_elementwise(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """Per-example ``max(x, 0) - x * y + log(1 + exp(-|x|))``."""
    logits = logits.float()
    labels = labels.float()
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * labels + torch.log1p(torch.exp(-logits.abs())))


def bce_with_logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean binary cross-entropy; ``labels`` in {0, 1}, optional 0/1 mask
    (the mean over the unmasked entries)."""
    per = bce_with_logits_elementwise(logits, labels)
    if mask is not None:
        mask = mask.float()
        return (per * mask).sum() / mask.sum().clamp_min(1.0)
    return per.mean()
