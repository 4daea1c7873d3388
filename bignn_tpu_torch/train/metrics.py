"""Link-prediction metrics: ROC-AUC and average precision (counterpart of
``bignn_tpu/train/metrics.py``).

  * NumPy host versions: exact, tie-aware AUC (Mann-Whitney rank sum).
  * torch device versions: sort-based and mask-aware, so scores need not
    leave the device; equal to the host versions, ties included.
"""

from __future__ import annotations

import numpy as np
import torch


def _average_ranks(scores: np.ndarray) -> np.ndarray:
    """1-based ranks with ties given the average rank (Mann-Whitney)."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact tie-aware ROC-AUC via the rank-sum statistic."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _average_ranks(scores)
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """Average precision (area under the PR curve, step interpolation)."""
    labels = np.asarray(labels).astype(np.float64)
    scores = np.asarray(scores, np.float64)
    n_pos = labels.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    tp = np.cumsum(labels[order])
    precision = tp / np.arange(1, len(labels) + 1)
    return float(np.sum(precision * labels[order]) / n_pos)


def _masked(labels, scores, mask):
    scores = scores.float()
    labels = labels.float()
    mask = torch.ones_like(labels) if mask is None else mask.float()
    eff = torch.where(mask > 0, scores, torch.finfo(torch.float32).min)
    return labels, mask, eff


def roc_auc_torch(labels: torch.Tensor, scores: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Exact tie-aware rank-sum AUC on the scores' device.

    A tie gets the average rank ``(searchsorted_left + searchsorted_right +
    1) / 2`` against the sorted scores. Masked entries go to the lowest
    rank block, and subtracting their count re-bases the valid ranks."""
    labels, mask, eff = _masked(labels, scores, mask)
    s = torch.sort(eff).values
    lo = torch.searchsorted(s, eff).float()
    hi = torch.searchsorted(s, eff, right=True).float()
    ranks = 0.5 * (lo + hi + 1.0) - (1.0 - mask).sum()
    n_pos = (labels * mask).sum()
    n_neg = mask.sum() - n_pos
    pos_rank_sum = (ranks * labels * mask).sum()
    return ((pos_rank_sum - n_pos * (n_pos + 1) / 2)
            / (n_pos * n_neg).clamp_min(1.0))


def average_precision_torch(labels: torch.Tensor, scores: torch.Tensor,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Average precision on the scores' device (stable order on ties, as
    the JAX version)."""
    labels, mask, eff = _masked(labels, scores, mask)
    order = torch.argsort(-eff, stable=True)
    l_sorted = (labels * mask)[order]
    tp = torch.cumsum(l_sorted, 0)
    seen = torch.cumsum(mask[order], 0)
    precision = tp / seen.clamp_min(1.0)
    return (precision * l_sorted).sum() / (labels * mask).sum().clamp_min(1.0)
