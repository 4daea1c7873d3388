"""Pair scorers: two drug embeddings -> an interaction logit (counterpart of
``bignn_tpu/models/scorer.py``). ``forward`` scores ``[P, 2]`` id pairs;
``apply_one_vs_all`` scores drug u against every drug, for one u (``[]`` ->
``[N]``) or a batch (``[B]`` -> ``[B, N]``)."""

from __future__ import annotations

import torch
from torch import nn

from bignn_tpu_torch import ops, prng
from bignn_tpu_torch.models.modules import MLP, prefixed


def pair_rows(emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``emb[ids]`` (clipped) whose backward adds each drug's gradients in
    the order of its pairs (``ops.sort_ids``), so that a seeded training
    run repeats on the card (ROADMAP F7)."""
    ids, perm, ids_sorted = ops.sort_ids(ids, emb.shape[0])
    return ops.gather_rows_sorted_grad(emb, ids, perm=perm,
                                       ids_sorted=ids_sorted)


class DotScorer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        return {}

    def forward(self, emb, pairs):
        hu = pair_rows(emb, pairs[:, 0])
        hv = pair_rows(emb, pairs[:, 1])
        return (hu * hv).sum(-1)

    def apply_one_vs_all(self, emb, u):
        return emb[u] @ emb.T


class MLPScorer(nn.Module):
    """MLP on the symmetric pair features ``[u*v, |u-v|, u+v]``."""

    def __init__(self, dim: int, hidden: int = 64):
        super().__init__()
        self.dim, self.hidden = dim, hidden
        self.mlp = MLP((3 * dim, hidden, 1), "relu")

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        return prefixed("mlp.", self.mlp.init_params(key))

    def _score(self, hu, hv):
        feat = torch.cat([hu * hv, (hu - hv).abs(), hu + hv], dim=-1)
        return self.mlp(feat)[..., 0]

    def forward(self, emb, pairs):
        return self._score(pair_rows(emb, pairs[:, 0]),
                           pair_rows(emb, pairs[:, 1]))

    def apply_one_vs_all(self, emb, u):
        # u's row broadcasts over every v: no [N, 2] pairs, no row gathers
        return self._score(emb[u].unsqueeze(-2), emb)


def parse_scorer(spec: str, dim: int) -> nn.Module:
    parts = spec.split(":")
    kind = parts[0].lower()
    if kind == "dot":
        return DotScorer(dim)
    if kind == "mlp":
        hidden = int(parts[1]) if len(parts) > 1 else 64
        return MLPScorer(dim, hidden)
    raise ValueError(f"unknown scorer spec {spec!r}")
