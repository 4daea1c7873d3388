"""Graph convolutions (counterpart of ``bignn_tpu/models/convs.py``).

A conv takes node states and one of two dense adjacency forms:
  * ``dense=(adj, cnt)``: ``[N, N]`` weights and multiplicities of a small
    outer graph;
  * ``block_dense=(block_adj, block_cnt)``: ``[N/128, 128, 128]`` blocks of
    the block-local inner layout.
The streaming (edge-list) branches and DotAttnConv are still to port
(ROADMAP Queue 1 item 4, Queue 2 items 3 and 5-6) and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from bignn_tpu_torch import ops
from bignn_tpu_torch.models.modules import MLP, glorot_, parse_activation

_STREAMING = ("the streaming edge-list branch is still to port (ROADMAP "
              "Queue 1 item 4; its kernels are Queue 2 items 3, 5 and 6)")


class GCNConv(nn.Module):
    """Kipf-Welling GCN: ``x' = act(A_norm (x W) + b)``; ``adj`` holds the
    symmetric-normalized weights incl. self-loops."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "relu",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.lin = nn.Linear(in_dim, out_dim, bias=False)
        glorot_(self.lin.weight, in_dim, out_dim, generator)
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self._act = parse_activation(activation)

    def forward(self, x, dense=None, block_dense=None):
        h = self.lin(x)
        if dense is not None:
            agg = dense[0] @ h
        elif block_dense is not None:
            agg = ops.block_diag_spmm(block_dense[0], h)
        else:
            raise NotImplementedError(f"GCNConv: {_STREAMING}")
        return self._act(agg + self.bias)


class GINConv(nn.Module):
    """GIN: ``x' = act(MLP((1 + eps) x + sum of neighbours))``.

    The layout carries self-loops, so the unweighted sum already holds x
    once and ``eps * x`` is added. eps is learnable."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int | None = None,
                 activation: str = "relu",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        hidden = hidden_dim or out_dim
        self.mlp = MLP((in_dim, hidden, out_dim), activation,
                       generator=generator)
        self.eps = nn.Parameter(torch.zeros(()))
        self._act = parse_activation(activation)

    def forward(self, x, dense=None, block_dense=None):
        if dense is not None:
            agg = dense[1] @ x
        elif block_dense is not None:
            agg = ops.block_diag_spmm(block_dense[1], x)
        else:
            raise NotImplementedError(f"GINConv: {_STREAMING}")
        return self._act(self.mlp(agg + self.eps * x))


class GATConv(nn.Module):
    """GAT, additive attention with concatenated heads: for an edge s -> d,
    ``e = leaky_relu(a_l . Wx_d + a_r . Wx_s)``, softmax over d's incoming
    edges, ``x'_d = act(concat_h sum_s alpha Wx_s + b)``."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 4,
                 activation: str = "relu", negative_slope: float = 0.2,
                 generator: torch.Generator | None = None):
        super().__init__()
        if out_dim % heads:
            raise ValueError(
                f"out_dim {out_dim} not divisible by heads {heads}")
        self.in_dim, self.out_dim, self.heads = in_dim, out_dim, heads
        self.head_dim = out_dim // heads
        self.negative_slope = negative_slope
        self.lin = nn.Linear(in_dim, out_dim, bias=False)
        glorot_(self.lin.weight, in_dim, out_dim, generator)
        self.a_l = nn.Parameter(torch.empty(heads, self.head_dim))
        self.a_r = nn.Parameter(torch.empty(heads, self.head_dim))
        glorot_(self.a_l, heads, self.head_dim, generator)
        glorot_(self.a_r, heads, self.head_dim, generator)
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self._act = parse_activation(activation)

    def forward(self, x, dense=None, block_dense=None):
        if dense is None:
            where = ("block-dense attention (GAT inner)"
                     if block_dense is not None else _STREAMING)
            raise NotImplementedError(
                f"GATConv: {where}; only the dense outer branch is ported")
        hh = self.lin(x).view(-1, self.heads, self.head_dim)
        score_l = (hh * self.a_l).sum(-1)  # [N, H], destination half
        score_r = (hh * self.a_r).sum(-1)  # [N, H], source half
        agg, _ = ops.flash_gat_attention(score_l, score_r, hh, dense[1],
                                         self.negative_slope)
        return self._act(agg.reshape(-1, self.out_dim) + self.bias)


def parse_conv(spec: str, in_dim: int,
               generator: torch.Generator | None = None) -> nn.Module:
    """Build a conv from a layer spec such as ``"gcn:64"``, ``"gin:64"`` or
    ``"gat:64:4"``, with an optional trailing ``:activation``."""
    parts = spec.split(":")
    kind = parts[0].lower()
    args = parts[1:]
    act = args[-1] if args and not args[-1].isdigit() else "relu"
    nums = [int(a) for a in args if a.isdigit()]
    if kind == "gcn":
        return GCNConv(in_dim, nums[0], activation=act, generator=generator)
    if kind == "gin":
        hidden = nums[1] if len(nums) > 1 else None
        return GINConv(in_dim, nums[0], hidden_dim=hidden, activation=act,
                       generator=generator)
    if kind == "gat":
        heads = nums[1] if len(nums) > 1 else 4
        return GATConv(in_dim, nums[0], heads=heads, activation=act,
                       generator=generator)
    if kind == "dotattn":
        raise NotImplementedError(
            "DotAttnConv is still to port (ROADMAP Queue 1 item 4)")
    raise ValueError(f"unknown conv spec {spec!r}")
