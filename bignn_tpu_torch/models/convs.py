"""Graph convolutions (counterpart of ``bignn_tpu/models/convs.py``).

A conv takes node states, the dst-sorted edge list of the JAX convs
(``edge_src``, ``edge_dst``, ``num_nodes``, and the source-sort arrays
``src_perm``/``src_sorted``), and optionally one of two dense adjacency
forms, which it prefers where it has a branch for them:
  * ``dense=(adj, cnt)``: ``[N, N]`` weights and multiplicities of a small
    outer graph;
  * ``block_dense=(block_adj, block_cnt)``: ``[N/128, 128, 128]`` blocks of
    the block-local inner layout.
Each conv computes in its input's type (float32 or bf16) and casts its
float32 parameters to it. ``GATConv`` runs the edge list when no dense form
is given (the outer graph above ``dense_max_nodes`` drugs): ``ops.gather_rows_sorted_grad``,
``ops.segment_softmax`` and ``ops.spmm_multihead``. The streaming branches
of GCN and GIN (Queue 2 row 7, ROADMAP Queue 1 item 4) and DotAttnConv are
still to port and raise. Every branch here is differentiable:
``torch.bmm`` and the autograd Functions of the ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bignn_tpu_torch import ops, prng
from bignn_tpu_torch.models.modules import (
    MLP,
    Dense,
    glorot,
    parse_activation,
    prefixed,
)

_STREAMING = ("the streaming edge-list branch is still to port (ROADMAP "
              "Queue 1 item 4; its kernel is Queue 2 row 7)")


class GCNConv(nn.Module):
    """Kipf-Welling GCN: ``x' = act(A_norm (x W) + b)``; ``adj`` holds the
    symmetric-normalized weights incl. self-loops."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "relu"):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.lin = Dense(in_dim, out_dim, use_bias=False)
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self._act = parse_activation(activation)

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        return {**prefixed("lin.", self.lin.init_params(key)),
                "bias": torch.zeros(self.out_dim)}

    def forward(self, x, edge_src=None, edge_dst=None, num_nodes=None,
                src_perm=None, src_sorted=None, dense=None, block_dense=None):
        h = self.lin(x)
        if dense is not None:
            agg = dense[0].to(h.dtype) @ h
        elif block_dense is not None:
            agg = ops.block_diag_spmm(block_dense[0], h)
        else:
            raise NotImplementedError(f"GCNConv: {_STREAMING}")
        return self._act(agg + self.bias.to(x.dtype))


class GINConv(nn.Module):
    """GIN: ``x' = act(MLP((1 + eps) x + sum of neighbours))``.

    The layout carries self-loops, so the unweighted sum already holds x
    once and ``eps * x`` is added. eps is learnable."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int | None = None,
                 activation: str = "relu"):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        hidden = hidden_dim or out_dim
        self.mlp = MLP((in_dim, hidden, out_dim), activation)
        self.eps = nn.Parameter(torch.zeros(()))
        self._act = parse_activation(activation)

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        return {**prefixed("mlp.", self.mlp.init_params(key)),
                "eps": torch.zeros(())}

    def forward(self, x, edge_src=None, edge_dst=None, num_nodes=None,
                src_perm=None, src_sorted=None, dense=None, block_dense=None):
        if dense is not None:
            agg = dense[1].to(x.dtype) @ x
        elif block_dense is not None:
            agg = ops.block_diag_spmm(block_dense[1], x)
        else:
            raise NotImplementedError(f"GINConv: {_STREAMING}")
        return self._act(self.mlp(agg + self.eps.to(x.dtype) * x))


class GATConv(nn.Module):
    """GAT, additive attention with concatenated heads: for an edge s -> d,
    ``e = leaky_relu(a_l . Wx_d + a_r . Wx_s)``, softmax over d's incoming
    edges, ``x'_d = act(concat_h sum_s alpha Wx_s + b)``."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 4,
                 activation: str = "relu", negative_slope: float = 0.2):
        super().__init__()
        if out_dim % heads:
            raise ValueError(
                f"out_dim {out_dim} not divisible by heads {heads}")
        self.in_dim, self.out_dim, self.heads = in_dim, out_dim, heads
        self.head_dim = out_dim // heads
        self.negative_slope = negative_slope
        self.lin = Dense(in_dim, out_dim, use_bias=False)
        self.a_l = nn.Parameter(torch.zeros(heads, self.head_dim))
        self.a_r = nn.Parameter(torch.zeros(heads, self.head_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self._act = parse_activation(activation)

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        kw, kl, kr = prng.split(key, 3)
        return {**prefixed("lin.", self.lin.init_params(kw)),
                "a_l": glorot(kl, (self.heads, self.head_dim)),
                "a_r": glorot(kr, (self.heads, self.head_dim)),
                "bias": torch.zeros(self.out_dim)}

    def forward(self, x, edge_src=None, edge_dst=None, num_nodes=None,
                src_perm=None, src_sorted=None, dense=None, block_dense=None):
        if block_dense is not None:
            raise NotImplementedError(
                "GATConv: block-dense attention (GAT inner) is still to port")
        hh = self.lin(x).view(-1, self.heads, self.head_dim)
        score_l = (hh * self.a_l.to(x.dtype)).sum(-1)  # [N, H], destination
        score_r = (hh * self.a_r.to(x.dtype)).sum(-1)  # [N, H], source half
        if dense is not None:
            # the flash kernels take float32, as JAX hands them f32 scores
            agg, _ = ops.flash_gat_attention(
                score_l.float(), score_r.float(), hh.float(), dense[1],
                self.negative_slope)
            agg = agg.to(x.dtype)
        elif edge_src is not None:
            # dst is sorted; src goes through the source-sort permutation,
            # so both gathers have a sorted-segment-sum backward
            e = ops.gather_rows_sorted_grad(score_l, edge_dst) + \
                ops.gather_rows_sorted_grad(score_r, edge_src, perm=src_perm,
                                            ids_sorted=src_sorted)
            e = F.leaky_relu(e, self.negative_slope)  # [E, H]
            alpha = ops.segment_softmax(e, edge_dst, num_nodes)
            agg = ops.spmm_multihead(hh, edge_src, edge_dst, alpha,
                                     num_nodes, src_perm=src_perm,
                                     src_sorted=src_sorted)
        else:
            raise ValueError("GATConv needs an edge list or dense=")
        return self._act(agg.reshape(-1, self.out_dim) + self.bias.to(x.dtype))


def parse_conv(spec: str, in_dim: int) -> nn.Module:
    """Build a conv from a layer spec such as ``"gcn:64"``, ``"gin:64"`` or
    ``"gat:64:4"``, with an optional trailing ``:activation``."""
    parts = spec.split(":")
    kind = parts[0].lower()
    args = parts[1:]
    act = args[-1] if args and not args[-1].isdigit() else "relu"
    nums = [int(a) for a in args if a.isdigit()]
    if kind == "gcn":
        return GCNConv(in_dim, nums[0], activation=act)
    if kind == "gin":
        hidden = nums[1] if len(nums) > 1 else None
        return GINConv(in_dim, nums[0], hidden_dim=hidden, activation=act)
    if kind == "gat":
        heads = nums[1] if len(nums) > 1 else 4
        return GATConv(in_dim, nums[0], heads=heads, activation=act)
    if kind == "dotattn":
        raise NotImplementedError(
            "DotAttnConv is still to port (ROADMAP Queue 1 item 4)")
    raise ValueError(f"unknown conv spec {spec!r}")
