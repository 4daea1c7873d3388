"""Graph convolutions (counterpart of ``bignn_tpu/models/convs.py``).

A conv takes node states, the dst-sorted edge list of the JAX convs
(``edge_src``, ``edge_dst``, ``num_nodes``, the GCN weights
``edge_weight``, and the source-sort arrays ``src_perm``/``src_sorted``),
and optionally one of two dense adjacency forms, which it prefers in this
order, as the JAX convs do:
  * ``dense=(adj, cnt)``: ``[N, N]`` weights and multiplicities of a small
    outer graph;
  * ``block_dense=(block_adj, block_cnt)``: ``[N/128, 128, 128]`` blocks of
    the block-local inner layout (buckets of at most
    ``BLOCK_DENSE_MAX_NODES`` rows).
Without either, GCN and GIN aggregate over the edge list: ``ops.block_spmm``
when a block-local ``block_plan`` is given (larger buckets), else
``ops.spmm_sorted_coo`` (molecules over 128 atoms; a sparse outer graph).
``GATConv`` and ``DotAttnConv`` attend over the edge list when no dense
form is given (the outer graph above ``dense_max_nodes`` drugs; molecules
over 128 atoms): per-edge scores (``ops.gather_rows_sorted_grad`` for GAT,
``ops.sddmm`` for DotAttn), ``ops.segment_softmax`` and
``ops.spmm_multihead``. With a dense form both take the masked dense
attention of ``_dense_masked_softmax_agg`` (over ``[N, N]``, or per 128-row
block, which is exact because no molecule crosses a block), as the JAX
package's XLA path does; GAT's dense outer graph takes the flash-GAT kernel
instead. Each conv computes in its input's type (float32 or bf16) and casts
its float32 parameters to it. Every branch here is differentiable:
``torch.bmm``/``einsum`` and the autograd Functions of the ops.
"""

from __future__ import annotations

import math

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


def _dense_masked_softmax_agg(e: torch.Tensor, cnt: torch.Tensor,
                             v: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """Attention aggregation over an adjacency-count mask (JAX
    ``_dense_masked_softmax_agg`` and, with a leading block axis,
    ``_block_dense_masked_softmax_agg``, ``bignn_tpu/models/convs.py:
    32-67``).

    ``e`` ``[..., N, S, H]`` float32 scores before the softmax, ``cnt``
    ``[..., N, S]`` edge multiplicities (0: no edge; any numeric type),
    ``v`` ``[..., S, H, D]``; returns ``[..., N, H, D]`` in ``dtype``. A
    multiplicity m scales ``exp(e)`` by m, as m parallel edges do in the
    edge-list softmax; a row without edges (a padding block) gives 0. The
    max shift carries no gradient (the softmax does not depend on it); the
    masked ``where`` keeps ``exp`` finite for the backward. The weights are
    cast to ``dtype`` and the product sums in float32, rounded once to
    ``dtype``, as JAX's ``preferred_element_type`` einsum."""
    valid = (cnt > 0).unsqueeze(-1)
    m = torch.where(valid, e, -torch.inf).amax(dim=-2, keepdim=True)
    m = m.clamp_min(-1e30).detach()  # rows with no edges
    z = torch.where(valid, e - m, -1.0)
    p = cnt.unsqueeze(-1).float() * torch.exp(z)  # 0 exactly where invalid
    denom = p.sum(dim=-2, keepdim=True).clamp_min(1e-30)
    alpha = (p / denom).to(dtype)
    return torch.einsum("...dsh,...shf->...dhf", alpha.float(),
                        v.float()).to(dtype)


def _aggregate(x, edge_src, edge_dst, edge_weight, num_nodes, src_perm,
               src_sorted, block_plan, conv: str):
    """The edge-list aggregation of GCN (weighted) and GIN (``edge_weight``
    None); ``ops.spmm_sorted_coo`` takes the block-local route with a
    plan."""
    if edge_src is None:
        raise ValueError(f"{conv} needs an edge list or a dense form")
    return ops.spmm_sorted_coo(x, edge_src, edge_dst, edge_weight, num_nodes,
                               src_perm=src_perm, src_sorted=src_sorted,
                               block_plan=block_plan)


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
                src_perm=None, src_sorted=None, dense=None, block_dense=None,
                edge_weight=None, block_plan=None):
        h = self.lin(x)
        if dense is not None:
            agg = dense[0].to(h.dtype) @ h
        elif block_dense is not None:
            agg = ops.block_diag_spmm(block_dense[0], h)
        else:
            agg = _aggregate(h, edge_src, edge_dst, edge_weight, num_nodes,
                             src_perm, src_sorted, block_plan, "GCNConv")
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
                src_perm=None, src_sorted=None, dense=None, block_dense=None,
                edge_weight=None, block_plan=None):
        # GIN's sum is unweighted: edge_weight (the GCN weights) is unused
        if dense is not None:
            agg = dense[1].to(x.dtype) @ x
        elif block_dense is not None:
            agg = ops.block_diag_spmm(block_dense[1], x)
        else:
            agg = _aggregate(x, edge_src, edge_dst, None, num_nodes, src_perm,
                             src_sorted, block_plan, "GINConv")
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
                src_perm=None, src_sorted=None, dense=None, block_dense=None,
                edge_weight=None, block_plan=None):
        # attention replaces the fixed weights
        heads, head_dim = self.heads, self.head_dim
        hh = self.lin(x).view(-1, heads, head_dim)
        score_l = (hh * self.a_l.to(x.dtype)).sum(-1)  # [N, H], destination
        score_r = (hh * self.a_r.to(x.dtype)).sum(-1)  # [N, H], source half
        if block_dense is not None:
            # masked attention per 128-row block: exact, since no molecule
            # crosses a block; padding blocks aggregate to 0
            cnt = block_dense[1]
            nblk = cnt.shape[0]
            e = F.leaky_relu(
                score_l.float().view(nblk, 128, 1, heads)
                + score_r.float().view(nblk, 1, 128, heads),
                self.negative_slope)
            agg = _dense_masked_softmax_agg(
                e, cnt, hh.view(nblk, 128, heads, head_dim), x.dtype)
        elif dense is not None:
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


class DotAttnConv(nn.Module):
    """Dot-product (transformer-style) attention: for an edge s -> d,
    ``e = <q_d, k_s> / sqrt(D)`` per head, softmax over d's incoming edges,
    ``x'_d = act(concat_h sum_s alpha v_s + b)``, with ``q``, ``k``, ``v``
    three bias-free projections of x."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 4,
                 activation: str = "relu"):
        super().__init__()
        if out_dim % heads:
            raise ValueError(
                f"out_dim {out_dim} not divisible by heads {heads}")
        self.in_dim, self.out_dim, self.heads = in_dim, out_dim, heads
        self.head_dim = out_dim // heads
        self.lin_q = Dense(in_dim, out_dim, use_bias=False)
        self.lin_k = Dense(in_dim, out_dim, use_bias=False)
        self.lin_v = Dense(in_dim, out_dim, use_bias=False)
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self._act = parse_activation(activation)

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        kq, kk, kv = prng.split(key, 3)
        return {**prefixed("lin_q.", self.lin_q.init_params(kq)),
                **prefixed("lin_k.", self.lin_k.init_params(kk)),
                **prefixed("lin_v.", self.lin_v.init_params(kv)),
                "bias": torch.zeros(self.out_dim)}

    def forward(self, x, edge_src=None, edge_dst=None, num_nodes=None,
                src_perm=None, src_sorted=None, dense=None, block_dense=None,
                edge_weight=None, block_plan=None):
        heads, head_dim = self.heads, self.head_dim
        q, k, v = (lin(x).view(-1, heads, head_dim)
                   for lin in (self.lin_q, self.lin_k, self.lin_v))
        scale = math.sqrt(head_dim)  # JAX divides by the float32 sqrt(D)
        if block_dense is not None:  # per-block q.k (block-local layout)
            cnt = block_dense[1]
            nblk = cnt.shape[0]
            qb, kb, vb = (t.view(nblk, 128, heads, head_dim) for t in (q, k, v))
            e = torch.einsum("bdhf,bshf->bdsh", qb.float(), kb.float()) / scale
            agg = _dense_masked_softmax_agg(e, cnt, vb, x.dtype)
        elif dense is not None:  # the whole [N, N, H] q.k, masked
            e = torch.einsum("dhf,shf->dsh", q.float(), k.float()) / scale
            agg = _dense_masked_softmax_agg(e, dense[1], v, x.dtype)
        elif edge_src is not None:
            e = ops.sddmm(q, k, edge_src, edge_dst).float() / scale  # [E, H]
            alpha = ops.segment_softmax(e, edge_dst, num_nodes)
            agg = ops.spmm_multihead(v, edge_src, edge_dst,
                                     alpha.to(x.dtype), num_nodes,
                                     src_perm=src_perm, src_sorted=src_sorted)
        else:
            raise ValueError("DotAttnConv needs an edge list or a dense form")
        return self._act(agg.reshape(-1, self.out_dim) + self.bias.to(x.dtype))


def parse_conv(spec: str, in_dim: int) -> nn.Module:
    """Build a conv from a layer spec such as ``"gcn:64"``, ``"gin:64"``,
    ``"gat:64:4"`` or ``"dotattn:64:4"``, with an optional trailing
    ``:activation``."""
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
        heads = nums[1] if len(nums) > 1 else 4
        return DotAttnConv(in_dim, nums[0], heads=heads, activation=act)
    raise ValueError(f"unknown conv spec {spec!r}")
