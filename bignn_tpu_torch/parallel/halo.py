"""Halo exchange and the distributed outer layers (counterpart of
``bignn_tpu/parallel/halo.py``).

Each graph shard owns a contiguous drug block and every incoming edge of
its drugs (``parallel/partition.py``). The JAX functions are one shard's
body inside ``shard_map``; here one process runs every shard of the mesh,
as JAX's single controller does, so each layer is a lockstep over the
shards, with every per-shard argument a list over them:

  (a) every shard gathers (and, where the schedule says, transforms) the
      boundary rows each peer needs into its ``[G, S, F]`` send buffer;
  (b) one ``ops.all_to_all`` over the G send buffers;
  (c) every shard finishes its aggregation over its owned rows and the
      received ones (the extended array: row B + h*S + k is slot k from
      shard h).

The JAX schedules and numerics stay: GCN and GAT transform the boundary
rows first (the transform commutes with the row gather); GIN sends raw rows
and splits its aggregation by source locality, with 0/1 weights on the
sorted-COO SpMM; GAT's source logits ride in the same payload as its
features (``H*D + H`` wide); the plan's ``src_perm``/``src_sorted`` go to
every sorted-grad gather and SpMM. The layers take their parameters in
float32 as the JAX ones do, so a bf16 model's outer level computes in
float32 (JAX's ``jnp.dot`` of bf16 rows and float32 weights). ``remat``
recomputes GAT's attention in the backward
(``torch.utils.checkpoint``). JAX's ``impl="lax"|"pallas"`` switch has no
counterpart: the buffers' device picks the kernel or the plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bignn_tpu_torch import ops
from bignn_tpu_torch.models.convs import GATConv, GCNConv, GINConv

Shards = Sequence[torch.Tensor]


def _take(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` for an index array of any shape, clipped
    (``jnp.take(..., mode="clip")``); its backward adds a row's gradients
    in the order of their slots (``ops.sort_ids``), so that a seeded run
    repeats on the card (ROADMAP F7)."""
    ids, perm, ids_sorted = ops.sort_ids(idx.reshape(-1), h.shape[0])
    rows = ops.gather_rows_sorted_grad(h, ids, perm=perm,
                                       ids_sorted=ids_sorted)
    return rows.view(*idx.shape, *h.shape[1:])


def _dot(x: torch.Tensor, lin) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=f32)`` with float32 ``w``:
    ``x`` promoted to float32."""
    return lin(x.float())


def _extend(h: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """The extended array: owned rows, then the received ``[G, S, ...]``
    slots in shard order."""
    return torch.cat([h, recv.reshape(-1, *recv.shape[2:])])


def halo_exchange(h_locals: Shards, send_idx: Shards) -> list[torch.Tensor]:
    """Per shard the extended array ``[B + G*S, F]``: its owned rows
    ``[B, F]`` and the rows its peers sent it (``send_idx[g]`` ``[G, S]``:
    the local rows shard g sends to each shard)."""
    recv = ops.all_to_all([_take(h, i) for h, i in zip(h_locals, send_idx)])
    return [_extend(h, r) for h, r in zip(h_locals, recv)]


def _per_shard(*lists):
    """Zip per-shard argument lists; an absent list (None) gives None."""
    n = len(next(a for a in lists if a is not None))
    return zip(*(a if a is not None else [None] * n for a in lists))


# ---------------------------------------------------------------------------
# distributed outer layers, one exchange each
# ---------------------------------------------------------------------------


def dist_gcn_apply(conv: GCNConv, h_locals: Shards, src: Shards, dst: Shards,
                   weight: Shards, send_idx: Shards, src_perm=None,
                   src_sorted=None, remat: bool = False) -> list[torch.Tensor]:
    """Boundary-first: the ``[G, S]`` boundary rows are transformed and
    exchanged, then every shard transforms its ``[B, F]`` rows and
    aggregates over the extended array with the sorted-COO SpMM."""
    recv = ops.all_to_all([_dot(_take(h, i), conv.lin)
                           for h, i in zip(h_locals, send_idx)])
    out = []
    for h, r, s, d, w, perm, srt in _per_shard(h_locals, recv, src, dst,
                                               weight, src_perm, src_sorted):
        ext = _extend(_dot(h, conv.lin), r)
        agg = ops.spmm_sorted_coo(ext, s, d, w, h.shape[0], src_perm=perm,
                                  src_sorted=srt)
        out.append(conv._act(agg + conv.bias))
    return out


def _gin_finish(conv: GINConv, h: torch.Tensor,
                agg: torch.Tensor) -> torch.Tensor:
    """``act(MLP(agg + eps * h))`` with float32 parameters (JAX's type
    promotion: a bf16 aggregation is widened)."""
    return conv._act(conv.mlp(agg.float() + conv.eps * h.float()))


def dist_gin_apply(conv: GINConv, h_locals: Shards, src: Shards, dst: Shards,
                   weight: Shards, send_idx: Shards, src_perm=None,
                   src_sorted=None, remat: bool = False) -> list[torch.Tensor]:
    """GIN sends raw rows. Its aggregation is linear, so it splits by
    source locality: the owned-source edges (weight 1 where ``src < B``)
    and the halo-source edges (the complement), each a sorted-COO SpMM with
    0/1 weights over the same dst-sorted list. The locality clip and shift
    are monotone in ``src``, so the plan's one ``src_perm`` serves both,
    with ``src_sorted`` clipped and shifted alike."""
    del weight
    recv = ops.all_to_all([_take(h, i) for h, i in zip(h_locals, send_idx)])
    out = []
    for h, r, s, d, perm, srt in _per_shard(h_locals, recv, src, dst,
                                            src_perm, src_sorted):
        b = h.shape[0]
        halo = r.reshape(-1, *r.shape[2:])
        n_halo = halo.shape[0]
        w_loc = (s < b).float()
        loc_sorted = None if srt is None else srt.clamp(max=b - 1)
        rem_sorted = (None if srt is None
                      else (srt - b).clamp(0, max(n_halo - 1, 0)))
        agg = ops.spmm_sorted_coo(h, s.clamp(max=b - 1), d, w_loc, b,
                                  src_perm=perm, src_sorted=loc_sorted)
        agg = agg + ops.spmm_sorted_coo(
            halo, (s - b).clamp(0, max(n_halo - 1, 0)), d, 1.0 - w_loc, b,
            src_perm=perm, src_sorted=rem_sorted)
        out.append(_gin_finish(conv, h, agg))
    return out


def _gat_attention(conv: GATConv, score_l, score_r, src, dst, num_out,
                   src_perm, src_sorted, remat: bool) -> torch.Tensor:
    """``alpha [E, H]``: the destination and source halves of the scores
    gathered per edge (sorted-grad gathers; the source one through the
    plan's permutation where it has one), leaky ReLU, softmax per
    destination. ``remat`` recomputes it in the backward instead of
    keeping its ``[E, H]`` temporaries."""
    def attn(score_l, score_r):
        e_dst = ops.gather_rows_sorted_grad(score_l, dst)
        e_src = ops.gather_rows_sorted_grad(score_r, src, perm=src_perm,
                                            ids_sorted=src_sorted)
        e = F.leaky_relu(e_dst + e_src, conv.negative_slope)
        return ops.segment_softmax(e, dst, num_out)

    if remat:
        return checkpoint(attn, score_l, score_r, use_reentrant=False)
    return attn(score_l, score_r)


def _gat_finish(conv: GATConv, agg: torch.Tensor) -> torch.Tensor:
    return conv._act(agg.reshape(-1, conv.out_dim) + conv.bias)


def dist_gat_apply(conv: GATConv, h_locals: Shards, src: Shards, dst: Shards,
                   weight: Shards, send_idx: Shards, src_perm=None,
                   src_sorted=None, remat: bool = False) -> list[torch.Tensor]:
    """Boundary-first, as ``dist_gcn_apply``: the boundary rows are
    transformed and scored, and one payload ``[G, S, H*D + H]`` carries the
    features and the source logits."""
    del weight
    heads, head_dim = conv.heads, conv.head_dim
    width = heads * head_dim
    sendbufs = []
    for h, i in zip(h_locals, send_idx):
        bnd_t = _dot(_take(h, i), conv.lin)  # [G, S, H*D]
        sr_bnd = (bnd_t.view(*i.shape, heads, head_dim) * conv.a_r).sum(-1)
        sendbufs.append(torch.cat([bnd_t, sr_bnd], dim=-1))
    recv = ops.all_to_all(sendbufs)
    out = []
    for h, r, s, d, perm, srt in _per_shard(h_locals, recv, src, dst,
                                            src_perm, src_sorted):
        b = h.shape[0]
        h_t = _dot(h, conv.lin)
        hh = h_t.view(b, heads, head_dim)
        score_l = (hh * conv.a_l).sum(-1)  # [B, H], destination half
        score_r = (hh * conv.a_r).sum(-1)  # [B, H], source half
        ext = _extend(torch.cat([h_t, score_r], dim=1), r)
        h_ext = ext[:, :width].contiguous().view(-1, heads, head_dim)
        alpha = _gat_attention(conv, score_l, ext[:, width:], s, d, b, perm,
                               srt, remat)
        agg = ops.spmm_multihead(h_ext, s, d, alpha, b, src_perm=perm,
                                 src_sorted=srt)
        out.append(_gat_finish(conv, agg))
    return out


_DIST_APPLY = {GCNConv: dist_gcn_apply, GINConv: dist_gin_apply,
               GATConv: dist_gat_apply}


# ---------------------------------------------------------------------------
# one shard's layer over an extended array exchanged earlier as raw
# embeddings (the overlap path: GCN's transform commutes with the
# aggregation, GIN and GAT only need raw source rows)
# ---------------------------------------------------------------------------


def dist_gcn_apply_ext(conv: GCNConv, h_local, ext, src, dst, weight,
                       src_perm=None, src_sorted=None, remat: bool = False):
    agg = ops.spmm_sorted_coo(_dot(ext, conv.lin), src, dst, weight,
                              h_local.shape[0], src_perm=src_perm,
                              src_sorted=src_sorted)
    return conv._act(agg + conv.bias)


def dist_gin_apply_ext(conv: GINConv, h_local, ext, src, dst, weight,
                       src_perm=None, src_sorted=None, remat: bool = False):
    del weight
    agg = ops.spmm_sorted_coo(ext, src, dst, None, h_local.shape[0],
                              src_perm=src_perm, src_sorted=src_sorted)
    return _gin_finish(conv, h_local, agg)


def dist_gat_apply_ext(conv: GATConv, h_local, ext, src, dst, weight,
                       src_perm=None, src_sorted=None, remat: bool = False):
    del weight
    b = h_local.shape[0]
    hh_ext = _dot(ext, conv.lin).view(-1, conv.heads, conv.head_dim)
    score_l = (hh_ext[:b] * conv.a_l).sum(-1)  # [B, H]
    score_r = (hh_ext * conv.a_r).sum(-1)  # [B + G*S, H]
    alpha = _gat_attention(conv, score_l, score_r, src, dst, b, src_perm,
                           src_sorted, remat)
    agg = ops.spmm_multihead(hh_ext, src, dst, alpha, b, src_perm=src_perm,
                             src_sorted=src_sorted)
    return _gat_finish(conv, agg)


_DIST_APPLY_EXT = {GCNConv: dist_gcn_apply_ext, GINConv: dist_gin_apply_ext,
                   GATConv: dist_gat_apply_ext}


def _apply_fn(table: dict, conv):
    try:
        return table[type(conv)]
    except KeyError:
        raise NotImplementedError(
            f"distributed outer layer for {type(conv).__name__}") from None


def p2_overlap_forward(model, bnd_batches, int_batches, edge_src: Shards,
                       edge_dst: Shards, edge_weight: Shards,
                       send_idx: Shards, src_perm=None, src_sorted=None,
                       encode_fn=None, remat: bool = False
                       ) -> list[torch.Tensor]:
    """The bi-level forward with the overlap schedule: every shard encodes
    its boundary molecules, their raw embeddings enter the exchange, and
    the interior molecules encode after it is issued (on one card, in
    stream order behind it). Outer layer 1 works off the raw extended
    array; deeper layers use the boundary-first layers. ``encode_fn``
    replaces ``model.encode_inner`` (the step passes a checkpointed encode
    under ``remat``). Returns each shard's ``[B, d]``."""
    enc = encode_fn if encode_fn is not None else model.encode_inner
    h_bnd = [enc(b) for b in bnd_batches]
    recv = ops.all_to_all([_take(h, i) for h, i in zip(h_bnd, send_idx)])
    h_locals = [hb + enc(b) for hb, b in zip(h_bnd, int_batches)]
    for i, conv in enumerate(model.outer):
        if i == 0:
            fn = _apply_fn(_DIST_APPLY_EXT, conv)
            h_locals = [
                fn(conv, h, _extend(h, r), s, d, w, src_perm=perm,
                   src_sorted=srt, remat=remat)
                for h, r, s, d, w, perm, srt in _per_shard(
                    h_locals, recv, edge_src, edge_dst, edge_weight,
                    src_perm, src_sorted)]
        else:
            h_locals = _apply_fn(_DIST_APPLY, conv)(
                conv, h_locals, edge_src, edge_dst, edge_weight, send_idx,
                src_perm=src_perm, src_sorted=src_sorted, remat=remat)
    return h_locals


def dist_outer_forward(model, h_locals: Shards, edge_src: Shards,
                       edge_dst: Shards, edge_weight: Shards,
                       send_idx: Shards, src_perm=None, src_sorted=None,
                       remat: bool = False) -> list[torch.Tensor]:
    """The distributed ``BiGNN.propagate_outer``: each shard's ``[B, F]``
    drug rows through the outer layers; returns each shard's output."""
    for conv in model.outer:
        h_locals = _apply_fn(_DIST_APPLY, conv)(
            conv, h_locals, edge_src, edge_dst, edge_weight, send_idx,
            src_perm=src_perm, src_sorted=src_sorted, remat=remat)
    return h_locals
