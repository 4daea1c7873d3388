"""The edge-partitioned ("p2") train step and scorer on a dp x graph mesh
(counterpart of ``bignn_tpu/parallel/step.py``).

Per step:
  * inner level: each graph shard encodes the molecules of its own drugs
    (its union from ``build_sharded_inner``), with no exchange;
  * outer level: one halo exchange per layer (``parallel/halo.py``);
  * scoring: the shards' ``[B, d]`` outputs concatenated (JAX's
    ``all_gather`` over ``graph``), whose row index is the drug id, then the
    whole pair batch scored;
  * loss: the global masked mean of the BCE, which JAX's ``psum`` over
    ``dp`` of the slices' sums gives.

Over ``dp`` the replicas' graph forwards are identical (parameters and
unions are replicated), so with every shard on one card each graph shard is
computed once, and the ``dp`` slices of the pair batch, which all score the
same embeddings, are scored as one batch (the batch must still split over
``dp``, as in JAX). Gradients flow
back through the exchange by its own autograd Function; the optimizer is a
``torch.optim`` one over the model's parameters, updated in place as the
port's ``Trainer`` does.

Across processes (a ``make_hybrid_mesh`` mesh) each process uploads and
runs its own graph shards, the exchanges cross processes through the
mesh's exchange (``parallel.comm.make_exchange``, which the step and the
scorer take), the concatenation becomes an all-gather of the
shards' rows, every process scores the whole batch, and the gradients are
summed over the processes in rank order (``parallel/comm.py``), so every
process takes the same optimizer step.

On a mesh over distinct cards of one process (``CardExchange``) graph
shard j runs on card ``mesh.devices[0, j]`` with a replica of the model of
its own (``parallel/replicas.py``); the exchanges read the peers' memory,
each card gathers every shard's rows and scores the whole batch, as a
process does, and the replicas' gradients are added in shard order, so
every replica takes the same optimizer step (``parallel/comm.py``). Across
processes whose local shards lie on distinct cards (a ``ProcessExchange``
with several ``cards``) the same holds over every card of every process:
the exchanges and the gathers cross processes, and every sum adds one term
a card or a replica in (process, card) order. The ``dp`` rows of a column
compute the same forward, which runs once, on row 0's card (so JAX's dp =
2 x graph = 2 over two cards a process computes on one of each process's
two). With one process on one card every function gives the bits it gave
before.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from bignn_tpu_torch import prng
from bignn_tpu_torch.data.sampler import sample_negative_pairs
from bignn_tpu_torch.models.bignn import BiGNN, upload_batch
from bignn_tpu_torch.models.loss import bce_with_logits_loss
from bignn_tpu_torch.ops.collectives import ProcessExchange
from bignn_tpu_torch.parallel.comm import (
    CardExchange,
    gather_rows,
    gather_rows_cards,
    make_exchange,
)
from bignn_tpu_torch.parallel.halo import (
    dist_outer_forward,
    p2_overlap_forward,
)
from bignn_tpu_torch.parallel.mesh import Mesh, global_put, shard_device
from bignn_tpu_torch.parallel.replicas import Replicas
from bignn_tpu_torch.parallel.partition import (
    OuterPartitionPlan,
    unstack_batch,
)


def device_put_plan(mesh: Mesh, plan: OuterPartitionPlan, inner_batch,
                    inner_layers: Sequence[str]) -> tuple:
    """This process's shards' plan arrays and inner unions, each shard's
    on its device (``shard_device``).

    Every process builds the same plan from the shared seed and uploads only
    its graph shards (``mesh.local_graph``; every shard in one process):
    the plan arrays through ``global_put(mesh, ("graph",), ...)``.
    ``inner_batch`` is ``build_sharded_inner``'s stacked batch (or its
    ``(boundary, interior)`` pair); each local shard's union goes up
    through ``upload_batch``, the per-batch upload of ``upload_buckets``, so
    dense blocks are built on the device exactly where the host batch has
    them (``inner_layers``, the model's inner specs, say whether GCN
    weights are needed). Returns ``(inner, esrc, edst, ew, sidx, sperm,
    ssrt)`` in the JAX package's order, each a list over the local shards
    (``inner`` a pair of lists for a split batch)."""
    if plan.n_shards != mesh.shape["graph"]:
        raise ValueError(f"plan has {plan.n_shards} shards, the mesh's "
                         f"graph axis {mesh.shape['graph']}")
    local = mesh.local_graph

    def put(arr: np.ndarray) -> list[torch.Tensor]:
        return global_put(mesh, ("graph",), arr)

    def put_inner(stacked) -> list:
        return [upload_batch(unstack_batch(stacked, g), inner_layers,
                             shard_device(mesh, g)) for g in local]

    inner = (tuple(put_inner(b) for b in inner_batch)
             if isinstance(inner_batch, tuple) else put_inner(inner_batch))
    return (inner, put(plan.edge_src), put(plan.edge_dst),
            put(plan.edge_weight), put(plan.send_idx), put(plan.src_perm),
            put(plan.src_sorted))


def _shard_outputs(models, plan_d, overlap: bool, remat: bool,
                   exchange: ProcessExchange | None) -> list[torch.Tensor]:
    """Every (local) shard's inner encode and outer layers: its ``[B, d]``
    rows. ``models`` is one model, or one a shard."""
    inner, esrc, edst, ew, sidx, sperm, ssrt = plan_d
    if not isinstance(models, (list, tuple)):
        models = [models] * len(sidx)

    def encoder(model):
        if not remat:
            return model.encode_inner
        return lambda batch: checkpoint(model.encode_inner, batch,
                                        use_reentrant=False)

    encs = [encoder(m) for m in models]
    if overlap:
        bnd, interior = inner
        return p2_overlap_forward(models, bnd, interior, esrc, edst, ew,
                                  sidx, src_perm=sperm, src_sorted=ssrt,
                                  encode_fn=encs, remat=remat,
                                  exchange=exchange)
    return dist_outer_forward(models, [e(b) for e, b in zip(encs, inner)],
                              esrc, edst, ew, sidx, src_perm=sperm,
                              src_sorted=ssrt, remat=remat, exchange=exchange)


def _embed(model: BiGNN, plan_d, overlap: bool, remat: bool,
           exchange: ProcessExchange | None) -> torch.Tensor:
    """``[G*B, d]``: the shards' outputs concatenated (gathered over the
    processes)."""
    h = _shard_outputs(model, plan_d, overlap, remat, exchange)
    return torch.cat(h) if exchange is None else gather_rows(h, exchange)


def _check_dp(n: int, dp: int) -> None:
    if n % dp:
        raise ValueError(f"{n} pairs do not split over dp={dp}")


def _check_exchange(mesh: Mesh, exchange):
    """The exchange the step uses: ``exchange``, or for a mesh of one
    process over distinct cards ``make_exchange(mesh)`` when none is
    given. An exchange across processes must be over this process's
    shards of the mesh on their devices."""
    if mesh.process_count > 1:
        if not isinstance(exchange, ProcessExchange):
            raise ValueError(
                f"a mesh over {mesh.process_count} processes with exchange "
                f"{exchange}: it takes parallel.make_exchange(mesh)")
        devices = [shard_device(mesh, j) for j in mesh.local_graph]
        if (exchange.local, exchange.devices) != (mesh.local_graph, devices):
            raise ValueError(
                f"the exchange's shards {exchange.local} on "
                f"{[str(d) for d in exchange.devices]} are not this "
                f"process's shards of the mesh, {mesh.local_graph} on "
                f"{[str(d) for d in devices]}")
        return exchange
    if isinstance(exchange, ProcessExchange):
        raise ValueError("a mesh of one process with an exchange across "
                         "processes")
    if exchange is None:
        exchange = make_exchange(mesh)
    return exchange


def _per_card(exchange) -> bool:
    """Whether the step keeps a replica a shard: shards on distinct cards
    of one process, or of each process."""
    return isinstance(exchange, CardExchange) or (
        exchange is not None and len(exchange.cards) > 1)


def make_cards_train_step(model: BiGNN, optimizer: torch.optim.Optimizer,
                          exchange: CardExchange | ProcessExchange,
                          num_drugs: int, neg_ratio: int = 1,
                          overlap: bool = False, remat: bool = False,
                          grad_clip: float = 0.0, dp: int = 1) -> Callable:
    """The p2 step over several cards of one process (``CardExchange``) or
    of each process (a ``ProcessExchange`` with several ``cards``; see the
    module docstring): one replica of ``model`` and ``optimizer`` a local
    graph shard on its device (``exchange.devices``); each card
    (``exchange.cards``, its first shard's replica scoring) scores the
    whole batch on every shard's rows and backpropagates its loss over the
    count of cards (of every process); the replicas' gradients are added in
    shard order, (process, shard) across processes, and each replica
    steps. Returns card 0's loss. The CPU tests drive it with every shard's
    "card" on the CPU."""
    procs = exchange if isinstance(exchange, ProcessExchange) else None
    reps = Replicas(model, optimizer, exchange.devices)
    scorers = [reps.models[j] for j in exchange.heads]
    dev = exchange.devices[0]

    def losses_fn(key: prng.Key, pos_pairs, pos_mask, plan_d) -> list:
        pos = torch.as_tensor(pos_pairs, device=dev)
        pmask = torch.as_tensor(pos_mask, device=dev)
        neg = sample_negative_pairs(key, pos, num_drugs, neg_ratio)
        pairs = torch.cat([pos, neg])
        labels = torch.cat([torch.ones(len(pos), device=dev),
                            torch.zeros(len(neg), device=dev)])
        mask = torch.cat([pmask, pmask.repeat(neg_ratio)]).float()
        _check_dp(len(pairs), dp)
        embs = gather_rows_cards(
            _shard_outputs(reps.models, plan_d, overlap, remat, procs),
            exchange)
        return [bce_with_logits_loss(m.score_pairs(e, pairs.to(c)),
                                     labels.to(c), mask.to(c))
                for m, e, c in zip(scorers, embs, exchange.cards)]

    def step(key: prng.Key, pos_pairs, pos_mask, plan_d) -> torch.Tensor:
        return reps.update(
            lambda: losses_fn(key, pos_pairs, pos_mask, plan_d), grad_clip,
            procs=procs)

    step.replicas = reps
    return step


def make_p2_train_step(model: BiGNN, optimizer: torch.optim.Optimizer,
                       mesh: Mesh, num_drugs: int, neg_ratio: int = 1,
                       overlap: bool = False, remat: bool = False,
                       grad_clip: float = 0.0,
                       exchange: ProcessExchange | None = None) -> Callable:
    """``step(key, pos_pairs, pos_mask, plan_d) -> loss``: one optimizer
    step on ``[B, 2]`` positive pairs (``pos_mask`` ``[B]``), with
    ``neg_ratio`` negatives each drawn on the global batch from the
    ``prng`` key (``data/sampler.py``); ``plan_d`` is
    ``device_put_plan``'s tuple (built with ``split_boundary=overlap``).
    Returns the loss as a device scalar; the gradients stay in
    ``param.grad``.

    ``remat`` recomputes in the backward the inner encode's activations
    and the outer GAT's ``[E, H]`` attention temporaries instead of
    keeping them (``torch.utils.checkpoint``); values and gradients are
    unchanged. ``grad_clip`` clips by the global norm of the model's
    parameters, taken once over the whole model (they are replicated over
    the shards: ``Replicas.step``), after the gradients are summed over
    the processes. ``exchange`` is ``make_exchange(mesh)``
    (built here for a mesh of one process over distinct cards when not
    given); shards on distinct cards take ``make_cards_train_step``."""
    exchange = _check_exchange(mesh, exchange)
    if _per_card(exchange):
        return make_cards_train_step(model, optimizer, exchange, num_drugs,
                                     neg_ratio, overlap, remat, grad_clip,
                                     mesh.shape["dp"])
    dev = mesh.first_device

    def loss_fn(key: prng.Key, pos_pairs, pos_mask, plan_d) -> torch.Tensor:
        pos = torch.as_tensor(pos_pairs, device=dev)
        pmask = torch.as_tensor(pos_mask, device=dev)
        neg = sample_negative_pairs(key, pos, num_drugs, neg_ratio)
        pairs = torch.cat([pos, neg])
        labels = torch.cat([torch.ones(len(pos), device=dev),
                            torch.zeros(len(neg), device=dev)])
        mask = torch.cat([pmask, pmask.repeat(neg_ratio)]).float()
        _check_dp(len(pairs), mesh.shape["dp"])
        emb = _embed(model, plan_d, overlap, remat, exchange)
        return bce_with_logits_loss(model.score_pairs(emb, pairs), labels,
                                    mask)

    reps = Replicas(model, optimizer, [dev])

    def step(key: prng.Key, pos_pairs, pos_mask, plan_d) -> torch.Tensor:
        return reps.update(
            lambda: loss_fn(key, pos_pairs, pos_mask, plan_d), grad_clip,
            procs=exchange)

    return step


def make_p2_score_fn(model: BiGNN, mesh: Mesh, overlap: bool = False,
                     exchange: ProcessExchange | None = None) -> Callable:
    """``score(pairs, plan_d) -> logits``: float32 logits of ``[P, 2]``
    pairs (P divisible by ``dp``) from the distributed forward, for
    evaluation; ``exchange`` as for ``make_p2_train_step``. Over distinct
    cards each shard runs on a replica of ``model`` on its card (copied
    from ``model`` whenever it changed), and the rows (gathered across
    processes) are scored on the first card by ``model`` itself."""
    exchange = _check_exchange(mesh, exchange)
    dev = mesh.first_device
    procs = exchange if isinstance(exchange, ProcessExchange) else None
    reps = (Replicas(model, None, exchange.devices) if _per_card(exchange)
            else None)

    def score(pairs, plan_d) -> torch.Tensor:
        pairs = torch.as_tensor(pairs, device=dev)
        _check_dp(len(pairs), mesh.shape["dp"])
        with torch.no_grad():
            if reps is not None:
                reps.refresh()
            h = _shard_outputs(model if reps is None else reps.models,
                               plan_d, overlap, False, procs)
            emb = torch.cat([x.to(dev) for x in h])
            if procs is not None:
                emb = procs.all_gather(emb)
            return model.score_pairs(emb, pairs)

    return score
