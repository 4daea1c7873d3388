"""The replicated state of the p2 run over several cards or processes
(what the JAX package gets from AD through ``shard_map``: ``pmean`` over
``graph``, ``bignn_tpu/parallel/step.py:123-126``, and the all-gather's
transpose).

Each process encodes its own graph shards and runs their outer layers; the
embedding rows of every shard are gathered in every process, and every
process scores the whole pair batch, so each holds the same loss ``L``.
The rule that counts every gradient once:

  * each process backpropagates ``L / nproc``;
  * the all-gather's backward (``gather_rows``) sums over the processes,
    in rank order, the cotangent of this process's own rows (each process
    holds ``1 / nproc`` of it, so the sum is the whole);
  * after the backward, every parameter's gradient is summed over the
    processes in rank order (``Replicas.step``): the scorer's ``nproc``
    shares make its whole gradient, the encode's and outer layers' partial
    gradients (each process's shards) make theirs.

The exchange (``make_exchange``) is built once beside the mesh, by every
process at once, and closed by whoever built it; the p2 step and scorer
take it (``parallel/step.py``). Every sum is the process group's
rank-order sum (``ProcessExchange.ordered_sum``), never an
``all_reduce``, so every process ends a step with the same bits,
repeatably (ROADMAP F7): on one host's card it reads every process's
buffer through CUDA IPC and adds them with PyTorch ops, across hosts or
cards and on the CPU it gathers through gloo and adds the same way.

One process over several cards (``CardExchange``) follows the same rule
with a card in place of a process: each card encodes its graph shards on
replicas of its own (``parallel/replicas.py``), the rows are gathered onto
every card (``gather_rows_cards``, whose backward adds the cards'
cotangents in card order), each card scores the whole batch and
backpropagates ``L / ncards``, and the replicas' gradients are added in
shard order (``Replicas.step``). So a mesh of one shard a card takes the
same steps, bit for bit, as as many processes of one shard each.

Several processes of several cards each (a ``make_hybrid_mesh`` mesh whose
local shards lie on distinct cards) follow it with a card of any process
in place of a card: every card of every process gathers every row
(``gather_rows_cards`` over a ``ProcessExchange``), scores the whole batch
and backpropagates ``L / total_cards``; the gather's backward and the
gradient sum add one term a card (a slot, for the gradients: a replica a
shard) in global order, (process, local card), never a partial sum a
process first (``(g0 + g1) + (g2 + g3)`` is not ``((g0 + g1) + g2) +
g3``). So two processes of two cards take the same step, bit for bit, as
one process over the four. Every collective across processes is one
autograd node over all of the process's cards, so it runs once, in the
same order in every process, whichever card's backward thread reaches it.
With one process on one card nothing here runs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bignn_tpu_torch.ops.collectives import (
    PeerExchange,
    ProcessExchange,
    check_cards,
    enable_peer_access,
)
from bignn_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_object,
    host_names,
    shard_device,
)


class CardExchange:
    """The data plane between the cards of one process, for a mesh's graph
    shards: ``devices``, each shard's device, and ``card_of``, each
    shard's card (default: by device; the CPU tests give each shard a
    "card" of its own on the one CPU). ``cards`` are the cards' devices in
    order, ``heads`` each card's first shard. The halo exchange needs
    nothing of it (``ops.all_to_all`` reads the buffers' devices); it
    enables peer access between the cards once and carries the gather of
    the embedding rows onto every card. ``close`` raises if a wait of an
    exchange over the cards had expired (``ops/collectives.py``
    ``check_cards``)."""

    def __init__(self, devices: Sequence, card_of: Sequence[int] | None = None):
        self.devices = [torch.device(d) for d in devices]
        if card_of is None:
            order = list(dict.fromkeys(self.devices))
            card_of = [order.index(d) for d in self.devices]
        self.card_of = [int(c) for c in card_of]
        self.size = max(self.card_of) + 1
        if sorted(set(self.card_of)) != list(range(self.size)):
            raise ValueError(f"cards {self.card_of} skip a number")
        self.heads = [self.card_of.index(c) for c in range(self.size)]
        self.cards = [self.devices[j] for j in self.heads]
        self._cuda = list(dict.fromkeys(d for d in self.devices
                                        if d.type == "cuda"))
        if len(self._cuda) > 1:
            enable_peer_access(self._cuda)

    def close(self) -> None:
        """Nothing to free (the collective ``close`` of the exchanges
        across processes); once the cards are synchronised, raise if an
        exchange's wait on them had expired."""
        if len(self._cuda) > 1:
            check_cards(self._cuda)


class _GatherToCards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, exchange, *h):
        ctx.rows = [x.shape[0] for x in h]
        ctx.devices = [x.device for x in h]
        ctx.tail, ctx.dtype = h[0].shape[1:], h[0].dtype
        return tuple(torch.cat([x.to(c) for x in h])
                     for c in exchange.cards)

    @staticmethod
    def backward(ctx, *g):
        out, start = [], 0
        for n, dev in zip(ctx.rows, ctx.devices):
            total = None
            for gc in g:  # in card order, as the processes' ordered sum
                part = (torch.zeros(n, *ctx.tail, dtype=ctx.dtype,
                                    device=dev)
                        if gc is None else gc[start:start + n].to(dev))
                total = part if total is None else total + part
            out.append(total)
            start += n
        return (None, *out)


def gather_rows_cards(h_locals: Sequence[torch.Tensor],
                      exchange: CardExchange | ProcessExchange
                      ) -> list[torch.Tensor]:
    """``[G*B, d]`` on each of ``exchange.cards``: every shard's rows in
    shard order, so the row index is the drug id; ``h_locals`` (each ``[B,
    d]`` on its shard's device) are every shard's (``CardExchange``) or
    this process's (``ProcessExchange``). The backward adds, for each
    shard's rows, every card's cotangent in card order, (process, card)
    across processes."""
    if isinstance(exchange, ProcessExchange):
        return list(_GatherAcrossProcesses.apply(exchange, *h_locals))
    return list(_GatherToCards.apply(exchange, *h_locals))


def make_exchange(mesh: Mesh) -> ProcessExchange | CardExchange | None:
    """The data plane of ``mesh``'s graph shards: across processes (a
    collective), over this process's shards on their devices,
    ``PeerExchange`` (CUDA IPC) when every process runs on one host
    (``host_names``, gathered by ``init_distributed``) on cards, and every
    process's cards reach every card of the mesh by peer access (or share
    it); ``ProcessExchange`` (through the host and gloo, the route between
    hosts) otherwise, on the CPU too. In one process, ``CardExchange`` for
    a mesh whose graph shards lie on distinct cards, None for one card
    (named several times) or the CPU. The caller closes it (``close``, a
    collective across processes) when the mesh's last step is done."""
    if mesh.process_count == 1:
        devices = [shard_device(mesh, j) for j in range(mesh.shape["graph"])]
        return CardExchange(devices) if len(set(devices)) > 1 else None
    cards = list(dict.fromkeys(mesh.devices.flat))
    devices = [shard_device(mesh, j) for j in mesh.local_graph]
    peers = all(d.type == "cuda" for d in devices) and all(
        c == d or (c.type == "cuda" and torch.cuda.is_available()
                   and torch.cuda.can_device_access_peer(d, c))
        for d in set(devices) for c in cards)
    one_host = len(set(host_names())) == 1
    # every process must choose alike: the exchange is built collectively
    peers = all(all_gather_object(peers))
    cls = PeerExchange if one_host and peers else ProcessExchange
    return cls(mesh.shape["graph"], mesh.local_graph, devices)


class _GatherAcrossProcesses(torch.autograd.Function):
    """Every process's rows onto each of this process's cards; one node
    over the process's cards (see the module docstring)."""

    @staticmethod
    def forward(ctx, exchange, *h):
        ctx.exchange, ctx.rows = exchange, h[0].shape[0]
        ctx.devices = [x.device for x in h]
        full = exchange.all_gather(torch.cat([x.to(exchange.device)
                                              for x in h]))
        ctx.shape, ctx.dtype = full.shape, full.dtype
        return tuple(full if i == 0 else full.to(c, copy=True)
                     for i, c in enumerate(exchange.cards))

    @staticmethod
    def backward(ctx, *g):
        ex = ctx.exchange
        # every card's cotangent of every row, in (process, card) order
        terms = ex.gather_parts([
            gc if gc is not None else torch.zeros(ctx.shape, dtype=ctx.dtype,
                                                  device=c)
            for gc, c in zip(g, ex.cards)])
        out = []
        for j, dev in zip(ex.local, ctx.devices):
            rows = slice(j * ctx.rows, (j + 1) * ctx.rows)
            total = terms[0][rows]
            for t in terms[1:]:
                total = total + t[rows]
            out.append(total.to(dev))
        return (None, *out)


def gather_rows(h_locals: Sequence[torch.Tensor],
                exchange: ProcessExchange) -> torch.Tensor:
    """``[G*B, d]`` on the exchange's first card (one card a process):
    this process's shards' rows ``h_locals`` (each ``[B, d]``) gathered
    with every other process's in shard order, so the row index is still
    the drug id; its backward sums the cotangent of this process's rows
    over the processes (see the module docstring)."""
    return gather_rows_cards(h_locals, exchange)[0]
