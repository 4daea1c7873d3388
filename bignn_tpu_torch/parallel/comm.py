"""The replicated state of the multi-process p2 run (what the JAX package
gets from AD through ``shard_map``: ``pmean`` over ``graph``,
``bignn_tpu/parallel/step.py:123-126``, and the all-gather's transpose).

Each process encodes its own graph shards and runs their outer layers; the
embedding rows of every shard are gathered in every process, and every
process scores the whole pair batch, so each holds the same loss ``L``.
The rule that counts every gradient once:

  * each process backpropagates ``L / nproc``;
  * the all-gather's backward (``gather_rows``) sums over the processes,
    in rank order, the cotangent of this process's own rows (each process
    holds ``1 / nproc`` of it, so the sum is the whole);
  * after the backward, every parameter's gradient is summed over the
    processes in rank order (``sum_grads``): the scorer's ``nproc``
    shares make its whole gradient, the encode's and outer layers' partial
    gradients (each process's shards) make theirs.

The exchange (``make_exchange``) is built once beside the mesh, by every
process at once, and closed by whoever built it; the p2 step and scorer
take it (``parallel/step.py``). Every sum is the process group's
rank-order sum (``ProcessExchange.ordered_sum``), never an
``all_reduce``, so every process ends a step with the same bits,
repeatably (ROADMAP F7): on one host's card it reads every process's
buffer through CUDA IPC and adds them with PyTorch ops, across hosts or
cards and on the CPU it gathers through gloo and adds the same way. With one process
nothing here runs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bignn_tpu_torch.ops.collectives import PeerExchange, ProcessExchange
from bignn_tpu_torch.parallel.mesh import Mesh, host_names


def make_exchange(mesh: Mesh) -> ProcessExchange | None:
    """The data plane between ``mesh``'s processes for its graph shards (a
    collective): ``PeerExchange`` (CUDA IPC) when every process runs on one
    host (``host_names``, gathered by ``init_distributed``) and the mesh
    names one card for all of them; ``ProcessExchange`` (through the host
    and gloo, the route between hosts) otherwise, on the CPU too; None for
    a mesh of one process. The caller closes it (``close``, a collective)
    when the mesh's last step is done."""
    if mesh.process_count == 1:
        return None
    cards = set(mesh.devices.flat)
    one_card = len(cards) == 1 and next(iter(cards)).type == "cuda"
    one_host = len(set(host_names())) == 1
    cls = PeerExchange if one_host and one_card else ProcessExchange
    return cls(mesh.shape["graph"], mesh.local_graph, mesh.device)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, exchange, local):
        ctx.exchange, ctx.rows = exchange, local.shape[0]
        return exchange.all_gather(local)

    @staticmethod
    def backward(ctx, g):
        total = ctx.exchange.ordered_sum(g.contiguous())
        start = ctx.exchange.rank * ctx.rows
        return None, total[start:start + ctx.rows]


def gather_rows(h_locals: Sequence[torch.Tensor],
                exchange: ProcessExchange) -> torch.Tensor:
    """``[G*B, d]``: this process's shards' rows ``h_locals`` (each
    ``[B, d]``) gathered with every other process's in shard order, so the
    row index is still the drug id; its backward sums the cotangent of this
    process's rows over the processes (see the module docstring)."""
    return _GatherRows.apply(exchange, torch.cat(list(h_locals)))


def sum_grads(params: Sequence[torch.nn.Parameter],
              exchange: ProcessExchange) -> None:
    """Replace every parameter's gradient by its sum over the processes, in
    rank order (a parameter without one counts as zeros), one flat buffer
    per element type."""
    groups: dict[torch.dtype, list] = {}
    for p in params:
        groups.setdefault(p.dtype, []).append(p)
    for group in groups.values():
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in group])
        total = exchange.ordered_sum(flat)
        start = 0
        for p in group:
            n = p.numel()
            p.grad = total[start:start + n].view_as(p).clone()
            start += n
