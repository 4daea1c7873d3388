"""Data parallelism (counterpart of ``bignn_tpu/parallel/dp.py``).

The pair batch splits over the mesh's ``dp`` axis; parameters and graph
structures are replicated. In the JAX package GSPMD shards the step and
inserts the gradient all-reduce; here one process drives the shards, all
on one device (a mesh may name one card several times), so:

  * the replicated work, the inner encode and the outer propagation, runs
    once per step on that device, not once per shard;
  * each shard scores its own slice of the pairs: its positives and the
    negatives drawn from them;
  * the shards' (masked loss sum, mask count) pairs are added in shard
    order, as the ``psum`` over ``dp`` adds them, and the loss is their
    ratio, the global masked mean;
  * one backward gives the gradients of that loss, and one optimizer step
    follows.

Negatives are drawn from the step's key over the global positives, as in
JAX, so the trajectory equals the single-device one on the same batch.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from bignn_tpu_torch import prng
from bignn_tpu_torch.data.sampler import sample_negative_pairs
from bignn_tpu_torch.models.bignn import BiGNN
from bignn_tpu_torch.models.loss import masked_sums, union_loss
from bignn_tpu_torch.ops.collectives import ProcessExchange
from bignn_tpu_torch.parallel.comm import sum_grads
from bignn_tpu_torch.parallel.mesh import Mesh


def dp_size(mesh: Mesh) -> int:
    """The size of a dp-only mesh's ``dp`` axis (every other axis of size
    1), else ``ValueError``."""
    shape = dict(getattr(mesh, "shape", {}))
    if "dp" not in shape:
        raise ValueError("a DP mesh needs a 'dp' axis")
    if math.prod(shape.values()) != shape["dp"]:
        raise ValueError("a DP mesh must be dp-only (other axes size 1)")
    return int(shape["dp"])


def shard_pairs(mesh: Mesh, pairs, mask) -> tuple[list, list]:
    """A ``[B, 2]`` pair batch and its ``[B]`` mask as ``dp`` contiguous
    shards (lists of views), on the mesh's device; ``B % dp == 0``."""
    dp = mesh.shape["dp"]
    pairs = torch.as_tensor(pairs, device=mesh.device)
    mask = torch.as_tensor(mask, device=mesh.device)
    if len(pairs) % dp or len(mask) != len(pairs):
        raise ValueError(f"{len(pairs)} pairs (mask {len(mask)}) do not "
                         f"split over dp={dp}")
    return list(pairs.chunk(dp)), list(mask.chunk(dp))


def dp_loss(model: BiGNN, mesh: Mesh, key: prng.Key, pos_pairs, pos_mask,
            buckets, graph_index, outer, num_drugs: int,
            neg_ratio: int = 1) -> torch.Tensor:
    """The global masked-mean BCE of a dp step (see the module docstring).
    ``pos_pairs``/``pos_mask`` are ``shard_pairs``' lists, or a whole batch
    that is split here."""
    if not isinstance(pos_pairs, (list, tuple)):
        pos_pairs, pos_mask = shard_pairs(mesh, pos_pairs, pos_mask)
    dev = mesh.device
    pos = torch.cat(pos_pairs)
    neg = sample_negative_pairs(key, pos, num_drugs, neg_ratio)
    neg = neg.view(neg_ratio, len(pos), 2)  # row (k, i) corrupts pair i
    emb = model.propagate_outer(
        model.embed_drugs(buckets, graph_index, outer.num_nodes), outer)
    parts, start = [], 0
    for p, m in zip(pos_pairs, pos_mask):
        b = len(p)
        pairs = torch.cat([p, neg[:, start:start + b].reshape(-1, 2)])
        labels = torch.cat([torch.ones(b, device=dev),
                            torch.zeros(b * neg_ratio, device=dev)])
        parts.append(masked_sums(model.score_pairs(emb, pairs), labels,
                                 torch.cat([m, m.repeat(neg_ratio)])))
        start += b
    return union_loss(parts)


def optimizer_step(optimizer: torch.optim.Optimizer,
                   loss_fn: Callable[[], torch.Tensor],
                   grad_clip: float = 0.0,
                   procs: ProcessExchange | None = None) -> torch.Tensor:
    """One update of every train step: zero the gradients, ``loss_fn()``,
    its backward, a clip by the global norm of every parameter the
    optimizer updates (``grad_clip``, as ``optax.clip_by_global_norm`` in
    JAX's ``make_optimizer`` chain; replicated parameters count once), and
    the optimizer's step. With ``procs`` (the multi-process p2 run) each
    process backpropagates ``loss / nproc`` and the gradients are summed
    over the processes in rank order before the clip (``parallel/comm.py``),
    so every process takes the same step. Returns the loss, detached, as a
    device scalar; the gradients stay in ``param.grad``."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    if procs is None:
        loss.backward()
    else:
        (loss / procs.size).backward()
        sum_grads(params, procs)
    if grad_clip:
        torch.nn.utils.clip_grad_norm_(params, grad_clip)
    optimizer.step()
    return loss.detach()


def dp_train_step_fn(model: BiGNN, optimizer: torch.optim.Optimizer,
                     mesh: Mesh, num_drugs: int, neg_ratio: int = 1,
                     grad_clip: float = 0.0) -> Callable:
    """``step(key, pos_pairs, pos_mask, buckets, graph_index, outer) ->
    loss``: one ``optimizer_step`` on a dp-sharded batch (``shard_pairs``,
    or a whole ``[B, 2]`` batch with ``B % dp == 0``) whose structures lie
    on the mesh's device. On a mesh of one shard it is the single-device
    step."""
    if "dp" not in mesh.axis_names:
        raise ValueError("a dp step needs a mesh with a 'dp' axis")

    def step(key: prng.Key, pos_pairs, pos_mask, buckets, graph_index,
             outer) -> torch.Tensor:
        return optimizer_step(
            optimizer,
            lambda: dp_loss(model, mesh, key, pos_pairs, pos_mask, buckets,
                            graph_index, outer, num_drugs, neg_ratio),
            grad_clip)

    return step
