"""Data parallelism (counterpart of ``bignn_tpu/parallel/dp.py``).

The pair batch splits over the mesh's ``dp`` axis; parameters and graph
structures are replicated. In the JAX package GSPMD shards the step and
inserts the gradient all-reduce; here one process drives the shards, with
a replica of the model and optimizer a card (``parallel/replicas.py``;
one replica on a mesh that names one card several times, or a tp mesh):

  * the replicated work, the inner encode and the outer propagation, runs
    once per step on each replica's card (as GSPMD runs it on every
    chip), not once per shard;
  * each shard scores its own slice of the pairs, its positives and the
    negatives drawn from them, on its replica;
  * the shards' (masked loss sum, mask count) pairs are added in shard
    order on the first card, as the ``psum`` over ``dp`` adds them (each
    other card's pairs moved there as one stacked tensor), and the loss is
    their ratio, the global masked mean;
  * one backward gives each replica's part of the gradients, the parts
    are added in card order (the shard order of their runs), and every
    replica takes the same optimizer step.

Negatives are drawn from the step's key over the global positives, as in
JAX, so the trajectory equals the single-device one on the same batch.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from bignn_tpu_torch import prng
from bignn_tpu_torch.data.sampler import sample_negative_pairs
from bignn_tpu_torch.models.bignn import BiGNN
from bignn_tpu_torch.models.loss import masked_sums, union_loss
from bignn_tpu_torch.parallel.mesh import Mesh
from bignn_tpu_torch.parallel.replicas import Replicas


def dp_size(mesh: Mesh) -> int:
    """The size of a dp-only mesh's ``dp`` axis (every other axis of size
    1), else ``ValueError``."""
    shape = dict(getattr(mesh, "shape", {}))
    if "dp" not in shape:
        raise ValueError("a DP mesh needs a 'dp' axis")
    if math.prod(shape.values()) != shape["dp"]:
        raise ValueError("a DP mesh must be dp-only (other axes size 1)")
    return int(shape["dp"])


def replica_layout(mesh: Mesh) -> tuple[list[torch.device], list[int]]:
    """A dp-only mesh's replicas: the distinct devices of its shards in
    order (one replica each), and each shard's replica."""
    shards = list(mesh.devices.flat)
    cards = list(dict.fromkeys(shards))
    return cards, [cards.index(d) for d in shards]


def shard_pairs(mesh: Mesh, pairs, mask) -> tuple[list, list]:
    """A ``[B, 2]`` pair batch and its ``[B]`` mask as ``dp`` contiguous
    shards (lists of views), on the mesh's first device; ``B % dp ==
    0``."""
    return _split(mesh.shape["dp"], mesh.first_device, pairs, mask)


def _split(dp: int, dev: torch.device, pairs, mask) -> tuple[list, list]:
    pairs = torch.as_tensor(pairs, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    if len(pairs) % dp or len(mask) != len(pairs):
        raise ValueError(f"{len(pairs)} pairs (mask {len(mask)}) do not "
                         f"split over dp={dp}")
    return list(pairs.chunk(dp)), list(mask.chunk(dp))


def dp_loss(reps: Replicas, slot_of: Sequence[int], key: prng.Key,
            pos_pairs, pos_mask, structures: Sequence[tuple],
            num_drugs: int, neg_ratio: int = 1) -> torch.Tensor:
    """The global masked-mean BCE of a dp step (see the module docstring):
    ``reps``' replica ``r`` encodes once on its device from
    ``structures[r]`` (its ``(buckets, graph_index, outer)``) and scores
    the shards ``s`` with ``slot_of[s] == r``. ``pos_pairs``/``pos_mask``
    are ``shard_pairs``' lists, or a whole batch that is split here, on
    replica 0's device."""
    dev0 = reps.devices[0]
    if not isinstance(pos_pairs, (list, tuple)):
        pos_pairs, pos_mask = _split(len(slot_of), dev0, pos_pairs, pos_mask)
    pos = torch.cat([torch.as_tensor(p, device=dev0) for p in pos_pairs])
    neg = sample_negative_pairs(key, pos, num_drugs, neg_ratio)
    neg = neg.view(neg_ratio, len(pos), 2)  # row (k, i) corrupts pair i
    embs = [m.propagate_outer(m.embed_drugs(b, g, o.num_nodes), o)
            for m, (b, g, o) in zip(reps.models, structures)]
    parts, start = [], 0
    for p, mk, r in zip(pos_pairs, pos_mask, slot_of):
        b, dev = len(p), reps.devices[r]
        pairs = torch.cat([torch.as_tensor(p, device=dev0),
                           neg[:, start:start + b].reshape(-1, 2)]).to(dev)
        mk = torch.as_tensor(mk, device=dev)
        labels = torch.cat([torch.ones(b, device=dev),
                            torch.zeros(b * neg_ratio, device=dev)])
        parts.append(masked_sums(reps.models[r].score_pairs(embs[r], pairs),
                                 labels, torch.cat([mk, mk.repeat(neg_ratio)])))
        start += b
    return union_over_replicas(parts, slot_of, dev0)


def union_over_replicas(parts: list, slot_of: Sequence[int],
                        dev: torch.device) -> torch.Tensor:
    """The masked-mean loss of the shards' (sum, count) ``parts`` (in shard
    order, each on its replica's device), on ``dev``, replica 0's: every
    other replica's parts stacked into one ``[k, 2]`` tensor, moved once
    (so each replica's backward starts from one cotangent), then all added
    in shard order."""
    stacks: dict[int, list] = {}
    for (num, den), r in zip(parts, slot_of):
        if r:
            stacks.setdefault(r, []).append(torch.stack([num, den]))
    moved = {r: torch.stack(v).to(dev) for r, v in stacks.items()}
    taken = dict.fromkeys(moved, 0)
    union = []
    for part, r in zip(parts, slot_of):
        if r:
            k, taken[r] = taken[r], taken[r] + 1
            part = (moved[r][k, 0], moved[r][k, 1])
        union.append(part)
    return union_loss(union)


class PerReplica:
    """``copies(name, obj)``: a structure on replica 0's device (the
    object itself) and its copy on every other replica's device, kept
    while the caller passes the same object under ``name``."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.held: dict[str, tuple] = {}

    def __call__(self, name: str, obj) -> list:
        held = self.held.get(name)
        if held is None or held[0] is not obj:
            held = (obj, [obj] + [_to(obj, d) for d in self.devices[1:]])
            self.held[name] = held
        return held[1]


def _to(x, dev: torch.device):
    """``x`` on ``dev``: by its own ``to``, or each item of a list."""
    if x is None or hasattr(x, "to"):
        return x if x is None else x.to(dev)
    return type(x)(_to(v, dev) for v in x)


def make_replicated_dp_step(model: BiGNN, optimizer: torch.optim.Optimizer,
                            devices, slot_of: Sequence[int], num_drugs: int,
                            neg_ratio: int = 1,
                            grad_clip: float = 0.0) -> Callable:
    """The dp step over ``devices``, one replica each (``devices[0]`` is
    ``model``'s; ``replica_layout(mesh)`` gives them for a mesh), and
    ``slot_of``, each dp shard's replica: ``step(key, pos_pairs, pos_mask,
    buckets, graph_index, outer) -> loss``, one ``Replicas.update`` of
    ``dp_loss`` (see the module docstring), the structures on
    ``devices[0]`` (copied to every replica's device while the same
    objects come). The CPU tests drive it with several replicas on the
    CPU."""
    reps = Replicas(model, optimizer, devices)
    copies = PerReplica(reps.devices)

    def step(key: prng.Key, pos_pairs, pos_mask, buckets, graph_index,
             outer) -> torch.Tensor:
        structures = list(zip(copies("buckets", buckets),
                              copies("graph_index", graph_index),
                              copies("outer", outer)))
        return reps.update(
            lambda: dp_loss(reps, slot_of, key, pos_pairs, pos_mask,
                            structures, num_drugs, neg_ratio), grad_clip)

    step.replicas = reps
    return step


def dp_train_step_fn(model: BiGNN, optimizer: torch.optim.Optimizer,
                     mesh: Mesh, num_drugs: int, neg_ratio: int = 1,
                     grad_clip: float = 0.0) -> Callable:
    """``step(key, pos_pairs, pos_mask, buckets, graph_index, outer) ->
    loss``: ``make_replicated_dp_step`` on ``mesh``, a replica a card of a
    dp-only mesh (``replica_layout``), one replica on a ``('dp', 'tp')``
    mesh (whose model holds its shards on their cards), for a dp-sharded
    batch (``shard_pairs``, or a whole ``[B, 2]`` batch with ``B % dp ==
    0``) whose structures lie on the mesh's first device. On a mesh of one
    shard it is the single-device step."""
    if "dp" not in mesh.axis_names:
        raise ValueError("a dp step needs a mesh with a 'dp' axis")
    if "tp" in mesh.axis_names:
        layout = [mesh.first_device], [0] * mesh.shape["dp"]
    else:
        dp_size(mesh)
        layout = replica_layout(mesh)
    return make_replicated_dp_step(model, optimizer, *layout, num_drugs,
                                   neg_ratio, grad_clip)
