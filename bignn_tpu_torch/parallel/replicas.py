"""The model and its optimizer replicated over the cards of one process
(what GSPMD gives every chip of a JAX mesh: replicated parameters, and the
gradient all-reduce after the backward), and the one update of every
train step.

A mesh over distinct cards runs each shard's work on its own card, so
each card needs the parameters. ``Replicas`` holds one copy of the model a
slot (a card for dp, a graph shard for p2), each with its own optimizer of
the same kind and hyperparameters: slot 0 is the caller's model and
optimizer, so checkpoints and evaluation read them as before. One slot
(one card, or a mesh that names one card several times) holds no copy,
and its update is the single-device one. An update (``update``):

  * ``zero_grad``, then the caller's forward and backward, each slot's
    work on its own copy, so each copy's ``.grad`` holds its slot's part;
  * ``step``: the parts added in slot order into one flat buffer an element
    type on slot 0's device (a missing gradient counts as zeros), across
    processes every slot of every process in (process, slot) order, one
    term a slot (``ProcessExchange.ordered_sum``), the clip by the global
    norm there, the same bits copied to every other slot, and every slot's
    optimizer steps. Every copy in every process takes the same update on
    the same bits, so the replicas stay equal to the bit.

Replicas follow slot 0: they start from its parameters and optimizer state,
and before an update (``refresh``) parameters or optimizer state loaded
into slot 0 since the last one (a resume, an ``init``) are copied to the
others; a parameter's version counter and the identity of the optimizer's
state tensors tell.

Autograd runs each card's backward on a thread of its own and would add
the gradients that reach one tensor from several cards in whatever order
the threads finish. The copies keep every parameter's gradient on its own
card; what crosses a card goes through ``parallel/comm.py``'s functions,
whose backward adds in fixed order, or through a ``.to`` of a tensor used
once, whose backward adds nothing.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch

from bignn_tpu_torch.ops.collectives import ProcessExchange


def _optimizer_like(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                    replica: torch.nn.Module) -> torch.optim.Optimizer:
    """An optimizer of ``optimizer``'s kind and param groups over
    ``replica``'s parameters (in ``model.parameters()``'s order)."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    params = list(replica.parameters())
    groups = []
    for g in optimizer.param_groups:
        missing = [p for p in g["params"] if id(p) not in index]
        if missing:
            raise ValueError("the optimizer updates tensors that are not "
                             "the model's parameters")
        groups.append({**{k: v for k, v in g.items() if k != "params"},
                       "params": [params[index[id(p)]] for p in g["params"]]})
    return type(optimizer)(groups)


class Replicas:
    """``model`` and ``optimizer`` (None: the copies only forward, for
    scoring) on each of ``devices``, one slot each, starting from the
    model's and the optimizer's state; ``devices[0]`` must be the model's
    device where there are copies (``cuda`` names the model's card). A
    device may repeat (the CPU tests' slots)."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer | None,
                 devices: Sequence):
        devices = [torch.device(d) for d in devices]
        first = next(model.parameters()).device
        if devices[0].index is None:  # "cuda": the model's card
            devices[0] = first
        if len(devices) > 1 and first != devices[0]:
            raise ValueError(f"the model lies on {first}, slot 0 on "
                             f"{devices[0]}")
        self.devices = devices
        self.models = [model] + [copy.deepcopy(model).to(d)
                                 for d in self.devices[1:]]
        self.optimizers = None
        if optimizer is not None:
            self.optimizers = [optimizer] + [
                _optimizer_like(optimizer, model, m) for m in self.models[1:]]
        self.sync()

    def __len__(self) -> int:
        return len(self.models)

    def params(self, slot: int) -> list[torch.nn.Parameter]:
        """Slot ``slot``'s parameters in its optimizer's order (the
        model's, without an optimizer)."""
        if self.optimizers is None:
            return list(self.models[slot].parameters())
        return [p for g in self.optimizers[slot].param_groups
                for p in g["params"]]

    def _now(self) -> tuple:
        """Slot 0's parameter versions and optimizer state tensors (held,
        so that a tensor freed since cannot lend its ``id`` to a new
        one)."""
        state = () if self.optimizers is None else tuple(
            t for s in self.optimizers[0].state.values()
            for t in s.values() if isinstance(t, torch.Tensor))
        return tuple(p._version for p in self.models[0].parameters()), state

    def _changed(self) -> bool:
        versions, state = self._now()
        return (versions != self._stamp[0] or len(state) != len(
            self._stamp[1]) or any(a is not b
                                   for a, b in zip(state, self._stamp[1])))

    def sync(self) -> None:
        """Copy slot 0's parameters, buffers and optimizer state to every
        other slot."""
        if len(self) > 1:
            state = self.models[0].state_dict()
            for m in self.models[1:]:
                m.load_state_dict(state)
            if self.optimizers is not None:
                opt_state = self.optimizers[0].state_dict()
                for opt in self.optimizers[1:]:
                    # a deep copy: a step counter on the host would
                    # otherwise be one tensor shared by two optimizers
                    opt.load_state_dict(copy.deepcopy(opt_state))
        self._stamp = self._now()

    def refresh(self, optimizer: torch.optim.Optimizer | None = None
                ) -> None:
        """``sync`` when slot 0 changed since the replicas last agreed;
        ``optimizer``, when it is not slot 0's any more (a trainer that made
        a fresh one), becomes slot 0's, with fresh ones like it for the
        others."""
        if optimizer is not None and (self.optimizers is None
                                      or optimizer is not self.optimizers[0]):
            self.optimizers = [optimizer] + [
                _optimizer_like(optimizer, self.models[0], m)
                for m in self.models[1:]]
            self.sync()
        elif len(self) > 1 and self._changed():
            self.sync()

    def zero_grad(self) -> None:
        for m in self.models:
            m.zero_grad(set_to_none=True)

    def update(self, loss_fn: Callable, grad_clip: float = 0.0,
               procs: ProcessExchange | None = None,
               optimizer: torch.optim.Optimizer | None = None
               ) -> torch.Tensor:
        """One update of every train step: ``refresh`` (with
        ``optimizer``), zero every slot's gradients, ``loss_fn()``, its
        backward, and ``step``. ``loss_fn`` returns the loss, or a list of
        losses each of the whole batch (one a card: the p2 step over cards);
        each holder of the whole loss backpropagates it over the count of
        holders, the losses' times ``procs.size`` for the multi-process p2
        run (as many cards in every process; ``parallel/comm.py``).
        Returns the first loss, detached, as a device scalar; the gradients
        stay in ``param.grad``."""
        self.refresh(optimizer)
        self.zero_grad()
        losses = loss_fn()
        if isinstance(losses, torch.Tensor):
            losses = [losses]
        n = len(losses) * (1 if procs is None else procs.size)
        roots = [loss / n for loss in losses] if n > 1 else losses
        if len(roots) == 1:
            roots[0].backward()
        else:  # one backward through every card's loss
            torch.autograd.backward(roots)
        self.step(grad_clip, procs)
        return losses[0].detach()

    def step(self, grad_clip: float = 0.0,
             procs: ProcessExchange | None = None) -> None:
        """After the backward: every slot's gradients summed in slot order
        on slot 0's device, across ``procs`` every slot of every process
        in (process, slot) order (``ProcessExchange.ordered_sum``), the
        clip by the global norm of every parameter the optimizer updates
        (``grad_clip``, as ``optax.clip_by_global_norm`` in JAX's
        ``make_optimizer`` chain; replicated parameters count once), the
        result copied to every slot, and every optimizer's step (see the
        module docstring)."""
        slots = [self.params(s) for s in range(len(self))]
        totals = []
        if procs is not None or len(self) > 1:
            dev0 = self.devices[0]
            groups: dict[torch.dtype, list[int]] = {}
            for i, p in enumerate(slots[0]):
                groups.setdefault(p.dtype, []).append(i)
            for idx in groups.values():
                flats = [torch.cat([
                    (ps[i].grad if ps[i].grad is not None
                     else torch.zeros_like(ps[i])).reshape(-1)
                    for i in idx]) for ps in slots]
                if procs is not None:
                    total = procs.ordered_sum(flats)
                else:
                    total = flats[0]
                    for flat in flats[1:]:
                        total = total + flat.to(dev0)
                totals.append((idx, total))
                _set_grads(slots[0], idx, total)
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(slots[0], grad_clip)
        for s in range(1, len(self)):
            for idx, total in totals:
                _set_grads(slots[s], idx,
                           total.to(self.devices[s], copy=True))
        for opt in self.optimizers:
            opt.step()
        self._stamp = self._now()


def _set_grads(params: list, idx: list[int], flat: torch.Tensor) -> None:
    start = 0
    for i in idx:
        p = params[i]
        n = p.numel()
        p.grad = flat[start:start + n].view_as(p)
        start += n
