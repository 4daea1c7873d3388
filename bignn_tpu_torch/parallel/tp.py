"""Feature sharding over ``tp`` (counterpart of ``bignn_tpu/parallel/tp.py``).

The JAX package annotates its parameters with shardings and GSPMD inserts
every collective. Here one process runs the sharded layers shard by shard,
on the mesh's ``tp`` devices (one card named ``tp`` times, or distinct
cards), with the collectives written out. The layout is JAX's (the
Megatron pairing):

  * inside each MLP (GIN's conv MLPs, the MLP pair scorer, the attention
    readout's gate) even layers are column-parallel: each shard computes
    its slice of the output features from its rows of the weight and its
    slice of the bias, and the activation stays sharded; odd layers are
    row-parallel: each shard multiplies its slice of the activation by its
    columns of the weight, the partial products are added in shard order
    (the all-reduce), then the replicated bias is added once;
  * a conv's own projections (GCN and GAT ``lin``, DotAttn ``lin_q``,
    ``lin_k``, ``lin_v``) are column-parallel, and the shards' outputs are
    concatenated (the all-gather) before the aggregation; the conv's bias
    is sharded the same way and gathered where the conv adds it;
  * ``a_l``, ``a_r``, GIN's ``eps``, the readout's projection and any axis
    that ``tp`` does not divide stay replicated.

The port's weights are ``[out, in]`` (``nn.Linear``) where JAX's ``w`` is
``[in, out]``: JAX's column-parallel ``P(None, 'tp')`` is ``("tp", None)``
here, and its row-parallel ``P('tp', None)`` is ``(None, "tp")``.

Over distinct cards each shard's slice of a layer lives on its card, and
the replicated parameters and every unsharded computation on the first
one: a column-parallel layer's input goes to every card
(``_Broadcast``, whose backward adds the cards' cotangents in shard order
on the input's card), and the shards' outputs (the all-gather) and
partial products (the all-reduce, added in shard order) come back to the
card that consumes them, the first.

``shard_params_tp`` returns a copy of the model whose sharded parameters
are tensors of their own, one a shard, so an optimizer over its
``parameters()`` keeps Adam's moments per shard; ``tp_train_step_fn``
steps it, with pairs sharded over ``dp`` as in ``parallel/dp.py``, and
``gather_params_tp`` gives back the whole state dict.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from bignn_tpu_torch.models.bignn import BiGNN
from bignn_tpu_torch.models.convs import DotAttnConv, GATConv, GCNConv
from bignn_tpu_torch.models.modules import MLP, Dense
from bignn_tpu_torch.parallel.dp import dp_train_step_fn
from bignn_tpu_torch.parallel.mesh import Mesh

COL = ("tp", None)  # a weight's rows: the output features
ROW = (None, "tp")  # a weight's columns: the input features
SHARDED = ("tp",)  # a bias
REPLICATED = ()

_MLPS = ("mlp", "gate")  # the attributes that hold an MLP
_PROJECTIONS = ("lin", "lin_q", "lin_k", "lin_v")


def _dense_specs(prefix: str, dense: Dense, tp: int, col: bool) -> dict:
    out_dim, in_dim = dense.weight.shape
    if col and out_dim % tp == 0:
        specs = {prefix + "weight": COL}
        if dense.bias is not None:
            specs[prefix + "bias"] = SHARDED
        return specs
    if not col and in_dim % tp == 0:
        return {prefix + "weight": ROW}
    return {}


def tp_param_specs(model: nn.Module, tp: int) -> dict[str, tuple]:
    """The sharding of each of ``model``'s parameters (state-dict name ->
    ``COL``, ``ROW``, ``SHARDED`` or ``REPLICATED``) by JAX's rules (see
    the module docstring). MLPs are told from conv stacks by module type,
    never by name: a GCN's ``lin``/``bias`` are never paired
    row-parallel."""
    specs = {name: REPLICATED for name, _ in model.named_parameters()}
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, MLP) and name.rsplit(".", 1)[-1] in _MLPS:
            for i, layer in enumerate(mod.layers):
                specs.update(_dense_specs(f"{prefix}layers.{i}.", layer, tp,
                                          col=i % 2 == 0))
        elif isinstance(mod, (GCNConv, GATConv, DotAttnConv)):
            for lin in _PROJECTIONS:
                if hasattr(mod, lin):
                    specs.update(_dense_specs(f"{prefix}{lin}.",
                                              getattr(mod, lin), tp, True))
            if mod.bias.shape[0] % tp == 0:
                specs[prefix + "bias"] = SHARDED
    return specs


def _split(t: torch.Tensor, dim: int, devices) -> nn.ParameterList:
    return nn.ParameterList(
        nn.Parameter(c.detach().clone().to(d))
        for c, d in zip(t.chunk(len(devices), dim), devices))


class _Broadcast(torch.autograd.Function):
    """``x`` on each of ``devices``; the backward adds the cotangents in
    the devices' order on ``x``'s device."""

    @staticmethod
    def forward(ctx, devices, x):
        ctx.device = x.device
        return tuple(x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                g = g.to(ctx.device)
                total = g if total is None else total + g
        return None, total


def _broadcast(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """``x`` for each shard: itself where every shard lies on its device,
    else a copy on each shard's device (``_Broadcast``)."""
    if all(d == x.device for d in devices):
        return [x] * len(devices)
    return list(_Broadcast.apply(list(devices), x))


class TPDense(nn.Module):
    """A ``Dense`` layer sharded over ``tp``: column-parallel (``COL``) or
    row-parallel (``ROW``). A column-parallel layer returns its
    feature-sharded activation, one tensor a shard in order, or with
    ``gather`` their concatenation. ``weight`` and ``bias`` give the whole
    tensors."""

    def __init__(self, dense: Dense, spec: tuple, devices, gather: bool):
        super().__init__()
        self.col = spec == COL
        self.gather = gather
        self._act = dense._act
        self.devices = list(devices)
        self.weight_shards = _split(dense.weight, 0 if self.col else 1,
                                    devices)
        if dense.bias is None:
            self.bias_shards = nn.ParameterList()
        elif self.col:
            self.bias_shards = _split(dense.bias, 0, devices)
        else:  # replicated
            self.bias_shards = _split(dense.bias, 0, devices[:1])

    @property
    def weight(self) -> torch.Tensor:
        return torch.cat([w.to(self.devices[0]) for w in self.weight_shards],
                         0 if self.col else 1)

    @property
    def bias(self) -> torch.Tensor | None:
        return (torch.cat([b.to(self.devices[0]) for b in self.bias_shards])
                if self.bias_shards else None)

    def forward(self, x):
        """A column-parallel layer takes a whole activation, a row-parallel
        one the shards of the column-parallel layer before it (the two
        share the sharded dimension), each on its shard's device; the
        result of a gathering or row-parallel layer lies on the first
        device."""
        if self.col:
            bias = list(self.bias_shards) or [None] * len(self.weight_shards)
            out = [self._act(F.linear(xs, w.to(xs.dtype),
                                      None if b is None else b.to(xs.dtype)))
                   for xs, w, b in zip(_broadcast(x, self.devices),
                                       self.weight_shards, bias)]
            if not self.gather:
                return out
            return torch.cat([o.to(x.device) for o in out], -1)  # all-gather
        y = None
        for xs, w in zip(x, self.weight_shards):  # the all-reduce, in order
            part = F.linear(xs, w.to(xs.dtype)).to(self.devices[0])
            y = part if y is None else y + part
        if self.bias_shards:
            y = y + self.bias_shards[0].to(y.dtype)
        return self._act(y)


class _Gather(nn.Module):
    """A sharded parameter read whole: its shards concatenated."""

    def __init__(self, devices):
        super().__init__()
        self.devices = list(devices)

    def forward(self, *shards: torch.Tensor) -> torch.Tensor:
        return torch.cat([s.to(self.devices[0]) for s in shards])

    def right_inverse(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return tuple(c.detach().clone().to(d) for c, d in
                     zip(x.chunk(len(self.devices)), self.devices))


def shard_params_tp(mesh: Mesh, model: BiGNN) -> BiGNN:
    """A copy of ``model`` with its parameters placed by
    ``tp_param_specs`` on the mesh's ``tp`` devices: each sharded weight
    (and its bias) as ``tp`` tensors of its own in a ``TPDense``, each
    sharded conv bias as ``tp`` tensors read whole through a
    parametrization. Its ``parameters()`` hold every shard once and every
    replicated parameter once; ``tp_specs`` holds the specs."""
    devices = list(mesh.devices[0])
    tp = mesh.shape["tp"]
    specs = tp_param_specs(model, tp)
    replica = copy.deepcopy(model).to(mesh.first_device)
    for name, mod in list(replica.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(mod, MLP) and name.rsplit(".", 1)[-1] in _MLPS:
            last = len(mod.layers) - 1
            for i, layer in enumerate(mod.layers):
                spec = specs[f"{prefix}layers.{i}.weight"]
                if spec != REPLICATED:
                    mod.layers[i] = TPDense(layer, spec, devices,
                                            gather=i == last)
        elif isinstance(mod, (GCNConv, GATConv, DotAttnConv)):
            for lin in _PROJECTIONS:
                if specs.get(f"{prefix}{lin}.weight") == COL:
                    setattr(mod, lin, TPDense(getattr(mod, lin), COL,
                                              devices, gather=True))
            if specs[prefix + "bias"] == SHARDED:
                parametrize.register_parametrization(mod, "bias",
                                                     _Gather(devices))
    replica.tp_specs = specs
    return replica


def gather_params_tp(replica: BiGNN) -> dict[str, torch.Tensor]:
    """The whole state dict (the original model's names) of a
    ``shard_params_tp`` copy: each sharded parameter's shards
    concatenated (for evaluation, checkpoints and tests)."""
    out = {}
    with torch.no_grad():
        for name in replica.tp_specs:
            path, attr = name.rsplit(".", 1)
            t = getattr(replica.get_submodule(path), attr)
            out[name] = t.detach().clone()
    return out


def tp_train_step_fn(model: BiGNN, optimizer: torch.optim.Optimizer,
                     mesh: Mesh, num_drugs: int, neg_ratio: int = 1,
                     grad_clip: float = 0.0) -> Callable:
    """``step(key, pos_pairs, pos_mask, buckets, graph_index, outer) ->
    loss``, as ``dp_train_step_fn``'s, on a ``('dp', 'tp')`` mesh:
    ``model`` is ``shard_params_tp``'s copy and ``optimizer`` updates its
    ``parameters()``; the pairs shard over ``dp``. ``grad_clip`` takes
    one global norm over every shard and every replicated parameter, each
    once."""
    if "tp" not in mesh.axis_names:
        raise ValueError("a tp step needs a mesh with a 'tp' axis")
    if not hasattr(model, "tp_specs"):
        raise ValueError("place the model's parameters with shard_params_tp "
                         "first")
    return dp_train_step_fn(model, optimizer, mesh, num_drugs, neg_ratio,
                            grad_clip)
