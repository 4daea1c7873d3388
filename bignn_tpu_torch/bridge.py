"""Carry a JAX ``BiGNN`` parameter tree into the port.

The JAX package keeps parameters as nested dicts (``bignn_tpu/models/
bignn.py:119-132``): ``inner/layer_i/mlp/layer_j/{w,b}``, ``inner/layer_i/
eps``, ``outer/layer_i/{w,a_l,a_r,b}`` (a GAT) or ``outer/layer_i/{wq,wk,wv,
b}`` (a DotAttn conv, at either level), ``scorer/mlp/layer_j/{w,b}``, and
for the attention readout ``readout/gate/layer_j/{w,b}`` and
``readout/proj``.
Leaves arrive as NumPy arrays (``jax.tree.map(np.asarray, params)``), so
this module needs no JAX. Renaming rules:
  * ``layer_i`` under ``inner``/``outer`` -> ``i``; under an MLP (``mlp``,
    the readout's ``gate``) -> ``layers.i``;
  * a Dense layer's ``w`` ``[in, out]`` -> ``weight`` ``[out, in]``
    (transposed), ``b`` -> ``bias``;
  * a conv's own ``w`` -> ``lin.weight`` (transposed), ``b`` -> ``bias``;
  * a DotAttn conv's ``wq``/``wk``/``wv`` -> ``lin_q.weight``/
    ``lin_k.weight``/``lin_v.weight`` (transposed);
  * the readout's ``proj`` ``[in, out]`` -> ``proj.weight`` (transposed);
  * ``eps`` (0-d), ``a_l``/``a_r`` (``[H, D]``) keep name and shape.

Optax's Adam state (``ScaleByAdamState``: ``count``, and ``mu`` and ``nu``
with the parameters' tree) goes through the same rules
(``optimizer_state_from_jax``), so a converted checkpoint resumes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


_MLPS = ("mlp", "gate")  # keys of an MLP's layer_j


def _rename(path: tuple[str, ...]) -> tuple[str, bool]:
    """(state-dict name, transpose?) of one JAX leaf path."""
    out: list[str] = []
    in_dense = False
    for i, key in enumerate(path[:-1]):
        if key.startswith("layer_"):
            idx = key[len("layer_"):]
            in_dense = i > 0 and path[i - 1] in _MLPS
            out += ["layers", idx] if in_dense else [idx]
        else:
            out.append(key)
    leaf = path[-1]
    if leaf == "proj":
        return ".".join(out + ["proj", "weight"]), True
    if leaf == "w":
        return ".".join(out + (["weight"] if in_dense else ["lin", "weight"])), True
    if leaf in ("wq", "wk", "wv"):
        return ".".join(out + [f"lin_{leaf[1]}", "weight"]), True
    if leaf == "b":
        return ".".join(out + ["bias"]), False
    if leaf in ("eps", "a_l", "a_r"):
        return ".".join(out + [leaf]), False
    raise ValueError(f"unknown JAX parameter {'/'.join(path)}")


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The port's state dict for a JAX parameter tree of NumPy leaves."""
    state = {}
    for path, leaf in _flatten(tree):
        name, transpose = _rename(path)
        arr = np.asarray(leaf, np.float32)
        state[name] = torch.tensor(arr.T if transpose else arr)
    return state


_ADAM_FIELDS = {"count", "mu", "nu"}


def _adam_states(node) -> list:
    """Every ``ScaleByAdamState`` in an optax state: a NamedTuple, or the
    dict of its fields that orbax restores without a target, at any depth
    (``optax.adam`` and ``optax.adamw`` hold it first in their chain,
    ``clip_by_global_norm`` one chain deeper)."""
    fields = getattr(node, "_fields", None)
    if fields is not None and _ADAM_FIELDS <= set(fields):
        return [node._asdict()]
    if isinstance(node, Mapping):
        if _ADAM_FIELDS <= set(node):
            return [node]
        return [s for v in node.values() for s in _adam_states(v)]
    if isinstance(node, (list, tuple)):
        return [s for v in node for s in _adam_states(v)]
    return []


def optimizer_state_from_jax(opt_state, params: Mapping[str, torch.Tensor]
                             ) -> dict:
    """The port's optimizer state for an optax Adam or AdamW state of NumPy
    leaves: ``{name: {"step", "exp_avg", "exp_avg_sq"}}``
    (``train.trainer.optimizer_state``'s layout),
    ``count`` as every parameter's float32 ``step`` (one tensor each, as
    ``torch.optim.Adam`` keeps it), ``mu``/``nu`` renamed and transposed
    as the parameters. ``params`` (the converted parameters) fixes the
    names and shapes: a missing or extra name, a shape that differs (a
    leading shard axis, say) or other than one Adam state raises."""
    found = _adam_states(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu) in the "
                         f"optimizer state, found {len(found)}")
    count = float(np.asarray(found[0]["count"]))
    mu, nu = (params_from_jax(found[0][k]) for k in ("mu", "nu"))
    for what, tree in (("mu", mu), ("nu", nu)):
        if tree.keys() != params.keys():
            raise ValueError(
                f"Adam's {what} names {sorted(tree.keys() ^ params.keys())} "
                "not both in it and in the parameters")
        for name, t in tree.items():
            if t.shape != params[name].shape:
                raise ValueError(f"Adam's {what} of {name} is "
                                 f"{tuple(t.shape)}, the parameter "
                                 f"{tuple(params[name].shape)}")
    return {name: {"step": torch.tensor(count, dtype=torch.float32),
                   "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for name in params}


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Load a JAX parameter tree into ``model`` (strict: every parameter
    must be matched); returns the model."""
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model
