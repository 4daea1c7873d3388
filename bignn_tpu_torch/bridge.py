"""Carry a JAX ``BiGNN`` parameter tree into the port.

The JAX package keeps parameters as nested dicts (``bignn_tpu/models/
bignn.py:119-132``): ``inner/layer_i/mlp/layer_j/{w,b}``, ``inner/layer_i/
eps``, ``outer/layer_i/{w,a_l,a_r,b}``, ``scorer/mlp/layer_j/{w,b}``. Leaves
arrive as NumPy arrays (``jax.tree.map(np.asarray, params)``), so this
module needs no JAX. Renaming rules:
  * ``layer_i`` under ``inner``/``outer`` -> ``i``; under ``mlp`` ->
    ``layers.i``;
  * a Dense layer's ``w`` ``[in, out]`` -> ``weight`` ``[out, in]``
    (transposed), ``b`` -> ``bias``;
  * a conv's own ``w`` -> ``lin.weight`` (transposed), ``b`` -> ``bias``;
  * ``eps`` (0-d), ``a_l``/``a_r`` (``[H, D]``) keep name and shape.
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


def _rename(path: tuple[str, ...]) -> tuple[str, bool]:
    """(state-dict name, transpose?) of one JAX leaf path."""
    out: list[str] = []
    in_dense = False
    for i, key in enumerate(path[:-1]):
        if key.startswith("layer_"):
            idx = key[len("layer_"):]
            in_dense = i > 0 and path[i - 1] == "mlp"
            out += ["layers", idx] if in_dense else [idx]
        else:
            out.append(key)
    leaf = path[-1]
    if leaf == "w":
        return ".".join(out + (["weight"] if in_dense else ["lin", "weight"])), True
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


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Load a JAX parameter tree into ``model`` (strict: every parameter
    must be matched); returns the model."""
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model
