"""Dense layers, MLPs, activations and Glorot init (counterpart of
``bignn_tpu/models/modules.py``).

Weights follow PyTorch's layout: ``nn.Linear.weight`` is ``[out, in]``,
where the JAX package keeps ``w`` as ``[in, out]`` (``bridge.py``
transposes). Parameters stay float32 (the master weights); a layer casts
them to its input's type inside ``forward``, so a bf16 model computes in
bf16 (matmuls accumulate in float32 on the card) and its gradients reach
the float32 parameters through the cast (``bignn_tpu/models/bignn.py:
101-109``, ``modules.py:58-65``). Construction only allocates (zeros, no random draw); each
module's ``init_params(key)`` is the JAX module's ``init(key)``, bit for
bit through ``prng.py``, as a state dict, and ``BiGNN`` loads it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bignn_tpu_torch import prng


def glorot(key: prng.Key, shape: tuple[int, int]) -> torch.Tensor:
    """JAX ``modules.glorot``: uniform in +-sqrt(6 / (fan_in + fan_out)),
    the limit rounded to float32 as jnp.sqrt rounds it."""
    limit = float(np.sqrt(np.float32(6.0 / (shape[0] + shape[-1]))))
    return torch.from_numpy(prng.uniform(key, shape, -limit, limit))


_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "identity": lambda x: x,
    "none": lambda x: x,
}


def parse_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; valid: {sorted(_ACTIVATIONS)}"
        ) from None


class Dense(nn.Linear):
    """``y = act(x W^T + b)``; ``init_params`` gives Glorot weights and a
    zero bias."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "identity",
                 use_bias: bool = True):
        super().__init__(in_dim, out_dim, bias=use_bias)
        self._act = parse_activation(activation)

    def reset_parameters(self) -> None:
        # allocation only: nn.Linear's own init would draw from the global
        # torch RNG
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        state = {"weight": glorot(key, (self.in_features,
                                        self.out_features)).T.contiguous()}
        if self.bias is not None:
            state["bias"] = torch.zeros(self.out_features)
        return state

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._act(F.linear(x, self.weight.to(x.dtype), bias))


class MLP(nn.Module):
    """Stacked Dense layers: hidden layers use ``activation``, the output is
    linear unless ``activate_final``."""

    def __init__(self, dims: tuple[int, ...], activation: str = "relu",
                 activate_final: bool = False):
        super().__init__()
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1],
                  activation if (i < n - 1 or activate_final) else "identity")
            for i in range(n))

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        keys = prng.split(key, max(len(self.layers), 1))
        return {f"layers.{i}.{k}": v for i, layer in enumerate(self.layers)
                for k, v in layer.init_params(keys[i]).items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def prefixed(prefix: str, state: dict[str, torch.Tensor]) -> dict:
    """``state`` with every name under ``prefix``."""
    return {prefix + k: v for k, v in state.items()}
