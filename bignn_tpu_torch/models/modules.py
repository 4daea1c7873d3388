"""Dense layers, MLPs, activations and Glorot init (counterpart of
``bignn_tpu/models/modules.py``).

Weights follow PyTorch's layout: ``nn.Linear.weight`` is ``[out, in]``,
where the JAX package keeps ``w`` as ``[in, out]`` (``bridge.py``
transposes). Init draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def glorot_(t: torch.Tensor, fan_in: int, fan_out: int,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform Glorot init in place, ``limit = sqrt(6 / (fan_in + fan_out))``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


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
    """``y = act(x W^T + b)`` with Glorot weights and a zero bias."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "identity",
                 use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__(in_dim, out_dim, bias=use_bias)
        self._act = parse_activation(activation)
        glorot_(self.weight, in_dim, out_dim, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._act(super().forward(x))


class MLP(nn.Module):
    """Stacked Dense layers: hidden layers use ``activation``, the output is
    linear unless ``activate_final``."""

    def __init__(self, dims: tuple[int, ...], activation: str = "relu",
                 activate_final: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1],
                  activation if (i < n - 1 or activate_final) else "identity",
                  generator=generator)
            for i in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
