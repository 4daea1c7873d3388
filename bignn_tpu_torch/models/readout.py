"""Readouts: node states -> one embedding per graph (counterpart of
``bignn_tpu/models/readout.py``). Padding rows carry graph id
``num_graphs`` and are dropped; in the block-local layout they also sit
between molecules, which the segment ops take by contract (ROADMAP F1,
F2). Each readout's ``init_params(key)`` is the JAX readout's
``init(key)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bignn_tpu_torch import ops, prng
from bignn_tpu_torch.models.modules import MLP, Dense, prefixed


class SumReadout(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        return {}

    def forward(self, x, graph_ids, num_graphs: int, graph_n_nodes=None):
        return ops.segment_sum(x, graph_ids, num_graphs)


class MeanReadout(SumReadout):
    """The sum over each graph divided by its node count: ``graph_n_nodes``
    where the batch carries it (float32 counts: the mean is divided and
    returned in float32 whatever the compute type, as JAX's division
    promotes it), else a count of the graph's rows (the data's type, as
    JAX's ``segment_mean``)."""

    def forward(self, x, graph_ids, num_graphs: int, graph_n_nodes=None):
        if graph_n_nodes is not None:
            total = ops.segment_sum(x, graph_ids, num_graphs)
            return total.float() / graph_n_nodes.float().clamp_min(1.0)[:, None]
        return ops.segment_mean(x, graph_ids, num_graphs)


class MaxReadout(SumReadout):
    """Per-feature max over each graph's rows (``ops.segment_max``)."""

    def forward(self, x, graph_ids, num_graphs: int, graph_n_nodes=None):
        return ops.segment_max(x, graph_ids, num_graphs)


class AttentionReadout(nn.Module):
    """Gated attention pooling: ``g = sum_v softmax_v(gate(x_v)) proj(x_v)``
    with a ``tanh`` MLP gate ``dim -> hidden -> 1`` and a bias-free
    ``dim x dim`` projection; the gate scores are segment-softmaxed within
    each graph (the ``[E]`` form of ``ops.segment_softmax``). As in JAX the
    projection and the pooled sum are float32 whatever the compute type."""

    def __init__(self, dim: int, hidden: int = 64):
        super().__init__()
        self.dim, self.hidden = dim, hidden
        self.gate = MLP((dim, hidden, 1), "tanh")
        self.proj = Dense(dim, dim, use_bias=False)

    def init_params(self, key: prng.Key) -> dict[str, torch.Tensor]:
        kg, kp = prng.split(key, 2)
        return {**prefixed("gate.", self.gate.init_params(kg)),
                **prefixed("proj.", self.proj.init_params(kp))}

    def forward(self, x, graph_ids, num_graphs: int, graph_n_nodes=None):
        scores = self.gate(x)[:, 0]  # [N]
        alpha = ops.segment_softmax(scores, graph_ids, num_graphs)
        # jnp.dot(x, proj, preferred_element_type=f32): products of the
        # compute type, summed and kept in float32
        proj = F.linear(x.float(), self.proj.weight.to(x.dtype).float())
        return ops.segment_sum(proj * alpha.float()[:, None], graph_ids,
                               num_graphs)


def parse_readout(spec: str, dim: int) -> nn.Module:
    """``"sum" | "mean" | "max" | "attention[:hidden]"``."""
    parts = spec.split(":")
    kind = parts[0].lower()
    if kind == "sum":
        return SumReadout(dim)
    if kind == "mean":
        return MeanReadout(dim)
    if kind == "max":
        return MaxReadout(dim)
    if kind == "attention":
        return AttentionReadout(dim, int(parts[1]) if len(parts) > 1 else 64)
    raise ValueError(f"unknown readout spec {spec!r}")
