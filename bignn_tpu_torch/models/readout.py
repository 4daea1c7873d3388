"""Readouts: node states -> one embedding per graph (counterpart of
``bignn_tpu/models/readout.py``). Padding rows carry graph id
``num_graphs`` and are dropped; in the block-local layout they also sit
between molecules, which ``ops.segment_sum`` takes by contract."""

from __future__ import annotations

from torch import nn

from bignn_tpu_torch import ops


class SumReadout(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x, graph_ids, num_graphs: int):
        return ops.segment_sum(x, graph_ids, num_graphs)


def parse_readout(spec: str, dim: int) -> nn.Module:
    """``"sum"``; ``"mean"``, ``"max"`` and ``"attention[:hidden]"`` are
    still to port (ROADMAP Queue 1 item 4)."""
    kind = spec.split(":")[0].lower()
    if kind == "sum":
        return SumReadout(dim)
    if kind in ("mean", "max", "attention"):
        raise NotImplementedError(
            f"{kind} readout is still to port (ROADMAP Queue 1 item 4)")
    raise ValueError(f"unknown readout spec {spec!r}")
