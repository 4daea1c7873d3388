"""Device mesh of the edge-partitioned path (counterpart of
``bignn_tpu/parallel/mesh.py``).

A ``Mesh`` is a ``(dp, graph)`` array of ``torch.device``s with the JAX
package's axis names. One process drives every shard, as JAX's single
controller does. The mesh may name one card several times: then the
``graph`` shards run in turn on that card, each on its own tensors, and the
halo exchange moves real payloads between them (what the JAX package's
tests do on fake CPU devices). A mesh over two or more distinct CUDA
devices needs peer access between them, which is still to port (ROADMAP
Queue 1 item 5), and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

_TODO = "is still to port (ROADMAP Queue 1 item 5)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices [dp, graph]`` (an object array of ``torch.device``)."""

    devices: np.ndarray
    axis_names: tuple[str, ...] = ("dp", "graph")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The one device every shard lies on."""
        return self.devices.flat[0]

    @property
    def graph_devices(self) -> list[torch.device]:
        """The device of each ``graph`` shard (row 0 of the mesh: the ``dp``
        replicas compute the same shards)."""
        return list(self.devices[0])


def make_mesh(dp: int | None = None, graph: int = 1,
              devices: Sequence | None = None, tp: int = 1) -> Mesh:
    """A ``('dp', 'graph')`` mesh over ``devices`` (default: the visible
    CUDA devices), which may repeat one device; ``dp`` defaults to
    ``len(devices) // graph``."""
    if tp != 1:
        raise NotImplementedError(f"the tp axis (parallel/tp.py) {_TODO}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // graph
    if dp * graph != n or n == 0:
        raise ValueError(f"dp({dp}) * graph({graph}) != device count ({n})")
    if len(set(devices)) > 1:
        if {d.type for d in devices} == {"cuda"}:
            names = sorted({str(d) for d in devices})
            raise NotImplementedError(
                f"shards on distinct CUDA devices {names} need peer access, "
                f"which {_TODO}")
        raise NotImplementedError(
            f"a mesh over devices of several types {_TODO}")
    arr = np.empty((dp, graph), dtype=object)
    for i, d in enumerate(devices):
        arr[i // graph, i % graph] = d
    return Mesh(arr)


def make_hybrid_mesh(dp: int | None = None, graph: int | None = None):
    raise NotImplementedError(f"the multi-host hybrid mesh {_TODO}")


def init_distributed(*args, **kwargs):
    raise NotImplementedError(f"the multi-host run {_TODO}")


def global_put(*args, **kwargs):
    raise NotImplementedError(f"multi-host placement {_TODO}")
