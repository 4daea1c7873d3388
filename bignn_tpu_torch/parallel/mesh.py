"""Device mesh of the parallel paths (counterpart of
``bignn_tpu/parallel/mesh.py``).

A ``Mesh`` is an array of ``torch.device``s with the JAX package's axis
names: ``('dp', 'graph')`` (data parallelism over pair batches, and the
edge-partitioned p2 path), or ``('dp', 'tp')`` (feature sharding,
``parallel/tp.py``). One process drives every shard, as JAX's single
controller does. The mesh may name one card several times: then the
shards run in turn on that card, each on its own tensors, and the halo
exchange moves real payloads between them (what the JAX package's tests do
on fake CPU devices). A mesh over two or more distinct CUDA devices, and
the multi-process run, are still to port (ROADMAP Queue 1 item 11), and
raise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

_TODO = "is still to port (ROADMAP Queue 1 item 11)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices [dp, graph]`` or ``[dp, tp]`` (an object array of
    ``torch.device``)."""

    devices: np.ndarray
    axis_names: tuple[str, ...] = ("dp", "graph")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The one device every shard lies on (a mesh over distinct devices
        raises, as ``make_mesh`` does)."""
        if len(set(self.devices.flat)) > 1:
            raise NotImplementedError(
                f"shards on distinct devices {_TODO}")
        return self.devices.flat[0]

    @property
    def graph_devices(self) -> list[torch.device]:
        """The device of each shard of the second axis (row 0 of the mesh:
        the ``dp`` replicas compute the same shards)."""
        return list(self.devices[0])


def make_mesh(dp: int | None = None, graph: int = 1,
              devices: Sequence | None = None, tp: int = 1) -> Mesh:
    """A ``('dp', 'graph')`` mesh over ``devices`` (default: the visible
    CUDA devices), which may repeat one device, or a ``('dp', 'tp')`` one
    when ``tp > 1`` (``tp`` and ``graph`` do not compose: the halo path
    takes full-width rows). ``dp`` defaults to the device count over the
    other axis."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if tp > 1:
        if graph != 1:
            raise ValueError("tp and graph axes don't compose")
        axes, other = ("dp", "tp"), tp
    else:
        axes, other = ("dp", "graph"), graph
    if dp is None:
        dp = n // other
    if dp * other != n or n == 0:
        raise ValueError(
            f"dp({dp}) * {axes[1]}({other}) != device count ({n})")
    if len(set(devices)) > 1:
        if {d.type for d in devices} == {"cuda"}:
            names = sorted({str(d) for d in devices})
            raise NotImplementedError(
                f"shards on distinct CUDA devices {names} {_TODO}")
        raise NotImplementedError(
            f"a mesh over devices of several types {_TODO}")
    arr = np.empty((dp, other), dtype=object)
    for i, d in enumerate(devices):
        arr[i // other, i % other] = d
    return Mesh(arr, axes)


def make_hybrid_mesh(dp: int | None = None, graph: int | None = None):
    raise NotImplementedError(f"the multi-host hybrid mesh {_TODO}")


def init_distributed(*args, **kwargs):
    raise NotImplementedError(f"the multi-host run {_TODO}")


def global_put(*args, **kwargs):
    raise NotImplementedError(f"multi-host placement {_TODO}")
