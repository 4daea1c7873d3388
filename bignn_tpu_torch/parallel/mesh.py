"""Device mesh of the parallel paths (counterpart of
``bignn_tpu/parallel/mesh.py``).

A ``Mesh`` is an array of ``torch.device``s with the JAX package's axis
names: ``('dp', 'graph')`` (data parallelism over pair batches, and the
edge-partitioned p2 path), or ``('dp', 'tp')`` (feature sharding,
``parallel/tp.py``), and beside it the process that drives each entry.

One process may drive every shard, as JAX's single controller drives its
chips. The mesh may name one card several times: then the shards run in
turn on that card, each on its own tensors, and the halo exchange moves real
payloads between them (what the JAX package's tests do on fake CPU
devices). It may also lie over distinct cards of the host: then each entry
runs on its own card, the parameters are replicated on each
(``parallel/replicas.py``), the halo exchange reads the peers' memory
(``ops.all_to_all``), and the sums across cards are added in shard order
(``parallel/comm.py``). ``Mesh.first_device`` is the first entry's device,
where evaluation and checkpoints run as one stream.

Several processes (the multi-process p2 run, JAX's multi-host run):
``init_distributed`` joins a ``torch.distributed`` process group on
``gloo``, the control plane only (handle exchange, barriers, scalars), and
fixes this process's cards (``local_devices``: one, or several, as a JAX
process drives its host's chips); ``make_hybrid_mesh`` lays the ``graph``
axis over the processes host-major, as JAX's hand layout does, each
process's entries on its own cards; each process drives its own entries
(``Mesh.local_graph``) and ``global_put`` gives it its part of a
host-replicated array. The data plane between processes is
``ops.collectives.ProcessExchange`` (through the host, gloo) or, when every
process runs on one host and its cards reach each other's,
``PeerExchange`` (CUDA IPC): ``parallel.comm.make_exchange`` chooses by
the processes' hosts and cards.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

_local_devices: list[torch.device] | None = None
_hosts: list[str] | None = None  # every process's host, gathered once


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices() -> list[torch.device]:
    """The cards ``init_distributed`` fixed for this process (JAX's
    ``local_devices``); without it ``[cuda:0]`` where a card is visible,
    else ``[cpu]``."""
    if _local_devices is not None:
        return list(_local_devices)
    return [torch.device("cuda", 0) if torch.cuda.is_available() else
            torch.device("cpu")]


def local_device() -> torch.device:
    """The first of ``local_devices()``."""
    return local_devices()[0]


def barrier() -> None:
    """A process-group barrier; nothing in a single process."""
    if dist.is_initialized():
        dist.barrier()


def all_gather_object(obj) -> list:
    """Every process's ``obj`` in rank order (``[obj]`` in a single
    process)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _this_host() -> str:
    """This machine: its name and, where the kernel gives it, its boot id,
    so that two machines that report one name (containers that all answer
    ``localhost``, say) differ."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}/{boot}"


def host_names() -> list[str]:
    """Every process's host (``_this_host``) in rank order, as
    ``init_distributed`` gathered them once; ``[this host]`` without a
    process group."""
    return list(_hosts) if _hosts is not None else [_this_host()]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices [dp, graph]`` or ``[dp, tp]`` (an object array of
    ``torch.device``) and ``processes``, the process of each entry (an int
    array of the same shape; None: every entry is process 0)."""

    devices: np.ndarray
    axis_names: tuple[str, ...] = ("dp", "graph")
    processes: np.ndarray | None = None

    def __post_init__(self):
        if self.processes is None:
            object.__setattr__(self, "processes",
                               np.zeros(self.devices.shape, np.int64))

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def process_count(self) -> int:
        """The processes that drive the mesh's entries."""
        return len(set(self.processes.flat))

    def _local(self) -> np.ndarray:
        """Which entries this process drives: all of a single-process
        mesh, else those of its rank."""
        if self.process_count == 1:
            return np.ones(self.devices.shape, bool)
        return self.processes == process_index()

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first entry (row-major): the one
        stream of evaluation, scoring of whole batches and checkpoints."""
        return self.devices[self._local()][0]

    @property
    def cards(self) -> list[torch.device]:
        """This process's distinct devices in the order of its entries
        (row-major); one for a mesh that names one device several
        times."""
        return list(dict.fromkeys(self.devices[self._local()]))

    @property
    def local_graph(self) -> list[int]:
        """The global indices of this process's shards of the second axis
        (every ``dp`` row of a column lies in one process)."""
        return [int(j) for j in np.flatnonzero(self._local()[0])]


def make_mesh(dp: int | None = None, graph: int = 1,
              devices: Sequence | None = None, tp: int = 1) -> Mesh:
    """A ``('dp', 'graph')`` mesh over ``devices`` (default: the visible
    CUDA devices), which may repeat one device, or a ``('dp', 'tp')`` one
    when ``tp > 1`` (``tp`` and ``graph`` do not compose: the halo path
    takes full-width rows). ``dp`` defaults to the device count over the
    other axis. One process drives it, on one card named several times or
    on distinct cards (entry ``i`` row-major on ``devices[i]``); devices of
    several types raise."""
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
    if len({d.type for d in devices}) > 1:
        raise NotImplementedError(
            f"a mesh over devices of several types "
            f"{sorted({str(d) for d in devices})}")
    if devices[0].type == "cuda":  # cuda means the current card
        devices = [d if d.index is not None else torch.device(
            "cuda", torch.cuda.current_device()) for d in devices]
    arr = np.empty((dp, other), dtype=object)
    for i, d in enumerate(devices):
        arr[i // other, i % other] = d
    return Mesh(arr, axes)


def resolve_distributed(coordinator_address: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None
                        ) -> tuple[str | None, int, int]:
    """``(address, count, rank)`` of a run from the arguments, else JAX's
    environment names (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``), checked without connecting: a count of 1 (or
    none) is a single process; more need a coordinator and this process's
    id; the id lies in ``[0, count)``. Raises ``ValueError``."""
    address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if address is not None and num_processes is None:
        raise ValueError(f"coordinator {address} given without a process "
                         "count (--num-processes / JAX_NUM_PROCESSES)")
    count = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if count < 1:
        raise ValueError(f"process count {count} is below 1")
    if not 0 <= rank < count:
        raise ValueError(f"process id {rank} lies outside [0, {count})")
    if count > 1 and address is None:
        raise ValueError(f"{count} processes need a coordinator host:port "
                         "(--coordinator / JAX_COORDINATOR_ADDRESS)")
    if count > 1 and process_id is None:
        raise ValueError(f"{count} processes need this process's id "
                         "(--process-id / JAX_PROCESS_ID)")
    return address, count, rank


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids: Sequence[int] | None = None) -> int:
    """The multi-process entry (JAX ``init_distributed``); returns this
    process's index.

    Arguments default to JAX's environment names (``resolve_distributed``).
    A single process (no coordinator and no count, or a count of 1) joins
    nothing. Otherwise it joins a ``torch.distributed`` process group on
    ``gloo`` at ``tcp://{address}`` with the count and rank: the control
    plane of the exchange across processes. It gathers every process's
    host once (``host_names`` reads them after) and fixes this process's
    cards (``local_devices``): ``cuda:{id}`` for each of
    ``local_device_ids``; else, with ``i`` the process's index among the
    ``m`` processes on its host (the ranks below its own whose host equals
    its own) and ``c`` the host's cards, the cards ``[i * c / m, (i + 1) *
    c / m)`` where ``m`` is below ``c`` and divides it (a process drives
    its share of the host's cards, as a JAX process drives its local
    devices), and otherwise the one card ``cuda:{i % c}`` (the processes
    of a host take its cards in rank order whatever the ranks' layout over
    the hosts; several share a card when a host runs more processes than
    it has cards); the CPU without a card. The first card becomes the
    current one. Idempotent: a second call with the same count and rank
    returns the rank."""
    global _local_devices, _hosts
    address, count, rank = resolve_distributed(
        coordinator_address, num_processes, process_id)
    if count == 1:
        return process_index()
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (count, rank):
            raise ValueError(
                f"already in a group of {dist.get_world_size()} as rank "
                f"{dist.get_rank()}, asked for {count} as rank {rank}")
        return rank
    if local_device_ids is not None:
        ids = [int(i) for i in local_device_ids]
        if not ids or len(set(ids)) != len(ids):
            raise ValueError(f"local_device_ids {ids}: one or more distinct "
                             "card ids")
    host = address.rsplit(":", 1)[0]
    if host in ("127.0.0.1", "localhost") and (
            "GLOO_SOCKET_IFNAME" not in os.environ):
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"  # loopback peers only
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=count, rank=rank)
    _hosts = hosts = all_gather_object(_this_host())
    if local_device_ids is not None:
        _local_devices = [torch.device("cuda", i) for i in ids]
    elif torch.cuda.is_available():
        c = torch.cuda.device_count()
        m = hosts.count(hosts[rank])
        i = hosts[:rank].count(hosts[rank])
        share = c // m if m < c and c % m == 0 else 1
        _local_devices = [torch.device("cuda", (i * share + k) % c)
                          for k in range(share)]
    else:
        _local_devices = [torch.device("cpu")]
    if _local_devices[0].type == "cuda":
        torch.cuda.set_device(_local_devices[0])
    return rank


def make_hybrid_mesh(dp: int | None = None, graph: int | None = None,
                     device: str | torch.device | None = None,
                     devices: Sequence | None = None) -> Mesh:
    """A ``('dp', 'graph')`` mesh over every process of the group (JAX
    ``make_hybrid_mesh``), each process driving its entries on its
    ``devices`` (default: ``[device]``, else ``local_devices()``; the
    CPU tests name the CPU twice for two card slots).

    ``graph`` defaults to the process count and must be a multiple of it;
    each process owns ``ici_graph = graph // nproc`` graph shards, laid out
    host-major as JAX's hand layout: entry ``[d, p * ici_graph + g]`` is
    process p's. With ``nloc`` devices a process:

      * ``nloc > 1`` and ``ici_graph <= nloc``: JAX's checks and messages
        (``nloc % ici_graph``; ``dp``, where given, equal to ``ici_dp =
        nloc // ici_graph``), and entry ``[d, p * ici_graph + g]`` on
        process p's device ``d * ici_graph + g``, JAX's placement on real
        cards. The ``dp`` rows of a column still compute one forward, on
        row 0's device (``shard_device``; ``parallel/step.py``), so JAX's
        dp = 2 x graph = 2 over two cards a process runs each process's
        graph shard on its first card, and leaves the second idle;
      * ``nloc > 1`` and ``ici_graph > nloc`` (which JAX refuses): the
        shards laid over the devices as ``spread_devices`` lays them,
        every ``dp`` row (``ici_dp`` is ``dp``, else 1) on the same
        devices as row 0 (``run`` spreads config5-large's 8 shards so);
      * one device: it is named ``ici_dp * ici_graph`` times (``ici_dp``
        is ``dp``, else 1), so JAX's two checks against the local devices
        hold by construction.

    Every process must drive as many devices. A single process gets
    ``make_mesh(dp, graph or 1)`` over its devices, as JAX's gets it over
    its local devices (``dp`` defaults to their count over ``graph``); one
    device is named ``dp * graph`` times (``dp`` default 1)."""
    if devices is None:
        devices = [device] if device is not None else local_devices()
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]  # cuda means the current card
    nloc = len(devices)
    if dp is not None and int(dp) < 1:
        raise ValueError(f"dp ({dp}) must be at least 1")
    nproc = process_count()
    if nproc == 1:
        if nloc > 1:
            return make_mesh(dp=dp, graph=graph or 1, devices=devices)
        ici_dp, g = 1 if dp is None else int(dp), graph or 1
        return make_mesh(dp=ici_dp, graph=g, devices=devices * (ici_dp * g))
    graph = graph if graph is not None else nproc
    if graph % nproc != 0:
        raise ValueError(
            f"graph ({graph}) must be a multiple of process count ({nproc}) "
            "so every host owns whole graph-shard groups")
    ici_graph = graph // nproc
    if 1 < nloc and ici_graph <= nloc:
        if nloc % ici_graph != 0:
            raise ValueError(
                f"per-host graph dim ({ici_graph}) must divide local device "
                f"count ({nloc})")
        ici_dp = nloc // ici_graph
        if dp is not None and dp != ici_dp:
            raise ValueError(
                f"dp ({dp}) inconsistent with {nloc} local devices / "
                f"{ici_graph} per-host graph shards (expected {ici_dp})")
        per_entry = list(range(nloc))
    else:
        ici_dp = 1 if dp is None else int(dp)
        per_entry = _spread(ici_graph, nloc) * ici_dp
    every = [[torch.device(c) for c in names]
             for names in all_gather_object([str(d) for d in devices])]
    if len({len(names) for names in every}) != 1:
        raise ValueError(f"the processes drive {[len(n) for n in every]} "
                         "local devices: a hybrid mesh takes as many in "
                         "every process")
    # JAX's hand layout (bignn_tpu/parallel/mesh.py:130-136): process p's
    # entry (d, g) at [d, p * ici_graph + g]
    arr = np.empty((ici_dp, nproc * ici_graph), dtype=object)
    processes = np.empty(arr.shape, dtype=np.int64)
    for p, names in enumerate(every):
        for e, k in enumerate(per_entry):
            d, g = divmod(e, ici_graph)
            arr[d, p * ici_graph + g] = names[k]
            processes[d, p * ici_graph + g] = p
    return Mesh(arr, ("dp", "graph"), processes)


def _spread(n: int, count: int) -> list[int]:
    """Which of ``count`` devices each of ``n`` shards lies on
    (``spread_devices``)."""
    if n < 1:
        raise ValueError(f"{n} shards")
    k = max(c for c in range(1, min(n, count) + 1) if n % c == 0)
    return [i // (n // k) for i in range(n)]


def spread_devices(n: int, devices: Sequence) -> list[torch.device]:
    """``n`` shards laid over ``devices``, one device a shard: ``n / k``
    consecutive shards on each of the first ``k`` devices, ``k`` the most
    devices that divide ``n`` evenly (every device where ``n`` is a
    multiple of their count, the first ``n`` where ``n`` is below it)."""
    devices = [torch.device(d) for d in devices]
    return [devices[i] for i in _spread(n, len(devices))]


def shard_device(mesh: Mesh, j: int) -> torch.device:
    """The device of graph (or tp) shard ``j``: entry ``[0, j]``, where
    the shard's computation runs (the ``dp`` rows of a column compute the
    same forward, which one process runs once)."""
    return mesh.devices[0, j]


def global_put(mesh: Mesh, spec, x):
    """This process's part of a host-replicated NumPy array ``x`` (JAX
    ``global_put``): for the spec ``()`` the whole array on
    ``mesh.first_device``, for ``("graph",)`` the slices ``x[j]`` of its
    graph shards, each on its shard's device (``shard_device``), a list
    in local order. Every process holds the whole ``x`` (plans and
    batches are deterministic from the shared seed)."""
    x = np.asarray(x)
    spec = tuple(spec or ())
    if spec == ():
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            mesh.first_device)
    if spec == ("graph",):
        if x.shape[0] != mesh.shape["graph"]:
            raise ValueError(f"leading axis {x.shape[0]} is not the mesh's "
                             f"graph axis {mesh.shape['graph']}")
        return [torch.from_numpy(np.ascontiguousarray(x[j])).to(
            shard_device(mesh, j)) for j in mesh.local_graph]
    raise NotImplementedError(
        f"global_put takes the specs () and ('graph',), got {spec}")
