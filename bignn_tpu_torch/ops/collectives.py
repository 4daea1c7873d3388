"""All-to-all exchange of the shards' send buffers (counterpart of
``bignn_tpu/ops/pallas/collectives.py:all_to_all_pallas``, the wire step of
the halo exchange in ``parallel/halo.py``).

``all_to_all(sendbufs)`` takes the G send buffers ``[G, ...]`` of a mesh's
graph shards (slot j of shard i's buffer goes to shard j) and returns the G
receive buffers: ``recv[j][i] = sendbufs[i][j]``. It is a
``torch.autograd.Function`` whose backward is the same exchange of the
cotangents (the exchange is its own adjoint, as the JAX kernel's
``custom_vjp`` has it). CUDA buffers go to the kernel of
``csrc/all_to_all.cu``; CPU buffers take ``all_to_all_plain``. The wrapper
counts its launches (forward and backward) per element type.

Buffers on one card: one launch for the whole exchange
(``all_to_all:<dtype>``). Buffers on distinct cards of this process (a
mesh over several cards, JAX's single controller over its chips): every
ordered pair of the cards has peer access, enabled once
(``enable_peer_access``; a pair without it raises, naming the pair: there
is no route through the host). Each card launches the kernel once for its
own run of destinations, reading every source chunk through the source's
device pointer, local or a peer's (``all_to_all:<dtype>:cards``): a pull,
where the TPU kernel pushes each chunk into its peer by remote DMA. The TPU
kernel's semaphores become CUDA events: every reader's stream waits on an
event recorded on every source's stream once its send buffer is written,
and every source's stream waits on every reader's "done" event before it
runs anything more, so that the caching allocator, which recycles a freed
block on its own card's stream and cannot see a read from another card,
never hands out a send buffer still being read.

Across processes (the multi-process p2 run), ``all_to_all(sendbufs,
exchange)`` takes this process's shards' send buffers (each ``[G, ...]``)
and returns their receive buffers, through ``exchange``, built
collectively once per mesh (``parallel.comm.make_exchange``).
``ProcessExchange`` is the route between hosts, and the CPU's: each
process sends every other one only the chunks that process's shards need,
through the process group (one gloo ``all_to_all_single`` over host
copies, pinned for a card), and the receive buffers are written from the
local chunks and the arrivals (on a card one launch of the kernel on this
process's destinations, counted under ``all_to_all:<dtype>:hosts``).
Its ``all_to_all_plain`` gathers every process's whole send buffers
instead: the plain version. When every process runs on one host with
cards that reach each other, ``PeerExchange`` copies the send buffers
into a staging buffer that every process maps by CUDA IPC (on its own
card or a peer card), and one launch of the kernel pulls this process's
receive buffers from every source; its launches count under
``all_to_all:<dtype>:procs``. The same objects give the rank-order
all-gather and sum that keep the replicated state equal in every process
(``parallel/comm.py``). A mix of device types raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Sequence

import torch
import torch.distributed as dist

from bignn_tpu_torch.ops import cuda_lib

MAX_SHARDS = 32  # kMaxShards of csrc/all_to_all.cu


def _check(bufs: Sequence[torch.Tensor], g: int | None = None
           ) -> torch.device | None:
    """The one device of ``bufs``, or None for buffers on distinct CUDA
    devices; raises unless they are contiguous buffers of one shape and
    type with a leading axis of G (default: one buffer a shard, G of
    them), on devices of one type."""
    if not bufs:
        raise ValueError("all_to_all needs at least one send buffer")
    g = len(bufs) if g is None else g
    first = bufs[0]
    for b in bufs:
        if b.dim() < 1 or b.shape[0] != g:
            raise ValueError(f"each send buffer needs a leading axis of "
                             f"{g} (one slot a shard), got {tuple(b.shape)}")
        if b.shape != first.shape or b.dtype != first.dtype:
            raise ValueError(
                f"send buffers differ: {tuple(b.shape)} {b.dtype} against "
                f"{tuple(first.shape)} {first.dtype}")
        if not b.is_contiguous():
            raise ValueError("send buffers must be contiguous")
    devices = {b.device for b in bufs}
    if len(devices) > 1:
        if {d.type for d in devices} == {"cuda"}:
            return None
        raise NotImplementedError(
            f"send buffers on several devices {sorted(map(str, devices))}")
    return first.device


_peer_pairs: set[tuple[int, int]] = set()  # (reader, owner) cards enabled


def enable_peer_access(cards: Sequence[torch.device]) -> None:
    """Peer access for every ordered pair of distinct ``cards`` (CUDA
    devices of this process), each pair once a process: a kernel on card
    a may then read card b's memory through its pointer. A pair without
    peer access raises, naming the pair."""
    idx = sorted({torch.device(c).index for c in cards})
    for a in idx:
        for b in idx:
            if a == b or (a, b) in _peer_pairs:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"cuda:{a} has no peer access to cuda:{b}: the exchange "
                    "between cards reads peers' memory and has no route "
                    "through the host")
            cuda_lib.call("bignn_enable_peer_access", torch.device("cuda", a),
                          b)
            _peer_pairs.add((a, b))


def all_to_all_plain(sendbufs: Sequence[torch.Tensor],
                     exchange: "ProcessExchange | None" = None
                     ) -> list[torch.Tensor]:
    """Plain version: stack the buffers ``[G (source), n (slot), ...]`` and
    take slot j of every source for destination j (with ``exchange``, its
    own plain version over every process's buffers). Differentiable by
    autograd."""
    if exchange is not None:
        return exchange.all_to_all_plain(sendbufs)
    bufs = list(sendbufs)
    if len({b.device for b in bufs}) > 1:  # on distinct cards
        return [torch.stack([b[j].to(d) for b in bufs])
                for j, d in enumerate(b.device for b in bufs)]
    stacked = torch.stack(bufs)
    return [stacked[:, j].contiguous() for j in range(stacked.shape[1])]


def all_to_all_launch(bufs: Sequence[torch.Tensor], j_begin: int = 0,
                      suffix: str = "") -> list[torch.Tensor]:
    """Run the kernel on the G contiguous CUDA buffers ``bufs``, each ``[n,
    ...]``: slot jj of ``bufs[i]`` goes to slot i of new receive buffer jj,
    of destination ``j_begin + jj`` (n = G, ``j_begin`` 0: one process's
    whole exchange; n < G: the destinations of one process of several,
    each source's base pointer set back by ``j_begin`` slots so that the
    kernel's slot j lands on row ``j - j_begin``). Its launch counts
    under ``all_to_all:<dtype><suffix>``."""
    g, n = len(bufs), bufs[0].shape[0]
    dev = bufs[0].device
    if dev.type != "cuda":
        raise ValueError(f"all_to_all send buffers must be CUDA tensors, "
                         f"got {dev}")
    if g > MAX_SHARDS or not 0 <= j_begin <= g - n:
        raise ValueError(f"all_to_all kernel takes at most {MAX_SHARDS} "
                         f"shards and a range of their destinations, got "
                         f"{n} from {j_begin} of {g}")
    recv = [bufs[0].new_empty((g, *bufs[0].shape[1:])) for _ in range(n)]
    chunk = bufs[0][0].numel() * bufs[0].element_size()
    if chunk:
        send_ptrs = (ctypes.c_void_p * g)(
            *(b.data_ptr() - j_begin * chunk for b in bufs))
        recv_ptrs = (ctypes.c_void_p * n)(*(r.data_ptr() for r in recv))
        cuda_lib.launch("bignn_all_to_all", dev, send_ptrs, recv_ptrs, g,
                        j_begin, n, chunk)
        cuda_lib.count(all_to_all, bufs[0].dtype, suffix=suffix)
    return recv


def _runs(devices: Sequence[torch.device]) -> list[tuple[int, int]]:
    """``(first, count)`` of each run of consecutive shards on one
    device."""
    runs = []
    for j, d in enumerate(devices):
        if runs and devices[runs[-1][0]] == d:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((j, 1))
    return runs


def all_to_all_cards(bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The exchange of G contiguous ``[G, ...]`` send buffers that lie on
    distinct cards of this process; receive buffer j on buffer j's card.
    One launch a run of consecutive destinations on one card, reading
    every source through peer access, between the event barriers of the
    module docstring; each launch counts under ``all_to_all:<dtype>:cards``.
    """
    bufs = list(bufs)
    g = len(bufs)
    if g > MAX_SHARDS:
        raise ValueError(f"all_to_all kernel takes at most {MAX_SHARDS} "
                         f"shards, got {g}")
    devices = [b.device for b in bufs]
    cards = list(dict.fromkeys(devices))
    enable_peer_access(cards)
    streams = {c: torch.cuda.current_stream(c) for c in cards}
    written = []  # every source's send buffers are written
    for c in cards:
        ev = torch.cuda.Event()
        ev.record(streams[c])
        written.append(ev)
    recv: list[torch.Tensor] = [None] * g
    chunk = bufs[0][0].numel() * bufs[0].element_size()
    for j0, n in _runs(devices):
        c = devices[j0]
        for ev in written:
            streams[c].wait_event(ev)
        with torch.cuda.device(c):
            out = [bufs[j0].new_empty(bufs[j0].shape) for _ in range(n)]
        recv[j0:j0 + n] = out
        if chunk:
            # whole send buffers: the kernel reads slot j0 + jj of each
            send_ptrs = (ctypes.c_void_p * g)(*(b.data_ptr() for b in bufs))
            recv_ptrs = (ctypes.c_void_p * n)(*(r.data_ptr() for r in out))
            cuda_lib.launch("bignn_all_to_all", c, send_ptrs, recv_ptrs, g,
                            j0, n, chunk)
            cuda_lib.count(all_to_all, bufs[0].dtype, suffix=":cards")
    done = []  # every reader's launches are done
    for c in cards:
        ev = torch.cuda.Event()
        ev.record(streams[c])
        done.append(ev)
    for c in cards:
        for ev in done:
            streams[c].wait_event(ev)
    return recv


def _exchange(bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    if len({b.device for b in bufs}) > 1:
        return all_to_all_cards(bufs)
    return all_to_all_launch(bufs)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *bufs):
        return tuple(_exchange(bufs))

    @staticmethod
    def backward(ctx, *grads):
        return tuple(_exchange([g.contiguous() for g in grads]))


def all_to_all(sendbufs: Sequence[torch.Tensor],
               exchange: "ProcessExchange | None" = None
               ) -> list[torch.Tensor]:
    """``recv[j][i] = sendbufs[i][j]`` for the G ``[G, ...]`` send buffers
    of a mesh's graph shards; with ``exchange``, ``sendbufs`` are this
    process's shards' and the result their receive buffers. See the module
    docstring."""
    bufs = list(sendbufs)
    if exchange is not None:
        if len(bufs) != len(exchange.local):
            raise ValueError(f"{len(bufs)} send buffers for this process's "
                             f"{len(exchange.local)} shards")
        _check(bufs, exchange.num_shards)
        return list(_ProcsAllToAll.apply(exchange, *bufs))
    dev = _check(bufs)
    if dev is not None and dev.type == "cpu":
        return all_to_all_plain(bufs)
    return list(_AllToAll.apply(*bufs))


cuda_lib.counter(all_to_all)


# ---------------------------------------------------------------------------
# the exchange across processes
# ---------------------------------------------------------------------------


class _ProcsAllToAll(torch.autograd.Function):
    """The exchange across processes; its backward the same exchange of
    the cotangents, which every process runs in the same order as its
    forward exchanges, reversed."""

    @staticmethod
    def forward(ctx, exchange, *bufs):
        ctx.exchange = exchange
        return tuple(exchange.exchange(bufs))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.exchange.exchange([g.contiguous()
                                               for g in grads]))


class ProcessExchange:
    """The data plane between the processes of the group, through the
    process group (``torch.distributed``, gloo) and the host: the route
    between hosts, the CPU's, and the plain version on the card. Built by
    every process at once (a collective).

    ``local``: this process's graph shards of ``num_shards``, a contiguous
    run; in rank order the processes' runs cover ``range(num_shards)``
    (the host-major layout of ``make_hybrid_mesh``), so a rank-order
    gather is in shard order."""

    def __init__(self, num_shards: int, local: Sequence[int],
                 device: str | torch.device):
        if not dist.is_initialized():
            raise ValueError("an exchange across processes needs a process "
                             "group (parallel.init_distributed)")
        self.num_shards = int(num_shards)
        self.local = [int(j) for j in local]
        self.device = torch.device(device)
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.sent_bytes = 0  # through the process group, by exchange()
        self._copy_stream = None  # exchange()'s own, made at first use
        self.owners = [None] * self.size
        dist.all_gather_object(self.owners, self.local)
        if [j for run in self.owners for j in run] != list(
                range(self.num_shards)):
            raise ValueError(
                f"the processes' graph shards {self.owners} do not lie "
                f"host-major over range({self.num_shards})")

    def gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every process's ``t`` (one shape and type everywhere) in rank
        order, through the process group; a CUDA tensor goes through a
        host copy (gloo's collectives are the host's)."""
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(parts, host)
        return [p.to(t.device) for p in parts]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The processes' ``t`` concatenated along the first axis, in rank
        order."""
        return torch.cat(self.gather(t))

    def ordered_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every process's ``t``, added in rank order, so that
        every process holds the same bits (no ``all_reduce``, whose order is
        not the port's to fix)."""
        parts = self.gather(t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def all_to_all_plain(self, bufs: Sequence[torch.Tensor]
                         ) -> list[torch.Tensor]:
        """Plain version: every process's send buffers gathered in shard
        order, ``all_to_all_plain`` over them, this process's slots."""
        full = self.all_gather(torch.stack(list(bufs)))
        recv = all_to_all_plain(list(full))
        return [recv[j] for j in self.local]

    def exchange(self, bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """This process's receive buffers (the route of ``all_to_all``),
        through the host: the one route that reaches another host, and the
        CPU's. (1) The chunks bound for other processes (slots
        ``owners[q]`` of every local send buffer, for each process q) are
        copied into one host buffer, pinned for a card, on the exchange's
        own stream, which is then synchronised; (2) one
        ``dist.all_to_all_single`` (gloo) moves them as bytes, sized per
        process, nothing for this one; (3) what arrived goes to the
        device in one copy on that stream, which the current stream
        waits on; (4) the receive buffers are written from the
        local send buffers and the arrivals
        (``all_to_all_launch`` on this process's range of destinations,
        ``all_to_all_plain`` on the CPU). Only bytes move, so the result is
        the plain version's exactly."""
        bufs = list(bufs)
        first = bufs[0]
        dev = first.device
        cuda = dev.type == "cuda"
        n_local, lo = len(self.local), self.local[0]
        chunk = first[0].numel() * first.element_size()  # bytes a slot
        sizes = [0 if q == self.rank else n_local * len(run) * chunk
                 for q, run in enumerate(self.owners)]
        send = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=cuda)
        arrived = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=cuda)
        stream = None
        if cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            off = 0
            for q, run in enumerate(self.owners):
                if q == self.rank:
                    continue
                for b in bufs:
                    part = b[run[0]:run[-1] + 1].reshape(-1).view(torch.uint8)
                    send[off:off + part.numel()].copy_(part, non_blocking=cuda)
                    off += part.numel()
            if cuda:
                stream.synchronize()  # gloo reads the host buffer
            dist.all_to_all_single(arrived, send, sizes, sizes)
            landed = arrived.to(dev, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(dev).wait_stream(stream)
            landed.record_stream(torch.cuda.current_stream(dev))
        self.sent_bytes += send.numel()
        # every source shard's chunks for this process's destinations,
        # [n_local, *slot], in shard order
        slot = tuple(first.shape[1:])
        sources, off = [], 0
        for p, run in enumerate(self.owners):
            if p == self.rank:
                sources += [b[lo:lo + n_local] for b in bufs]
                continue
            for _ in run:
                n = n_local * chunk
                sources.append(landed[off:off + n].view(first.dtype)
                               .view(n_local, *slot))
                off += n
        if cuda:
            return all_to_all_launch(sources, lo, ":hosts")
        return all_to_all_plain(sources)

    def close(self) -> None:
        """Free what the exchange holds outside PyTorch's memory (a
        collective; nothing here)."""


class _CudaArray:
    """``count`` bytes at a device pointer, for ``torch.as_tensor`` (the
    CUDA array interface: a view, no copy)."""

    def __init__(self, ptr: int, count: int):
        self.__cuda_array_interface__ = {
            "shape": (count,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


class PeerExchange(ProcessExchange):
    """The exchange across the processes of one host, through CUDA IPC: on
    one card they share, or on cards of their own that reach each other by
    peer access (a staging buffer on a peer's card is read through it).

    Each process owns one staging buffer (``bignn_ipc_alloc``, outside
    PyTorch's caching allocator) and maps every peer's (``bignn_ipc_open``
    on the handles traded through the process group). An exchange: (1)
    this process's send buffers are copied into its staging buffer; (2) its
    stream is synchronised, then a process-group barrier; (3) one launch of
    ``bignn_all_to_all`` writes its receive buffers, reading every
    source from its own or a peer's staging buffer; (4) its stream is
    synchronised, then a barrier, before any staging buffer is written
    again. ``all_gather`` and ``ordered_sum`` run the same protocol with
    PyTorch ops on the mapped buffers in place of the launch. The buffer
    grows to the largest payload seen (every process sees the same
    shapes), by a collective re-exchange of the handles. The buffers live
    until ``close`` (a collective), or the process's end. A failed
    allocation, IPC open or launch raises."""

    def __init__(self, num_shards: int, local: Sequence[int],
                 device: str | torch.device):
        super().__init__(num_shards, local, device)
        if self.device.type != "cuda":
            raise ValueError(f"PeerExchange needs a CUDA device, got "
                             f"{self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.capacity = 0  # bytes of every process's staging buffer
        self._own: int | None = None
        self._peers: list[int] = []  # each process's buffer, as mapped here

    def _reserve(self, nbytes: int) -> None:
        """Staging buffers of at least ``nbytes`` in every process (every
        process asks for the same ``nbytes``)."""
        if nbytes <= self.capacity:
            return
        self.close()
        ptr = ctypes.c_void_p()
        cuda_lib.call("bignn_ipc_alloc", self.device, nbytes,
                      ctypes.byref(ptr))
        self._own = ptr.value
        handle = ctypes.create_string_buffer(64)
        cuda_lib.call("bignn_ipc_handle", self.device, self._own, handle)
        handles = [None] * self.size
        dist.all_gather_object(handles, handle.raw)
        self._peers = []
        for p, raw in enumerate(handles):
            if p == self.rank:
                self._peers.append(self._own)
                continue
            mapped = ctypes.c_void_p()
            cuda_lib.call("bignn_ipc_open", self.device,
                          ctypes.create_string_buffer(raw, 64),
                          ctypes.byref(mapped))
            self._peers.append(mapped.value)
        self.capacity = nbytes

    def close(self) -> None:
        """Unmap the peers' buffers and free this one's, once no process
        reads it (a collective)."""
        if self._own is None:
            return
        torch.cuda.synchronize(self.device)
        dist.barrier()
        for p, ptr in enumerate(self._peers):
            if p != self.rank:
                cuda_lib.call("bignn_ipc_close", self.device, ptr)
        dist.barrier()  # no process maps this buffer any more
        cuda_lib.call("bignn_ipc_free", self.device, self._own)
        self._own, self._peers, self.capacity = None, [], 0

    def _staged(self, p: int, like: torch.Tensor, count: int = 1
                ) -> torch.Tensor:
        """Process p's staging buffer as ``count`` tensors shaped like
        ``like`` (one ``[count, *like.shape]`` view), on the card it lies
        on: this process's, or a peer's (mapped by IPC, read through peer
        access)."""
        nbytes = count * like.numel() * like.element_size()
        raw = torch.as_tensor(_CudaArray(self._peers[p], nbytes))
        return raw.view(like.dtype).view(count, *like.shape)

    def _read(self, p: int, like: torch.Tensor) -> torch.Tensor:
        """Process p's staged tensor on this process's card (a peer copy
        where it lies on another card)."""
        return self._staged(p, like)[0].to(self.device)

    def _publish(self, tensors: Sequence[torch.Tensor]) -> None:
        """Steps (1) and (2): ``tensors`` into this process's staging
        buffer, then every process's copies done."""
        first = tensors[0]
        # the same size in every process: as many tensors as the most
        # shards a process holds
        self._reserve(first.numel() * first.element_size()
                      * max(len(run) for run in self.owners))
        self._staged(self.rank, first, len(tensors)).copy_(
            torch.stack([t.detach() for t in tensors]))
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier()

    def _release(self) -> None:
        """Step (4): this process's reads done, then every process's."""
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier()

    def exchange(self, bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        if bufs[0].device.type != "cuda":
            return self.all_to_all_plain(bufs)
        return self.launch(bufs)

    def launch(self, bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Steps (1)-(4) with one kernel launch: this process's receive
        buffers."""
        bufs = list(bufs)
        for b in bufs:
            if b.device != self.device:
                raise ValueError(f"send buffer on {b.device}, the "
                                 f"exchange's device is {self.device}")
        if self.num_shards > MAX_SHARDS:
            raise ValueError(f"all_to_all kernel takes at most {MAX_SHARDS} "
                             f"shards, got {self.num_shards}")
        self._publish(bufs)
        recv = [torch.empty_like(b) for b in bufs]
        self.launch_staged(recv)
        self._release()
        return recv

    def launch_staged(self, recv: Sequence[torch.Tensor]) -> None:
        """Step (3) alone: one launch into ``recv`` (this process's receive
        buffers, each shaped like a send buffer) from the staging buffers as
        they stand, with no copy and no barrier; the caller keeps every
        process's staging buffer unchanged until it has synchronised."""
        slot = recv[0].numel() * recv[0].element_size()  # one send buffer
        chunk = slot // self.num_shards
        if not chunk:
            return
        sources = []
        for p, run in enumerate(self.owners):
            sources += [self._peers[p] + k * slot for k in range(len(run))]
        send_ptrs = (ctypes.c_void_p * self.num_shards)(*sources)
        recv_ptrs = (ctypes.c_void_p * len(recv))(
            *(r.data_ptr() for r in recv))
        cuda_lib.launch("bignn_all_to_all", self.device, send_ptrs,
                        recv_ptrs, self.num_shards, self.local[0],
                        len(self.local), chunk)
        cuda_lib.count(all_to_all, recv[0].dtype, suffix=":procs")

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return super().all_gather(t)
        return self._staged_gather(t)

    def ordered_sum(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return super().ordered_sum(t)
        return self._staged_sum(t)

    def _staged_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``all_gather`` through the staging buffers."""
        t = t.contiguous()
        self._publish([t])
        out = torch.cat([self._read(p, t) for p in range(self.size)])
        self._release()
        return out

    def _staged_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``ordered_sum`` through the staging buffers."""
        t = t.contiguous()
        self._publish([t])
        total = self._read(0, t).clone()
        for p in range(1, self.size):
            total = total + self._read(p, t)
        self._release()
        return total

