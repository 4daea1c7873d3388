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
is no route through the host). Each card launches the kernel once
(``all_to_all:<dtype>:cards``), and the TPU kernel's semaphores live on the
cards (``DeviceBarrier``, the kernel's kSync form): a signal area on each
card, made once a set of cards (``card_barrier``), in which every launch
arrives, waits for its peers' arrival, copies, tells every card it is done
and waits for every card's "done" before it exits. So a card's buffers are
free again when its kernel ends, in its own stream's order: the caching
allocator, which recycles a freed block on its own card's stream and cannot
see a read from another card, never hands out a send buffer still being
read, and the host neither records nor waits on an event. A launch pulls:
its destinations, every source through the source's device pointer. Every
wait is bounded (``EXCHANGE_TIMEOUT_S``): a card whose peer never comes
gives up and fills what it did not copy with NaN, and the next exchange
over those cards, or ``check_cards`` (``parallel/comm.py``
``CardExchange.close``), raises, naming the card it waited on.

Across processes (the multi-process p2 run), ``all_to_all(sendbufs,
exchange)`` takes this process's shards' send buffers (each ``[G, ...]``,
on its shard's device: one card, or several cards of the process, as a
JAX process drives its host's chips) and returns their receive buffers,
through ``exchange``, built collectively once per mesh
(``parallel.comm.make_exchange``). ``ProcessExchange`` is the route
between hosts, and the CPU's: each process sends every other one only the
chunks that process's shards need, through the process group (one gloo
``all_to_all_single`` over host copies from each local card, pinned), and
each local card writes its receive buffers from the local chunks (a local
peer's read through peer access) and the arrivals (one launch of the
kernel a card on its run of destinations, counted under
``all_to_all:<dtype>:hosts``). Its ``all_to_all_plain`` gathers every
process's whole send buffers instead: the plain version. When every
process runs on one host with cards that reach each other,
``PeerExchange`` copies each local card's send buffers into a staging
buffer on that card that every other process maps by CUDA IPC, and one
launch a local card pulls its receive buffers from every source: a local
send buffer (through peer access from another local card) or another
process's staging buffer; its launches count under
``all_to_all:<dtype>:procs``. Where every process's cards are distinct
cards, the launches carry the semaphores on the cards, in signal areas at
the head of the staging buffers; where processes share a card (whose
kernels the card time-slices, so that a spinning kernel could wait out its
slice for a peer that cannot run), every local card's stream is
synchronised and the processes meet at a barrier between the staging
copies and the launches, and again after the launches. The same objects
give the all-gather and the ordered sum, one term a card of every process
in (process, card) order, that keep the replicated state equal in every
process and on every card (``parallel/comm.py``). A mix of device types
raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Sequence

import torch
import torch.distributed as dist

from bignn_tpu_torch.ops import cuda_lib

# shards (and cards) whose pointers a launch takes by value (kInline of
# csrc/all_to_all.cu); past that the wrapper fills a table on the card
INLINE_SHARDS = 32
# The limit of every wait on the cards' semaphores, past which the kernel
# gives up and the wrapper raises. It lies well above the longest host gap
# between two processes' exchanges on any path: a process's first exchange
# follows its first use of the kernels, which builds them (~4 s of nvcc on
# the card's machine, every process building at once after the collective
# that made the exchange), and every process-0 checkpoint save is followed
# by a barrier, so no process spins through another's save.
EXCHANGE_TIMEOUT_S = 120.0


def signal_bytes(cards: int) -> int:
    """Bytes of a card's signal area in an exchange over ``cards`` cards
    (``csrc/all_to_all.cu``): 32 words of its own, then ``arrived[cards]``
    and ``done[cards]``, each rounded up to 32 words; at least 1 KB."""
    words = 32 + 2 * (-(-cards // 32) * 32)
    return max(1024, 4 * words)


def _table(words: Sequence[int], dev: torch.device) -> torch.Tensor:
    """``words`` (pointers and indices) as 64-bit words on ``dev``, copied
    from pinned memory in the current stream's order: the kernel's table
    past ``INLINE_SHARDS`` shards or cards. The caching allocators keep
    both copies until the stream has used them."""
    host = torch.tensor(list(words), dtype=torch.int64).pin_memory()
    return host.to(dev, non_blocking=True)


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


def _pull(dev: torch.device, sources: Sequence[int],
          recv: Sequence[torch.Tensor], j_begin: int, chunk: int,
          suffix: str) -> None:
    """One launch of the kernel on ``dev``: slot ``j_begin + jj`` of every
    source into ``recv[jj]`` (slot i from source i), ``sources`` the base
    pointers of the G sources as the kernel reads them (slot j at ``j *
    chunk`` bytes). The launch counts under ``all_to_all:<dtype><suffix>``,
    and on ``dev`` (``launches_by_device``)."""
    g, n = len(sources), len(recv)
    if not 0 <= j_begin <= g - n:
        raise ValueError(f"all_to_all kernel takes a range of the shards' "
                         f"destinations, got {n} from {j_begin} of {g}")
    if not chunk:
        return
    recv_ptrs = [r.data_ptr() for r in recv]
    if g <= INLINE_SHARDS:
        cuda_lib.launch("bignn_all_to_all", dev,
                        (ctypes.c_void_p * g)(*sources),
                        (ctypes.c_void_p * n)(*recv_ptrs), g, j_begin, n,
                        chunk)
    else:
        dests = [0] * g
        dests[j_begin:j_begin + n] = recv_ptrs
        table = _table([*sources, *dests, *[0] * g,
                        *range(j_begin, j_begin + n)], dev)
        cuda_lib.launch("bignn_all_to_all_table", dev, table.data_ptr(), g,
                        n, chunk)
    _count(dev, recv[0].dtype, suffix)


def _count(dev: torch.device, dtype: torch.dtype, suffix: str) -> None:
    """One launch on ``dev``, under ``all_to_all:<dtype><suffix>`` and by
    card (``launches_by_device``)."""
    cuda_lib.count(all_to_all, dtype, suffix=suffix)
    key = str(dev)
    all_to_all.launches_by_device[key] = (
        all_to_all.launches_by_device.get(key, 0) + 1)


def _array(ctype, values) -> ctypes.Array:
    values = list(values)
    return (ctype * len(values))(*values)


class DeviceBarrier:
    """The exchange's semaphores on the cards (``csrc/all_to_all.cu``, the
    kSync form) for the participant cards ``names`` (every card of the
    exchange, in every process, labelled for errors): ``cards`` are this
    process's, ``me[k]`` card k's index among the participants and
    ``areas[k]`` every participant's signal area as card k reaches it.
    Each local card has an error word in mapped host memory, which the host
    reads without synchronising: ``check`` raises once a wait has expired,
    naming the card waited on (the receive chunks the kernel did not copy
    are then NaN). ``timeout_s``: the limit of every wait
    (default ``EXCHANGE_TIMEOUT_S``)."""

    def __init__(self, cards, me, areas, names, timeout_s=None):
        self.cards = [torch.device(c) for c in cards]
        self.names = list(names)
        self.timeout_s = float(EXCHANGE_TIMEOUT_S if timeout_s is None
                               else timeout_s)
        self._me = _array(ctypes.c_int, me)
        self._devices = _array(ctypes.c_int, (c.index for c in self.cards))
        self._areas = _array(ctypes.c_void_p, (a for row in areas
                                               for a in row))
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        cuda_lib.call("bignn_host_alloc", self.cards[0], 4 * len(self.cards),
                      ctypes.byref(host), ctypes.byref(dev))
        self._host, self._dev = host.value, dev.value
        self._words = (ctypes.c_uint32 * len(self.cards)).from_address(
            self._host)

    def error(self) -> str | None:
        """What expired, or None."""
        for k, c in enumerate(self.cards):
            code = self._words[k] if self._host else 0
            if code:
                what = ("to arrive" if code >> 30 == 1
                        else "to finish the exchange")
                card = (code & (2**30 - 1)) - 1
                return (f"all_to_all on {c} waited past {self.timeout_s:g} s "
                        f"for {self.names[card]} {what}")
        return None

    def check(self) -> None:
        msg = self.error()
        if msg:
            raise RuntimeError(msg)

    def launch(self, send: Sequence[Sequence[int]], recv: Sequence[int],
               card_of: Sequence[int], chunk: int) -> None:
        """One launch on each local card, in one host call, on each card's
        current stream: card k pulls into its shards' receive buffers from
        every source (``card_of[s]``: shard s's participant card).
        ``send[k][i]``: shard i's send buffer as card k
        reaches it (slot j at ``j * chunk`` bytes); ``recv[j]``: shard j's
        receive buffer (0 where no local card writes it). Past
        ``INLINE_SHARDS`` shards or cards each card takes a table of these
        pointers, its shards and the signal areas, filled on it first."""
        g, n = len(recv), len(self.names)
        tables = None
        if g > INLINE_SHARDS or n > INLINE_SHARDS:
            tables = [_table([*send[k], *recv, *card_of,
                              *(s for s in range(g)
                                if card_of[s] == self._me[k]),
                              *self._areas[k * n:(k + 1) * n]], c)
                      for k, c in enumerate(self.cards)]
        cuda_lib.call(
            "bignn_all_to_all_sync", self.cards[0],
            _array(ctypes.c_void_p, (p for row in send for p in row)),
            _array(ctypes.c_void_p, recv), g,
            _array(ctypes.c_int, card_of), chunk, self._areas, n,
            len(self.cards), self._me, self._devices,
            _array(ctypes.c_void_p, (torch.cuda.current_stream(c).cuda_stream
                                     for c in self.cards)),
            self._dev, int(self.timeout_s * 1e9),
            None if tables is None else _array(
                ctypes.c_void_p, (t.data_ptr() for t in tables)))

    def close(self) -> None:
        """Free the error words, once every card is synchronised; raise if
        a wait had expired."""
        if not self._host:
            return
        msg = self.error()
        cuda_lib.call("bignn_host_free", self.cards[0], self._host)
        self._host = self._words = None
        if msg:
            raise RuntimeError(msg)


def all_to_all_launch(bufs: Sequence[torch.Tensor], j_begin: int = 0,
                      suffix: str = "") -> list[torch.Tensor]:
    """Run the kernel on the G contiguous CUDA buffers ``bufs``, each ``[n,
    ...]``: slot jj of ``bufs[i]`` goes to slot i of new receive buffer jj,
    of destination ``j_begin + jj`` (n = G, ``j_begin`` 0: one process's
    whole exchange; n < G: the destinations of one process of several,
    each source's base pointer set back by ``j_begin`` slots so that the
    kernel's slot j lands on row ``j - j_begin``). Its launch counts
    under ``all_to_all:<dtype><suffix>``."""
    n = bufs[0].shape[0]
    dev = bufs[0].device
    if dev.type != "cuda":
        raise ValueError(f"all_to_all send buffers must be CUDA tensors, "
                         f"got {dev}")
    recv = [bufs[0].new_empty((len(bufs), *bufs[0].shape[1:]))
            for _ in range(n)]
    chunk = bufs[0][0].numel() * bufs[0].element_size()
    _pull(dev, [b.data_ptr() - j_begin * chunk for b in bufs], recv, j_begin,
          chunk, suffix)
    return recv


def _runs(devices: Sequence) -> list[tuple[int, int]]:
    """``(first, count)`` of each run of consecutive shards on one
    device (or card slot)."""
    runs = []
    for j, d in enumerate(devices):
        if runs and devices[runs[-1][0]] == d:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((j, 1))
    return runs


def _events(cards: Sequence[torch.device]) -> list:
    """An event recorded on each card's current stream."""
    events = []
    for c in cards:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(c))
        events.append(ev)
    return events


def _wait(cards: Sequence[torch.device], events: Sequence) -> None:
    """Every card's current stream waits on every event."""
    for c in cards:
        stream = torch.cuda.current_stream(c)
        for ev in events:
            stream.wait_event(ev)


_barriers: dict[tuple[int, ...], DeviceBarrier] = {}  # by the cards' indices


def card_barrier(cards: Sequence[torch.device]) -> DeviceBarrier:
    """The semaphores of the exchanges over ``cards`` (distinct cards of
    this process, in order): a zeroed signal area on each
    (``bignn_ipc_alloc``), every card reaching every other's through peer
    access. Made once a set of cards, beside the peer access, for the
    process's life: every card of the set runs each of its exchanges, so
    their epochs agree."""
    key = tuple(torch.device(c).index for c in cards)
    if key not in _barriers:
        areas = []
        for c in cards:
            ptr = ctypes.c_void_p()
            size = signal_bytes(len(cards))
            cuda_lib.call("bignn_ipc_alloc", c, size, size,
                          ctypes.byref(ptr))
            areas.append(ptr.value)
        _barriers[key] = DeviceBarrier(cards, range(len(cards)),
                                       [areas] * len(cards),
                                       [str(c) for c in cards])
    return _barriers[key]


def check_cards(cards: Sequence[torch.device]) -> None:
    """Synchronise ``cards`` and raise if a wait of an exchange over them
    had expired (nothing to check where none ran): where a run ends, after
    its last exchange."""
    barrier = _barriers.get(tuple(torch.device(c).index for c in cards))
    if barrier is not None:
        for c in barrier.cards:
            torch.cuda.synchronize(c)
        barrier.check()


def all_to_all_cards(bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The exchange of G contiguous ``[G, ...]`` send buffers that lie on
    distinct cards of this process; receive buffer j on buffer j's card.
    One launch a card, with the semaphores on the cards (the module
    docstring), counted under ``all_to_all:<dtype>:cards``. Between the
    first launch and the last nothing synchronises: every card's kernel
    waits for the others' launches."""
    bufs = list(bufs)
    devices = [b.device for b in bufs]
    cards = list(dict.fromkeys(devices))
    enable_peer_access(cards)
    barrier = card_barrier(cards)
    barrier.check()
    card_of = [cards.index(d) for d in devices]
    recv = [b.new_empty(b.shape) for b in bufs]  # before the first launch
    chunk = bufs[0][0].numel() * bufs[0].element_size()
    if not chunk:
        return recv
    send_ptrs = [b.data_ptr() for b in bufs]
    barrier.launch([send_ptrs] * len(cards), [r.data_ptr() for r in recv],
                   card_of, chunk)
    for c in cards:
        _count(c, bufs[0].dtype, ":cards")
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
all_to_all.launches_by_device = {}  # launches by card (str(device))


# ---------------------------------------------------------------------------
# the exchange across processes
# ---------------------------------------------------------------------------


class _ProcsAllToAll(torch.autograd.Function):
    """The exchange across processes; its backward the same exchange of
    the cotangents, which every process runs in the same order as its
    forward exchanges, reversed. One node over every local card, so that
    it runs once however many cards' backward threads feed it."""

    @staticmethod
    def forward(ctx, exchange, *bufs):
        ctx.exchange = exchange
        return tuple(exchange.exchange(bufs))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.exchange.exchange([g.contiguous()
                                               for g in grads]))


def _cuda(d) -> torch.device:
    """``d`` as a device, ``cuda`` without an index as the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class ProcessExchange:
    """The data plane between the processes of the group, through the
    process group (``torch.distributed``, gloo) and the host: the route
    between hosts, the CPU's, and the plain version on the card. Built by
    every process at once (a collective).

    ``local``: this process's graph shards of ``num_shards``, a contiguous
    run; in rank order the processes' runs cover ``range(num_shards)``
    (the host-major layout of ``make_hybrid_mesh``), so a rank-order
    gather is in shard order. ``devices``: every local shard's device.
    ``card_of``: each local shard's card, runs of consecutive shards
    (default: by device; the CPU tests give the CPU several card slots).
    ``cards`` are the cards' devices, ``heads`` each
    card's first local shard; every process holds as many shards and
    cards, ``total_cards`` in all. Cards of this process read each other's
    send buffers by peer access (enabled at the first exchange; a pair
    without it raises)."""

    def __init__(self, num_shards: int, local: Sequence[int], devices,
                 card_of: Sequence[int] | None = None):
        if not dist.is_initialized():
            raise ValueError("an exchange across processes needs a process "
                             "group (parallel.init_distributed)")
        self.num_shards = int(num_shards)
        self.local = [int(j) for j in local]
        self.devices = [_cuda(d) for d in devices]
        if len(self.devices) != len(self.local):
            raise ValueError(f"{len(self.devices)} devices for "
                             f"{len(self.local)} local shards")
        if card_of is None:
            order = list(dict.fromkeys(self.devices))
            card_of = [order.index(d) for d in self.devices]
        self.card_of = [int(c) for c in card_of]
        if [self.card_of[j0] for j0, _ in _runs(self.card_of)] != list(
                range(len(set(self.card_of)))):
            raise ValueError(f"cards {self.card_of}: each card's shards "
                             "are one run, cards numbered in order")
        self.heads = [self.card_of.index(c)
                      for c in range(len(set(self.card_of)))]
        self.cards = [self.devices[j] for j in self.heads]
        self.device = self.devices[0]
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.sent_bytes = 0  # through the process group, by exchange()
        self._copy_streams: dict = {}  # exchange()'s own, made at first use
        layouts = [None] * self.size
        dist.all_gather_object(layouts, (self.local, self.card_of))
        self.owners = [run for run, _ in layouts]
        self.cards_of = [cards for _, cards in layouts]
        if [j for run in self.owners for j in run] != list(
                range(self.num_shards)):
            raise ValueError(
                f"the processes' graph shards {self.owners} do not lie "
                f"host-major over range({self.num_shards})")
        if len({(len(run), max(cards)) for run, cards in layouts}) != 1:
            raise ValueError(f"the processes hold shards {self.owners} on "
                             f"cards {self.cards_of}: every process as many")
        self.total_cards = self.size * len(self.cards)

    def _check_devices(self, bufs: Sequence[torch.Tensor]) -> None:
        """Each send buffer on its shard's device, and peer access between
        the local cards (enabled once; a pair without it raises)."""
        for b, d in zip(bufs, self.devices):
            if b.device != d:
                raise ValueError(f"send buffer on {b.device}, its shard's "
                                 f"device is {d}")
        if len(self.cards) > 1 and self.device.type == "cuda":
            enable_peer_access(self.cards)

    def _sync(self) -> None:
        """Synchronise every local card's current stream."""
        for c in self.cards:
            if c.type == "cuda":
                torch.cuda.current_stream(c).synchronize()

    def gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every process's ``t`` (one shape and type everywhere) in rank
        order, through the process group; a CUDA tensor goes through a
        host copy (gloo's collectives are the host's)."""
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(parts, host)
        return [p.to(t.device) for p in parts]

    def gather_parts(self, parts: Sequence[torch.Tensor]
                     ) -> list[torch.Tensor]:
        """Every process's ``parts`` (as many tensors of one shape and type
        in every process, a card's or a slot's each) in (process, part)
        order, on this process's first device."""
        stacked = torch.stack([p.detach().to(self.device) for p in parts])
        return [x for s in self.gather(stacked) for x in s.unbind(0)]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The processes' ``t`` concatenated along the first axis, in rank
        order, on this process's first device."""
        return torch.cat(self.gather_parts([t]))

    def ordered_sum(self, parts) -> torch.Tensor:
        """The sum of every process's ``parts`` (a tensor, or a list of
        them: one term a card or a slot), added one term at a time in
        (process, part) order, so that every process holds the same bits
        (no ``all_reduce``, whose order is not the port's to fix, and no
        partial sum a process first)."""
        terms = self.gather_parts(
            [parts] if isinstance(parts, torch.Tensor) else parts)
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return total

    def all_to_all_plain(self, bufs: Sequence[torch.Tensor]
                         ) -> list[torch.Tensor]:
        """Plain version: every process's send buffers gathered in shard
        order, ``all_to_all_plain`` over them, this process's slots, each
        on its shard's device."""
        full = self.all_gather(torch.stack([b.to(self.device) for b in bufs]))
        recv = all_to_all_plain(list(full))
        return [recv[j].to(d) for j, d in zip(self.local, self.devices)]

    def _copy_stream(self, c: torch.device):
        if c not in self._copy_streams:
            self._copy_streams[c] = torch.cuda.Stream(c)
        return self._copy_streams[c]

    def exchange(self, bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """This process's receive buffers (the route of ``all_to_all``),
        through the host: the one route that reaches another host, and the
        CPU's. (1) The chunks bound for other processes (slots
        ``owners[q]`` of every local send buffer, for each process q) are
        copied into one pinned host buffer, each from its card on that
        card's copy stream, and those streams are synchronised; (2) one
        ``dist.all_to_all_single`` (gloo) moves them as bytes, sized per
        process, nothing for this one; (3) what arrived goes to each local
        card in one copy on its copy stream, which the card's current
        stream waits on; (4) each card writes its receive buffers, one
        launch on its run of destinations reading the local send buffers
        (another card's through peer access, between event barriers on
        the local cards) and the arrivals (``all_to_all_plain`` on the
        CPU). Only bytes move, so the result is the plain version's
        exactly."""
        bufs = list(bufs)
        self._check_devices(bufs)
        first = bufs[0]
        cuda = first.device.type == "cuda"
        n_local, lo = len(self.local), self.local[0]
        chunk = first[0].numel() * first.element_size()  # bytes a slot
        sizes = [0 if q == self.rank else n_local * len(run) * chunk
                 for q, run in enumerate(self.owners)]
        send = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=cuda)
        arrived = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=cuda)
        if cuda:
            for c in self.cards:
                self._copy_stream(c).wait_stream(torch.cuda.current_stream(c))
        off = 0
        for q, run in enumerate(self.owners):
            if q == self.rank:
                continue
            for b in bufs:
                part = b[run[0]:run[-1] + 1].reshape(-1).view(torch.uint8)
                with (torch.cuda.stream(self._copy_stream(b.device)) if cuda
                      else contextlib.nullcontext()):
                    send[off:off + part.numel()].copy_(part, non_blocking=cuda)
                off += part.numel()
        if cuda:
            for c in self.cards:  # gloo reads the host buffer
                self._copy_stream(c).synchronize()
        dist.all_to_all_single(arrived, send, sizes, sizes)
        self.sent_bytes += send.numel()
        if not cuda:
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
                    sources.append(arrived[off:off + n].view(first.dtype)
                                   .view(n_local, *slot))
                    off += n
            return all_to_all_plain(sources)
        landed = {}
        for c in self.cards:
            with torch.cuda.stream(self._copy_stream(c)):
                landed[c] = arrived.to(c, non_blocking=True)
            torch.cuda.current_stream(c).wait_stream(self._copy_stream(c))
            landed[c].record_stream(torch.cuda.current_stream(c))
        if len(self.cards) > 1:
            _wait(self.cards, _events(self.cards))
        recv: list[torch.Tensor] = [None] * n_local
        for k0, n in _runs(self.card_of):
            c = self.devices[k0]
            # local sources whole (slot j at j * chunk); an arrived source
            # holds slots lo.., so its base is set back by lo slots
            sources, off = [], 0
            for p, run in enumerate(self.owners):
                if p == self.rank:
                    sources += [b.data_ptr() for b in bufs]
                    continue
                for _ in run:
                    sources.append(landed[c].data_ptr() + off - lo * chunk)
                    off += n_local * chunk
            with torch.cuda.device(c):
                recv[k0:k0 + n] = [torch.empty_like(bufs[k0])
                                   for _ in range(n)]
            _pull(c, sources, recv[k0:k0 + n], lo + k0, chunk, ":hosts")
        if len(self.cards) > 1:
            _wait(self.cards, _events(self.cards))
        return recv

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


def _view(ptr: int, like: torch.Tensor, count: int = 1) -> torch.Tensor:
    """``count`` tensors shaped like ``like`` at device pointer ``ptr`` (one
    ``[count, *like.shape]`` view, on the card the memory lies on)."""
    nbytes = count * like.numel() * like.element_size()
    raw = torch.as_tensor(_CudaArray(ptr, nbytes))
    return raw.view(like.dtype).view(count, *like.shape)


def _card_uuid(card: torch.device) -> str:
    """The card's UUID; its name where CUDA does not run (where the
    exchange never launches: building it touches no card)."""
    if not torch.cuda.is_available():
        return str(card)
    return str(torch.cuda.get_device_properties(card).uuid)


class PeerExchange(ProcessExchange):
    """The exchange across the processes of one host, through CUDA IPC: on
    one card they share, or on cards of their own that reach each other by
    peer access (a staging buffer on a peer's card is read through it).

    Each local card owns one staging buffer (``bignn_ipc_alloc``, outside
    PyTorch's caching allocator): a signal area (``signal_bytes`` of
    every process's cards), then
    the payload. Each local card maps every other process's
    (``bignn_ipc_open`` on the handles traded through the process group,
    once a handle a card: CUDA lets each card of a process open a handle
    once, and a mapping opened on one card is not readable from another,
    peer access or not: an illegal address on the H100s). An exchange: (1)
    each card's send buffers are copied into its staging buffer; (2) one
    launch of the kernel a local card writes its receive buffers, reading
    every source: a local send buffer (another local card's through peer
    access) or another process's staging buffer. Where every card of every
    process is a card of its own (``device_barrier``, decided once from
    the cards' UUIDs gathered through the group, so that every process
    chooses alike), the launches carry the semaphores on the cards
    (``DeviceBarrier`` over the signal areas), which make each launch wait
    for every card's arrival and keep each card's buffers until every card
    is done with them; nothing else. Otherwise (processes sharing a card)
    every local card's stream is synchronised and the processes meet at a
    barrier before the launches and again after them, before any staging
    buffer or send buffer is written again. ``gather_parts`` (under
    ``all_gather`` and ``ordered_sum``) runs that host protocol on the
    first card's staging buffers (as the first card maps them) with
    PyTorch copies in place of the launches. The buffers grow to the
    largest payload seen (every process sees the same shapes), by a
    collective re-exchange of the handles that zeroes every signal area,
    and live until ``close`` (a collective), or the process's end. A failed
    allocation, IPC open or launch raises."""

    def __init__(self, num_shards: int, local: Sequence[int], devices,
                 card_of: Sequence[int] | None = None):
        super().__init__(num_shards, local, devices, card_of)
        if any(c.type != "cuda" for c in self.cards) or len(
                set(self.cards)) != len(self.cards):
            raise ValueError(f"PeerExchange needs distinct CUDA cards, got "
                             f"{[str(c) for c in self.cards]}")
        uuids = [None] * self.size
        dist.all_gather_object(uuids, [_card_uuid(c) for c in self.cards])
        every = [u for run in uuids for u in run]
        self.device_barrier = len(set(every)) == len(every)
        # the payload's offset in every staging buffer
        self.signal = signal_bytes(len(every))
        self.capacity = 0  # payload bytes of every staging buffer
        self._own: list[int] = []  # each local card's buffer
        # [local card][process][its card]: every staging buffer as that
        # local card maps it (this process's own: their pointers)
        self._maps: list[list[list[int]]] = []
        self._barrier: DeviceBarrier | None = None

    def _reserve(self, nbytes: int) -> None:
        """Staging buffers of at least ``nbytes`` on every card of every
        process (every process asks for the same ``nbytes``), their signal
        areas zeroed."""
        if nbytes <= self.capacity:
            return
        self.close()
        raws = []
        for c in self.cards:
            ptr = ctypes.c_void_p()
            cuda_lib.call("bignn_ipc_alloc", c, self.signal + nbytes,
                          self.signal,
                          ctypes.byref(ptr))
            self._own.append(ptr.value)
            handle = ctypes.create_string_buffer(64)
            cuda_lib.call("bignn_ipc_handle", c, ptr.value, handle)
            raws.append(handle.raw)
        handles = [None] * self.size
        dist.all_gather_object(handles, raws)
        for c in self.cards:
            maps = []
            for p, theirs in enumerate(handles):
                if p == self.rank:
                    maps.append(list(self._own))
                    continue
                mapped = []
                for raw in theirs:
                    ptr = ctypes.c_void_p()
                    cuda_lib.call("bignn_ipc_open", c,
                                  ctypes.create_string_buffer(raw, 64),
                                  ctypes.byref(ptr))
                    mapped.append(ptr.value)
                maps.append(mapped)
            self._maps.append(maps)
        self.capacity = nbytes
        if self.device_barrier:
            n = len(self.cards)
            self._barrier = DeviceBarrier(
                self.cards, [self.rank * n + c for c in range(n)],
                [[a for theirs in maps for a in theirs]
                 for maps in self._maps],
                [f"process {p}'s card {c}" for p in range(self.size)
                 for c in range(n)])

    def close(self) -> None:
        """Unmap the other processes' buffers and free this one's, once no
        process reads them (a collective); raise if a wait on the cards had
        expired."""
        if not self._own:
            return
        for c in self.cards:
            torch.cuda.synchronize(c)
        dist.barrier()
        for c, maps in zip(self.cards, self._maps):
            for p, ptrs in enumerate(maps):
                if p != self.rank:
                    for ptr in ptrs:
                        cuda_lib.call("bignn_ipc_close", c, ptr)
        dist.barrier()  # no process maps these buffers any more
        for c, ptr in zip(self.cards, self._own):
            cuda_lib.call("bignn_ipc_free", c, ptr)
        self._own, self._maps, self.capacity = [], [], 0
        barrier, self._barrier = self._barrier, None
        if barrier is not None:
            barrier.close()

    def _meet(self) -> None:
        """Every local card's stream synchronised, then every process's."""
        self._sync()
        if self._barrier is not None:
            self._barrier.check()
        dist.barrier()

    def gather_parts(self, parts: Sequence[torch.Tensor]
                     ) -> list[torch.Tensor]:
        first = parts[0]
        if first.device.type != "cuda":
            return super().gather_parts(parts)
        n = len(parts)
        self._reserve(n * first.numel() * first.element_size())
        _view(self._own[0] + self.signal, first, n).copy_(
            torch.stack([p.detach().to(self.device) for p in parts]))
        self._meet()
        out = [x.to(self.device, copy=True)
               for p in range(self.size)
               for x in _view(self._maps[0][p][0] + self.signal, first,
                              n).unbind(0)]
        self._meet()
        return out

    def exchange(self, bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        if bufs[0].device.type != "cuda":
            return self.all_to_all_plain(bufs)
        return self.launch(bufs)

    def launch(self, bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Steps (1)-(2) with one kernel launch a local card, between the
        host's barriers where processes share a card: this process's
        receive buffers."""
        bufs = list(bufs)
        self._check_devices(bufs)
        slot = bufs[0].numel() * bufs[0].element_size()
        most = max(n for cards in self.cards_of for _, n in _runs(cards))
        self._reserve(most * slot)
        for k, b in enumerate(bufs):
            c = self.card_of[k]
            _view(self._own[c] + self.signal + (k - self.heads[c]) * slot,
                  b)[0].copy_(b)
        recv = [torch.empty_like(b) for b in bufs]  # before the launches
        if self._barrier is not None:
            self._barrier.check()
            self.launch_staged(recv, bufs)
            return recv
        self._meet()
        self.launch_staged(recv, bufs)
        self._meet()
        return recv

    def launch_staged(self, recv: Sequence[torch.Tensor],
                      bufs: Sequence[torch.Tensor] | None = None) -> None:
        """Step (2) alone: one launch a local card into its ``recv`` (this
        process's receive buffers, each shaped like a send buffer on its
        shard's device) from the local send buffers ``bufs`` (default:
        this process's staging buffers) and the other processes' staging
        buffers as they stand, with no copy and no host barrier (with the
        semaphores on the cards, every process must launch too); without
        them the caller keeps every source unchanged until it has
        synchronised."""
        slot = recv[0].numel() * recv[0].element_size()  # one send buffer
        chunk = slot // self.num_shards
        by_card = []  # every source as each local card reaches it
        for k0, count in _runs(self.card_of):
            maps = self._maps[self.card_of[k0]]  # as this card maps them
            sources = []
            for p, cards in enumerate(self.cards_of):
                for k, c in enumerate(cards):
                    if p == self.rank and bufs is not None:
                        sources.append(bufs[k].data_ptr())
                    else:
                        sources.append(maps[p][c] + self.signal
                                       + (k - cards.index(c)) * slot)
            if self._barrier is None:
                _pull(self.devices[k0], sources, recv[k0:k0 + count],
                      self.local[k0], chunk, ":procs")
            by_card.append(sources)
        if self._barrier is None or not chunk:
            return
        n = len(self.cards)
        dests = [0] * self.num_shards
        for j, r in zip(self.local, recv):
            dests[j] = r.data_ptr()
        self._barrier.launch(by_card, dests,
                             [p * n + c for p, cards in enumerate(
                                 self.cards_of) for c in cards], chunk)
        for c in self.cards:
            _count(c, recv[0].dtype, ":procs")
