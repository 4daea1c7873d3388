"""Which card may read another process's CUDA IPC mapping: two processes of
two cards each (four visible cards), the design question behind
``ops.collectives.PeerExchange`` over several cards a process.

    python3 scripts/probe_ipc_mapping.py      # on a host of four cards

Each card allocates a staging buffer (``bignn_ipc_alloc``) and fills it
with a pattern; the processes trade the IPC handles through a gloo group
on a free local port. Each process then maps the other's two buffers and
reads them with the all-to-all kernel (``bignn_all_to_all``, one source,
one destination):

  * ``first_card_reads``: mapped once on its first card, read there;
  * ``each_card_reads``: mapped again on its second card (a second
    ``cudaIpcOpenMemHandle`` of the same handle), read there through that
    mapping; ``same_pointer``: whether the second mapping returned the
    first one's pointer;
  * ``second_card_reads_first_mapping``: the first card's mapping read from
    the second card through peer access (last: a fault ends the process's
    use of the card).

Each process prints one JSON line; the script exits 0 when both ran to the
end, whatever they found.
"""

import ctypes
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NBYTES = 1 << 20


def _pattern(card: int) -> torch.Tensor:
    return (torch.arange(NBYTES) * (7 + 10 * card) % 251).to(torch.uint8)


def worker(rank: int, port: int) -> dict:
    from bignn_tpu_torch.ops import cuda_lib
    from bignn_tpu_torch.ops.collectives import _view, enable_peer_access

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    mine = [torch.device("cuda", 2 * rank + k) for k in range(2)]
    theirs = [2 * (1 - rank) + k for k in range(2)]
    torch.cuda.set_device(mine[0])
    like = torch.empty(NBYTES, dtype=torch.uint8)
    handles = []
    for k, c in enumerate(mine):
        ptr = ctypes.c_void_p()
        cuda_lib.call("bignn_ipc_alloc", c, NBYTES, 0, ctypes.byref(ptr))
        _view(ptr.value, like)[0].copy_(_pattern(2 * rank + k).to(c))
        torch.cuda.synchronize(c)
        handle = ctypes.create_string_buffer(64)
        cuda_lib.call("bignn_ipc_handle", c, ptr.value, handle)
        handles.append(handle.raw)
    every = [None, None]
    dist.all_gather_object(every, handles)
    enable_peer_access([torch.device("cuda", i) for i in range(4)])

    def open_on(card):
        out = []
        for raw in every[1 - rank]:
            ptr = ctypes.c_void_p()
            cuda_lib.call("bignn_ipc_open", card,
                          ctypes.create_string_buffer(raw, 64),
                          ctypes.byref(ptr))
            out.append(ptr.value)
        return out

    def reads(card, ptrs):
        ok = []
        for ptr, q in zip(ptrs, theirs):
            recv = torch.empty(NBYTES, dtype=torch.uint8, device=card)
            cuda_lib.launch("bignn_all_to_all", card,
                            (ctypes.c_void_p * 1)(ptr),
                            (ctypes.c_void_p * 1)(recv.data_ptr()), 1, 0, 1,
                            NBYTES)
            torch.cuda.synchronize(card)
            ok.append(bool(torch.equal(recv.cpu(), _pattern(q))))
        return ok

    res = {"rank": rank}
    first = open_on(mine[0])
    res["first_card_reads"] = reads(mine[0], first)
    second = open_on(mine[1])
    res["same_pointer"] = [a == b for a, b in zip(first, second)]
    res["each_card_reads"] = reads(mine[1], second)
    dist.barrier()
    try:
        res["second_card_reads_first_mapping"] = reads(mine[1], first)
    except Exception as e:  # an illegal address surfaces at the sync
        res["second_card_reads_first_mapping"] = str(e).splitlines()[0]
    return res


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(worker(int(sys.argv[2]), int(sys.argv[3]))),
              flush=True)
        return 0
    if torch.cuda.device_count() < 4:
        raise SystemExit("probe_ipc_mapping: needs four visible cards, "
                         f"found {torch.cuda.device_count()}")
    from bignn_tpu_torch.ops import cuda_lib

    cuda_lib.build()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r),
                               str(port)]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return 0 if rcs == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
