"""All-to-all exchange of the shards' send buffers (counterpart of
``bignn_tpu/ops/pallas/collectives.py:all_to_all_pallas``, the wire step of
the halo exchange in ``parallel/halo.py``).

``all_to_all(sendbufs)`` takes the G send buffers ``[G, ...]`` of a mesh's
graph shards (slot j of shard i's buffer goes to shard j) and returns the G
receive buffers: ``recv[j][i] = sendbufs[i][j]``. It is a
``torch.autograd.Function`` whose backward is the same exchange of the
cotangents (the exchange is its own adjoint, as the JAX kernel's
``custom_vjp`` has it). CUDA buffers go to the kernel of
``csrc/all_to_all.cu``, one launch for the whole exchange; CPU buffers take
``all_to_all_plain``. Buffers on distinct CUDA devices need peer access,
still to port, and raise, as does a mix of devices. The wrapper counts its
launches (forward and backward) per element type.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from bignn_tpu_torch.ops import cuda_lib

MAX_SHARDS = 32  # kMaxShards of csrc/all_to_all.cu


def _check(bufs: Sequence[torch.Tensor]) -> torch.device:
    """The one device of ``bufs``; raises unless they are G >= 1 contiguous
    buffers of one shape and type with a leading axis of G."""
    g = len(bufs)
    if g == 0:
        raise ValueError("all_to_all needs at least one send buffer")
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
            raise NotImplementedError(
                "an exchange between distinct CUDA devices needs peer "
                "access, which is still to port (ROADMAP Queue 1 item 11)")
        raise NotImplementedError(
            f"send buffers on several devices {sorted(map(str, devices))}")
    return first.device


def all_to_all_plain(sendbufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Plain version: stack the buffers ``[G (source), G (slot), ...]`` and
    take slot j of every source for shard j. Differentiable by autograd."""
    stacked = torch.stack(list(sendbufs))
    return [stacked[:, j].contiguous() for j in range(len(sendbufs))]


def all_to_all_launch(bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Run the kernel on CUDA buffers (checked by ``_check``); returns new
    receive buffers."""
    g = len(bufs)
    dev = bufs[0].device
    if dev.type != "cuda":
        raise ValueError(f"all_to_all send buffers must be CUDA tensors, "
                         f"got {dev}")
    if g > MAX_SHARDS:
        raise ValueError(f"all_to_all kernel takes at most {MAX_SHARDS} "
                         f"shards, got {g}")
    recv = [torch.empty_like(b) for b in bufs]
    chunk = bufs[0][0].numel() * bufs[0].element_size()
    if chunk:
        send_ptrs = (ctypes.c_void_p * g)(*(b.data_ptr() for b in bufs))
        recv_ptrs = (ctypes.c_void_p * g)(*(r.data_ptr() for r in recv))
        cuda_lib.launch("bignn_all_to_all", dev, send_ptrs, recv_ptrs, g,
                        chunk)
        cuda_lib.count(all_to_all, bufs[0].dtype)
    return recv


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *bufs):
        return tuple(all_to_all_launch(bufs))

    @staticmethod
    def backward(ctx, *grads):
        return tuple(all_to_all_launch([g.contiguous() for g in grads]))


def all_to_all(sendbufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``recv[j][i] = sendbufs[i][j]`` for the G ``[G, ...]`` send buffers
    of a mesh's graph shards; see the module docstring."""
    bufs = list(sendbufs)
    if _check(bufs).type == "cpu":
        return all_to_all_plain(bufs)
    return list(_AllToAll.apply(*bufs))


cuda_lib.counter(all_to_all)
