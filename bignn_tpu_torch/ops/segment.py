"""Segment sum (counterpart of ``bignn_tpu/ops/segment.py`` and
``bignn_tpu/ops/pallas/segment.py:segment_sum_pallas``).

``segment_sum`` runs the CUDA kernel ``csrc/segment_sum.cu`` on a CUDA
tensor and its plain version on a CPU tensor. Unlike the TPU kernel, it does
not need sorted ids: the block-local readout layout puts padding ids between
molecules (ROADMAP F1), and the kernel is right for those by contract.
Forward only; training will add a row-gather backward.
"""

from __future__ import annotations

import torch

from bignn_tpu_torch.ops import cuda_lib


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain PyTorch segment sum: ``index_add_`` over the valid ids.

    Ids outside ``[0, num_segments)`` are dropped (sent to a spare row)."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, torch.where(keep, ids, num_segments), data)
    return out[:num_segments]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[e] over e with segment_ids[e] == s``.

    ``data`` is ``[E, F]`` (or ``[E]``) f32, ``segment_ids`` ``[E]`` int32 in
    any order; ids outside ``[0, num_segments)`` are dropped. A CPU tensor
    takes the plain version; any other goes to the kernel, which raises on
    what it does not take."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, segment_ids, num_segments)
    if data.dtype != torch.float32:
        raise NotImplementedError(
            f"segment_sum kernel takes float32, got {data.dtype} "
            "(bf16 comes with config4; ROADMAP Queue 1)")
    if data.dim() == 1:
        return segment_sum(data[:, None], segment_ids, num_segments)[:, 0]
    dev = data.device
    cuda_lib.require_cuda(data, "data", torch.float32, 2, dev)
    cuda_lib.require_cuda(segment_ids, "segment_ids", torch.int32, 1, dev)
    e, f = data.shape
    if segment_ids.shape[0] != e:
        raise ValueError(f"segment_ids has {segment_ids.shape[0]} rows, "
                         f"data {e}")
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    first = torch.empty(num_segments, dtype=torch.int32, device=dev)
    last = torch.empty(num_segments, dtype=torch.int32, device=dev)
    cuda_lib.launch("bignn_segment_sum_f32", dev, data.data_ptr(),
                    segment_ids.data_ptr(), e, f, num_segments,
                    first.data_ptr(), last.data_ptr(), out.data_ptr())
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
