"""Segment sum and segment softmax (counterpart of
``bignn_tpu/ops/segment.py`` and ``bignn_tpu/ops/pallas/segment.py``:
``segment_sum_pallas`` and ``segment_softmax_pallas``).

Both take float32 or bf16 data. As the Pallas kernels do, every sum runs in
float32 and the result is rounded once to the data's type; the plain
versions widen to float32 and round once at the end too (``index_add_``
into a bf16 buffer would round at every step).

``segment_sum`` is a ``torch.autograd.Function``: its forward runs the CUDA
kernel ``csrc/segment_sum.cu`` on a CUDA tensor and the plain version on a
CPU tensor; its backward is the row gather ``g[ids]`` with dropped ids set
to zero, as the JAX VJP (``_segment_sum_bwd``) is an XLA ``take``. Unlike
the TPU kernel, the forward does not need sorted ids: the block-local
readout layout puts padding ids between molecules (ROADMAP F1), and the
kernel is right for those by contract.

``segment_softmax`` (the GAT attention over each destination's edges) is a
``torch.autograd.Function`` too, with the Pallas contract: rows with a
dropped id give exactly 0, the max shift carries no gradient, the
denominator floor is 1e-16, and the backward is the analytic
``alpha g - alpha segsum(alpha g)[ids]``. Both directions run the CUDA
kernels of ``csrc/segment_softmax.cu`` on CUDA tensors (each wrapper counts
its launches, in all and per element type: ``cuda_lib.count``) and the plain
versions on CPU tensors. Like the segment sum,
both are right for any ids (the bounds pass of ``csrc/segment_bounds.cuh``
checks every id), and fast for sorted ones.
"""

from __future__ import annotations

import torch

from bignn_tpu_torch.ops import cuda_lib

DENOM_FLOOR = 1e-16  # bignn_tpu/ops/pallas/segment.py:330
MAX_HEADS = 8  # limit of csrc/segment_softmax.cu


def _slots(segment_ids: torch.Tensor, num_segments: int):
    """``(keep, slot)``: which rows have an id in ``[0, num_segments)``,
    and each row's id with the dropped ones sent to the spare slot
    ``num_segments``."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    return keep, torch.where(keep, ids, num_segments)


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain PyTorch segment sum: ``index_add_`` over the valid ids, in
    float32, rounded once to the data's type.

    Ids outside ``[0, num_segments)`` are dropped (sent to a spare row)."""
    _, slot = _slots(segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]),
                         dtype=torch.float32)
    out = out.index_add(0, slot, data.float())
    return out[:num_segments].to(data.dtype)


def segment_sum_launch(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       perm: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/segment_sum.cu`` on ``[E, F]`` float32 or bf16
    ``data``; the output has the data's type. With ``perm`` the rows summed
    are ``data[perm]``, read in place. Counts nothing: each caller counts
    its own launches."""
    suffix = cuda_lib.require_float(data, "data", "segment_sum")
    dev = data.device
    cuda_lib.require_cuda(data, "data", data.dtype, 2, dev)
    cuda_lib.require_cuda(segment_ids, "segment_ids", torch.int32, 1, dev)
    f = data.shape[1]
    e = segment_ids.shape[0]
    if perm is None and data.shape[0] != e:
        raise ValueError(f"segment_ids has {e} rows, data {data.shape[0]}")
    out = torch.empty((num_segments, f), dtype=data.dtype, device=dev)
    first = torch.empty(num_segments, dtype=torch.int32, device=dev)
    last = torch.empty(num_segments, dtype=torch.int32, device=dev)
    if perm is None:
        cuda_lib.launch(f"bignn_segment_sum_{suffix}", dev, data.data_ptr(),
                        segment_ids.data_ptr(), e, f, num_segments,
                        first.data_ptr(), last.data_ptr(), out.data_ptr())
    else:
        cuda_lib.require_cuda(perm, "perm", torch.int32, 1, dev)
        if perm.shape[0] != e:
            raise ValueError(f"perm has {perm.shape[0]} rows, ids {e}")
        cuda_lib.launch(f"bignn_segment_sum_perm_{suffix}", dev,
                        data.data_ptr(), perm.data_ptr(),
                        segment_ids.data_ptr(), e, f, num_segments,
                        first.data_ptr(), last.data_ptr(), out.data_ptr())
    return out


def _segment_sum_cuda(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    if data.dim() == 1:
        return _segment_sum_cuda(data[:, None], segment_ids, num_segments)[:, 0]
    out = segment_sum_launch(data, segment_ids, num_segments)
    cuda_lib.count(segment_sum, data.dtype)
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        if data.device.type == "cpu":
            return segment_sum_plain(data, segment_ids, num_segments)
        return _segment_sum_cuda(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        # g[ids], zero on dropped rows: JAX's _segment_sum_bwd
        ids = ctx.saved_tensors[0].long()
        keep = (ids >= 0) & (ids < ctx.num_segments)
        rows = g[ids.clamp(0, max(ctx.num_segments - 1, 0))]
        keep = keep.view((-1,) + (1,) * (g.dim() - 1))
        return torch.where(keep, rows, 0.0), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[e] over e with segment_ids[e] == s``.

    ``data`` is ``[E, F]`` (or ``[E]``) float32 or bf16 (sums in float32,
    the output in the data's type), ``segment_ids`` ``[E]`` int32 in any
    order; ids outside ``[0, num_segments)`` are dropped and get a zero
    gradient. A CPU tensor takes the plain version; any other goes to the
    kernel, which raises on what it does not take."""
    return _SegmentSum.apply(data, segment_ids, int(num_segments))


cuda_lib.counter(segment_sum)


# ---------------------------------------------------------------------------
# segment_softmax
# ---------------------------------------------------------------------------


def segment_softmax_plain(scores: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Plain PyTorch segment softmax, mirroring ``_segment_softmax_fwd_impl``
    (``bignn_tpu/ops/pallas/segment.py:307-331``), in float32 and rounded
    once to the scores' type. Differentiable by autograd (the max shift is
    detached), so it also serves a reference run's backward."""
    x = (scores[:, None] if scores.dim() == 1 else scores).float()
    keep, slot = _slots(segment_ids, num_segments)
    m = x.new_full((num_segments + 1, x.shape[1]), -torch.inf).scatter_reduce(
        0, slot[:, None].expand(x.shape), x.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, 0.0)
    z = torch.where(keep[:, None], torch.exp(x - m[slot]), 0.0)
    denom = x.new_zeros((num_segments + 1, x.shape[1])).index_add(0, slot, z)
    alpha = (z / denom[slot].clamp_min(DENOM_FLOOR)).to(scores.dtype)
    return alpha[:, 0] if scores.dim() == 1 else alpha


def segment_softmax_bwd_plain(alpha: torch.Tensor, g: torch.Tensor,
                              segment_ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """Plain analytic VJP, ``_segment_softmax_bwd``
    (``bignn_tpu/ops/pallas/segment.py:293-301``):
    ``alpha g - alpha segsum(alpha g)[ids]``, exactly 0 on dropped rows; in
    float32, rounded once to alpha's type."""
    keep, slot = _slots(segment_ids, num_segments)
    a = alpha.float()
    t = a * g.float()
    s = t.new_zeros((num_segments + 1,) + tuple(t.shape[1:]))
    s.index_add_(0, slot, t)
    keep = keep.view((-1,) + (1,) * (t.dim() - 1))
    return torch.where(keep, t - a * s[slot], 0.0).to(alpha.dtype)


def _softmax_check(name: str, x: torch.Tensor, segment_ids: torch.Tensor,
                   *more: tuple[str, torch.Tensor]) -> None:
    """Check what the softmax kernels take: ``[E, H]`` float32 or bf16
    (H <= 8; every tensor of one type) and ``[E]`` int32 ids, contiguous,
    on one card. Returns the entry points' suffix."""
    suffix = cuda_lib.require_float(x, name, "segment_softmax")
    dev = x.device
    cuda_lib.require_cuda(x, name, x.dtype, 2, dev)
    for n, t in more:
        cuda_lib.require_cuda(t, n, x.dtype, 2, dev)
        if t.shape != x.shape:
            raise ValueError(f"{n} {tuple(t.shape)} differs from {name} "
                             f"{tuple(x.shape)}")
    cuda_lib.require_cuda(segment_ids, "segment_ids", torch.int32, 1, dev)
    if segment_ids.shape[0] != x.shape[0]:
        raise ValueError(f"segment_ids has {segment_ids.shape[0]} rows, "
                         f"{name} {x.shape[0]}")
    if not 1 <= x.shape[1] <= MAX_HEADS:
        raise NotImplementedError(
            f"segment_softmax kernels take 1 to {MAX_HEADS} heads, got "
            f"{x.shape[1]}")
    return suffix


def _segment_softmax_fwd_cuda(scores, segment_ids, num_segments):
    suffix = _softmax_check("scores", scores, segment_ids)
    dev = scores.device
    e, heads = scores.shape
    alpha = torch.empty_like(scores)
    first = torch.empty(num_segments, dtype=torch.int32, device=dev)
    last = torch.empty(num_segments, dtype=torch.int32, device=dev)
    cuda_lib.launch(f"bignn_segment_softmax_fwd_{suffix}", dev,
                    scores.data_ptr(), segment_ids.data_ptr(), e, heads,
                    num_segments, first.data_ptr(), last.data_ptr(),
                    alpha.data_ptr())
    cuda_lib.count(segment_softmax, scores.dtype)
    return alpha


def segment_softmax_bwd(alpha: torch.Tensor, g: torch.Tensor,
                        segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """``d_scores`` for the cotangent ``g`` of ``alpha`` (both ``[E, H]``,
    or ``[E]``, float32 or bf16). A CPU tensor takes the plain version; any other goes
    to the kernel, which raises on what it does not take."""
    if alpha.device.type == "cpu":
        return segment_softmax_bwd_plain(alpha, g, segment_ids, num_segments)
    if alpha.dim() == 1:
        return segment_softmax_bwd(alpha[:, None], g[:, None], segment_ids,
                                   num_segments)[:, 0]
    suffix = _softmax_check("alpha", alpha, segment_ids, ("g", g))
    dev = alpha.device
    e, heads = alpha.shape
    d = torch.empty_like(alpha)
    first = torch.empty(num_segments, dtype=torch.int32, device=dev)
    last = torch.empty(num_segments, dtype=torch.int32, device=dev)
    cuda_lib.launch(f"bignn_segment_softmax_bwd_{suffix}", dev,
                    alpha.data_ptr(), g.data_ptr(), segment_ids.data_ptr(), e,
                    heads, num_segments, first.data_ptr(), last.data_ptr(),
                    d.data_ptr())
    cuda_lib.count(segment_softmax_bwd, alpha.dtype)
    return d


cuda_lib.counter(segment_softmax_bwd)


class _SegmentSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, segment_ids, num_segments):
        if scores.device.type == "cpu":
            alpha = segment_softmax_plain(scores, segment_ids, num_segments)
        elif scores.dim() == 1:
            alpha = _segment_softmax_fwd_cuda(scores[:, None], segment_ids,
                                              num_segments)[:, 0]
        else:
            alpha = _segment_softmax_fwd_cuda(scores, segment_ids,
                                              num_segments)
        ctx.save_for_backward(alpha, segment_ids)
        ctx.num_segments = num_segments
        return alpha

    @staticmethod
    def backward(ctx, g):
        alpha, segment_ids = ctx.saved_tensors
        d = segment_softmax_bwd(alpha, g.contiguous(), segment_ids,
                                ctx.num_segments)
        return d, None, None


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of ``scores`` (``[E, H]`` float32 or bf16, H <= 8 on the
    card, or ``[E]``) within each segment, in float32, ``alpha`` in the
    scores' type; rows with an id outside
    ``[0, num_segments)`` give exactly 0 and get a zero gradient.
    ``segment_ids`` is ``[E]`` int32, sorted for speed, right in any order.
    A CPU tensor takes the plain versions; any other goes to the kernels."""
    return _SegmentSoftmax.apply(scores, segment_ids, int(num_segments))


cuda_lib.counter(segment_softmax)
