"""Block-local SpMM (counterpart of
``bignn_tpu/ops/pallas/block_spmm.py:block_spmm``).

In the block-local layout every molecule lies inside one 128-row block, so
``y = A x`` reads, for block b, only block b's rows of x:
``y[d] = sum over the edges e of block b's range with dst_e = d and src_e in
the block of w_e x[src_e]`` (``w_e = 1`` unweighted). As the TPU kernel's
one-hot masks do, an edge whose source or destination lies outside its block
is dropped; padding edges (``dst == N``) lie outside every block.

``block_spmm`` is a ``torch.autograd.Function``: on CUDA tensors its forward
runs the kernel of ``csrc/block_spmm.cu`` and its backward
(``block_spmm_bwd``) the same kernel on the transposed (source-sorted) plan
``(tsrc, tdst, tweight, tstarts)``, as the JAX VJP does; on CPU tensors both
take the plain version. ``d_weight`` is a per-edge dot in plain PyTorch
(``edge_weight_grad``), as the JAX VJP leaves it to XLA, and comes back in
the weight's type. Both wrappers count their launches per element type, the
weighted forms under ``f32:weighted`` and ``bf16:weighted``, and rows wider
than ``TILE_COLS`` (the kernel's tiled form) with ``:tiled`` after that. The
kernel takes float32 or bf16 rows (float32 weights) of any width (above 256
in tiles of 256 columns) and raises on anything else. The unweighted bf16
form multiplies each block's edge counts by its rows on the tensor cores
(float32 sums); the float32 and
weighted forms sum the edges' rows one by one, and in bf16 round the
weight and each weighted message to bf16 before the float32 sum, as the
TPU kernel does (JAX ``ops/pallas/block_spmm.py:142-144``).

The models take this route for block-local buckets above
``BLOCK_DENSE_MAX_NODES`` rows, which carry no dense blocks (JAX
``sparse/formats.py:259``); below it ``block_diag_spmm`` multiplies the dense
blocks.
"""

from __future__ import annotations

import torch

from bignn_tpu_torch.ops import cuda_lib
from bignn_tpu_torch.ops.segment import segment_sum_plain
from bignn_tpu_torch.sparse.formats import BLOCK_ROWS

TILE_COLS = 256  # widest row of csrc/block_spmm.cu's untiled form


def _count(fn, x: torch.Tensor, weighted: bool) -> None:
    """One launch of ``fn``'s kernel on ``x``, ``:tiled`` where its rows
    take the tiled form."""
    cuda_lib.count(fn, x.dtype, weighted,
                   ":tiled" if x.shape[1] > TILE_COLS else "")


def edge_weight_grad(g: torch.Tensor, x: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor, block_local: bool = False
                     ) -> torch.Tensor:
    """The weights' gradient of an SpMM with output cotangent ``g``: per
    edge ``<g[dst_e], x[src_e]>``, 0 where ``dst_e`` is outside ``[0, rows
    of g)`` (JAX ``ops/pallas/spmm.py:95-96``, ``block_spmm.py:359-361``)
    and, with ``block_local``, where the edge leaves its 128-row block: the
    forward dropped it. (JAX's block-local VJP gives such an edge the dot;
    ROADMAP F3.) Plain PyTorch: two row gathers and a dot."""
    num_out = g.shape[0]
    ids = dst.long()
    keep = (ids >= 0) & (ids < num_out)
    if block_local:
        keep &= torch.div(src.long(), BLOCK_ROWS, rounding_mode="floor") == (
            torch.div(ids, BLOCK_ROWS, rounding_mode="floor"))
    if num_out == 0:
        return torch.zeros(ids.shape, dtype=g.dtype, device=g.device)
    g_e = g[ids.clamp(0, num_out - 1)]
    x_e = x[src.long().clamp(0, x.shape[0] - 1)]
    return torch.where(keep, (g_e * x_e).sum(-1), 0.0)


def block_spmm_plain(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     weight: torch.Tensor | None,
                     num_nodes: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: gather, weight, drop the out-of-block edges,
    ``index_add`` over dst (``segment_sum_plain``, float32). It needs no
    block plan: with a right plan the block ranges hold every edge of their
    block. Differentiable by autograd."""
    n = x.shape[0]
    num_nodes = n if num_nodes is None else num_nodes
    s, d = src.long(), dst.long()
    lo = torch.div(d, BLOCK_ROWS, rounding_mode="floor") * BLOCK_ROWS
    valid = (d >= 0) & (d < num_nodes) & (s >= lo) & (s < lo + BLOCK_ROWS)
    msgs = x[s.clamp(0, max(n - 1, 0))]
    if weight is not None:
        msgs = msgs * weight[:, None].to(msgs.dtype)
    # dropped edges go to the spare row of the segment sum
    return segment_sum_plain(msgs, torch.where(valid, d, num_nodes),
                             num_nodes)


def _launch(x, src, dst, weight, starts, num_nodes) -> torch.Tensor:
    """``csrc/block_spmm.cu`` on ``x [N, F]`` float32 or bf16 (N a multiple
    of 128 equal to ``num_nodes``). ``starts`` shorter than
    ``N/128 + 1`` is extended with its last value (JAX
    ``block_spmm.py:204-208``). Counts nothing: each caller counts its own
    launches."""
    suffix = cuda_lib.require_float(x, "x", "block_spmm")
    dev = x.device
    cuda_lib.require_cuda(x, "x", x.dtype, 2, dev)
    n, f = x.shape
    if n != num_nodes or n % BLOCK_ROWS:
        raise ValueError(f"block_spmm needs x padded to the 128-row grid: x "
                         f"has {n} rows, num_nodes {num_nodes}")
    nblk = n // BLOCK_ROWS
    e = src.shape[0]
    cuda_lib.require_cuda(src, "src", torch.int32, 1, dev)
    cuda_lib.require_cuda(dst, "dst", torch.int32, 1, dev)
    cuda_lib.require_cuda(starts, "starts", torch.int32, 1, dev)
    if dst.shape[0] != e or not 1 <= starts.shape[0]:
        raise ValueError(f"want src/dst [E] and starts [{nblk + 1}], got "
                         f"{e}, {dst.shape[0]}, {starts.shape[0]}")
    if starts.shape[0] < nblk + 1:
        starts = torch.cat([starts, starts[-1:].expand(
            nblk + 1 - starts.shape[0])])
    w_ptr = None
    if weight is not None:
        cuda_lib.require_cuda(weight, "weight", torch.float32, 1, dev)
        if weight.shape[0] != e:
            raise ValueError("weight must match the edge list")
        w_ptr = weight.data_ptr()
    out = torch.empty_like(x)
    cuda_lib.launch(f"bignn_block_spmm_{suffix}", dev, x.data_ptr(),
                    src.data_ptr(), dst.data_ptr(), w_ptr, starts.data_ptr(),
                    e, nblk, f, out.data_ptr())
    return out


def block_spmm_bwd(g: torch.Tensor, tsrc: torch.Tensor, tdst: torch.Tensor,
                   tweight: torch.Tensor | None, tstarts: torch.Tensor,
                   num_nodes: int) -> torch.Tensor:
    """``d_x`` of ``block_spmm`` for the output cotangent ``g``: the same
    SpMM over the transposed plan (``tdst`` source-sorted, ``tstarts`` its
    block ranges; ``tweight`` None when the forward was unweighted). A CPU
    tensor takes the plain version; any other goes to the kernel."""
    if g.device.type == "cpu":
        return block_spmm_plain(g, tsrc, tdst, tweight, num_nodes=num_nodes)
    d_x = _launch(g, tsrc, tdst, tweight, tstarts, num_nodes)
    _count(block_spmm_bwd, g, tweight is not None)
    return d_x


cuda_lib.counter(block_spmm_bwd)


class _BlockSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, src, dst, estarts, tsrc, tdst, tweight,
                tstarts, num_nodes):
        if x.device.type == "cpu":
            out = block_spmm_plain(x, src, dst, weight, num_nodes=num_nodes)
        else:
            out = _launch(x, src, dst, weight, estarts, num_nodes)
            _count(block_spmm, x, weight is not None)
        ctx.save_for_backward(x, weight, src, dst, tsrc, tdst, tweight,
                              tstarts)
        ctx.num_nodes = num_nodes
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, src, dst, tsrc, tdst, tweight, tstarts = ctx.saved_tensors
        g = g.contiguous()
        d_x = d_w = None
        if ctx.needs_input_grad[0]:
            d_x = block_spmm_bwd(g, tsrc, tdst,
                                 None if weight is None else tweight,
                                 tstarts, ctx.num_nodes)
        if weight is not None and ctx.needs_input_grad[1]:
            d_w = edge_weight_grad(g, x, src, dst,
                                   block_local=True).to(weight.dtype)
        return d_x, d_w, None, None, None, None, None, None, None, None


def block_spmm(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               weight: torch.Tensor | None, estarts: torch.Tensor,
               tsrc: torch.Tensor, tdst: torch.Tensor,
               tweight: torch.Tensor | None, tstarts: torch.Tensor,
               num_nodes: int) -> torch.Tensor:
    """Block-local ``y = A x`` for ``x [N, F]`` (N = ``num_nodes``, a
    multiple of 128): ``src``/``dst`` ``[E]`` int32 dst-sorted with block
    ranges ``estarts`` ``[N/128 + 1]``, ``weight`` ``[E]`` or None; the
    transposed plan ``(tsrc, tdst, tweight, tstarts)`` serves the backward
    (JAX ``block_spmm``). A CPU tensor takes the plain version; any other
    goes to the kernel. Differentiable in ``x`` and ``weight``."""
    return _BlockSpmm.apply(x, weight, src, dst, estarts, tsrc, tdst, tweight,
                            tstarts, int(num_nodes))


cuda_lib.counter(block_spmm)
