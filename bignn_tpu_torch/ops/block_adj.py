"""Block-diagonal adjacency and its SpMM (counterpart of
``bignn_tpu/ops/spmm.py:block_adjacency, block_diag_spmm`` and
``bignn_tpu/ops/pallas/block_adj.py:build_block_adj``).

In the block-local layout every molecule lies inside one 128-row block, so
the adjacency of a bucket is block-diagonal: ``[N/128, 128, 128]``.
``block_adjacency`` builds it from the dst-sorted edge list with the CUDA
kernel ``csrc/block_adj.cu`` (plain version on a CPU tensor), in float32,
bf16, or as int8/int16 counts; ``block_diag_spmm`` converts the blocks to
the activations' type and is then one batched matmul (float32 accumulation
on the card), which the JAX package also leaves to its compiler.
"""

from __future__ import annotations

import torch

from bignn_tpu_torch.ops import cuda_lib
from bignn_tpu_torch.sparse.formats import BLOCK_ROWS


OUT_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int16)


def _check_out(weight, out_dtype) -> None:
    if out_dtype not in OUT_DTYPES:
        raise NotImplementedError(
            f"block_adjacency writes float32, bfloat16, int8 or int16, got "
            f"{out_dtype}")
    if weight is not None and not out_dtype.is_floating_point:
        raise ValueError(f"a weighted build needs a float output, got "
                         f"{out_dtype} (int8/int16 hold counts)")


def block_adjacency_plain(src: torch.Tensor, dst: torch.Tensor,
                          weight: torch.Tensor | None, num_nodes: int,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain PyTorch build, mirroring ``build_block_adj_xla``
    (``bignn_tpu/ops/pallas/block_adj.py:266-279``): one ``index_add_`` of
    the edge weights (or ones) into the flattened blocks, in float32;
    padding and out-of-block edges add 0. The sum is cast to ``out_dtype``
    once; a bf16 build rounds each weight to bf16 first, as
    ``build_block_adj`` does (``block_adj.py:187-189``)."""
    _check_out(weight, out_dtype)
    nblk = num_nodes // BLOCK_ROWS
    src, dst = src.long(), dst.long()
    blk = dst // BLOCK_ROWS
    d_l = dst % BLOCK_ROWS
    s_l = src - blk * BLOCK_ROWS
    valid = (dst < num_nodes) & (s_l >= 0) & (s_l < BLOCK_ROWS)
    if weight is None:
        w = torch.ones_like(dst, dtype=torch.float32)
    elif out_dtype == torch.bfloat16:
        w = weight.to(torch.bfloat16).float()
    else:
        w = weight.float()
    w = torch.where(valid, w, 0.0)
    flat = (torch.where(valid, blk, 0) * BLOCK_ROWS * BLOCK_ROWS
            + d_l * BLOCK_ROWS + s_l.clamp(0, BLOCK_ROWS - 1))
    out = torch.zeros(nblk * BLOCK_ROWS * BLOCK_ROWS, dtype=torch.float32,
                      device=src.device)
    out.index_add_(0, flat, w)
    return out.view(nblk, BLOCK_ROWS, BLOCK_ROWS).to(out_dtype)


def block_adjacency(src: torch.Tensor, dst: torch.Tensor,
                    weight: torch.Tensor | None, estarts: torch.Tensor,
                    num_nodes: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[N/128, 128, 128]`` block-diagonal adjacency: the sum of
    ``weight`` over in-block edges s -> d, or the edge multiplicity when
    ``weight`` is None, in ``out_dtype`` (float32, bfloat16, int8 or int16,
    as ``bignn_tpu/ops/spmm.py:block_adjacency``). Counts are exact; int8
    and int16 hold counts only, and the caller keeps them in range
    (``MinibatchTrainer`` takes int8 while ``r_node**2 <= 127``).

    ``src``/``dst`` are ``[E]`` int32 global ids, dst-sorted and block-local;
    ``estarts`` ``[N/128 + 1]`` int32 gives each block's edge range. A CPU
    tensor takes the plain version; any other goes to the kernel."""
    if num_nodes % BLOCK_ROWS:
        raise ValueError(f"num_nodes {num_nodes} is not a multiple of 128")
    if src.device.type == "cpu":
        return block_adjacency_plain(src, dst, weight, num_nodes, out_dtype)
    _check_out(weight, out_dtype)
    dev = src.device
    nblk = num_nodes // BLOCK_ROWS
    cuda_lib.require_cuda(src, "src", torch.int32, 1, dev)
    cuda_lib.require_cuda(dst, "dst", torch.int32, 1, dev)
    cuda_lib.require_cuda(estarts, "estarts", torch.int32, 1, dev)
    e = src.shape[0]
    if dst.shape[0] != e or estarts.shape[0] != nblk + 1:
        raise ValueError(f"want src/dst [E] and estarts [{nblk + 1}], got "
                         f"{e}, {dst.shape[0]}, {estarts.shape[0]}")
    w_ptr = None
    if weight is not None:
        cuda_lib.require_cuda(weight, "weight", torch.float32, 1, dev)
        if weight.shape[0] != e:
            raise ValueError("weight must match the edge list")
        w_ptr = weight.data_ptr()
    out = torch.empty((nblk, BLOCK_ROWS, BLOCK_ROWS), dtype=out_dtype,
                      device=dev)
    cuda_lib.launch(f"bignn_block_adj_{cuda_lib.dtype_name(out_dtype)}", dev,
                    src.data_ptr(), dst.data_ptr(), w_ptr, estarts.data_ptr(),
                    e, nblk, out.data_ptr())
    cuda_lib.count(block_adjacency, out_dtype)
    return out


cuda_lib.counter(block_adjacency)


def block_diag_spmm(adj_blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``blockdiag(adj_blocks) @ x`` as one batched matmul; ``adj_blocks``
    is ``[nblk, 128, 128]`` (dst-local x src-local), ``x`` ``[nblk*128, F]``."""
    nblk = adj_blocks.shape[0]
    n, f = x.shape
    if n != nblk * BLOCK_ROWS:
        raise ValueError(f"x has {n} rows, blocks cover {nblk * BLOCK_ROWS}")
    y = torch.bmm(adj_blocks.to(x.dtype), x.view(nblk, BLOCK_ROWS, f))
    return y.view(n, f)
