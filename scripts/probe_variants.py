"""Time variants of a kernel's constants on one card, without editing the
source.

    python3 scripts/probe_variants.py KIND:V[:V ...] [KIND:V[:V ...] ...]

Each variant is the checkout's source with the KIND's constants set to the
values V, in this order:

- ``mhb``: the multi-head SpMM backward (``csrc/spmm_multihead.cu``,
  ``mh_backward``): ``kRowsInFlight``, ``kBwdMinBlocks``, ``kBwdWarps``;
- ``mhf``: its forward (``mh_forward``): ``kFwdRows``, ``kFwdMinBlocks``,
  ``kFwdWarps``;
- ``mhs``: the backward's strips (``mh_backward_strips``, rows of more
  than 8 heads or 256 columns): ``kStripRows`` (words a lane loads at
  once), ``kStripMinBlocks``, over config4's sampled outer graph at the
  wide BI-GNN's outer widths (``chip_smoke.WIDE_SHAPES``: H 4, D 256 and
  H 32, D 24), f32 and bf16;
- ``smf``: the segment-softmax forward (``csrc/segment_softmax.cu``,
  ``softmax_fwd``): ``kRows`` (rows a lane holds in registers),
  ``kFwdMinBlocks``, ``kWarpsPerBlock``;
- ``smb``: its backward (``softmax_bwd``, as the autograd Function calls
  it: the walk alone, on bounds found beforehand): ``kBwdRows`` (rows a
  lane holds where segments are not short), ``kBwdMinBlocks``,
  ``kBwdWarps`` (warps a block);
- ``adj``: the block adjacency (``csrc/block_adj.cu``): ``kThreads``, over
  config4's sampled batch 0 (int8 counts, bf16 weights; counts exact);
- ``fgb``: the flash-GAT backward's wide form (``csrc/flash_gat_bwd.cu``,
  ``flash_gat_bwd_wide``, head_dim above 64): ``kWideDvCols`` (features
  of dv a warp owns: the warps a block are 4 kDP / kWideDvCols),
  ``kWideMaxSplits`` (the most parts its destination sweep is cut into; 1
  cuts none, and keeps every dv partial off device memory),
  ``kWideMinBlocks`` (the blocks an SM must hold, by the launch bounds),
  over config2's dense outer mask (N 1,704) at H 4, D 256 and H 8, D 128,
  beside H 4, D 32 and H 8, D 64 (the narrow form, which these constants
  leave as it is; within ``chip_smoke.BWD_TOL``);
- ``fgf``: the flash-GAT forward's wide form (``csrc/flash_gat.cu``,
  ``flash_gat_fwd_wide<128|256>``, a block a strip of 128 or 256
  features): ``kWideRows`` (destination rows a block owns),
  ``kWideMTiles`` (m16 tiles a warp owns), ``kWideWarpCols`` (features a
  warp owns; with the two, the warps a block), ``kWideBuffers`` (stages in
  shared memory), ``kWideThreadsPerSm`` (threads an SM must hold, by the
  launch bounds), ``kWideInFlight`` (cnt loads a lane has in flight for
  the row max), over
  config2's dense outer mask (N 1,704) at H 4, D 256 and H 8, D 128, beside
  H 4, D 32 and H 8, D 64 (the narrow form; within
  ``chip_smoke.FLASH_TOL``);
- ``bsw``: the block-local SpMM's walk (``csrc/block_spmm.cu``,
  ``block_walk``): ``kWalkWarps``, ``kInFlightBf16``, ``kInFlightF32``
  (edges a lane reads at once), ``kMinBlocksBf16``, ``kMinBlocksF32`` (the
  CTAs an SM must hold, by the launch bounds), ``kEdgeStage`` (edges a
  block stages in shared memory), over
  the 301,312-row bucket of synthetic-large cut to 16,384 drugs, F 128:
  float32, float32 weighted, bf16 weighted (the weighted bf16 form value
  by value, ``chip_smoke.BF16_WEIGHTED``);
- ``bst``: the block-local SpMM's tiled tensor-core form (``csrc/
  block_spmm.cu``, ``block_spmm_tc`` above 256 columns): ``kTiledCols``
  (columns a staged tile holds), over the
  301,312-row bucket of synthetic-large cut to 16,384 drugs, bf16, F 300
  (W1's inner width): forward and backward (the transposed plan);
- ``smx``: the segment max (``csrc/segment_max.cu`` on the walk of
  ``csrc/segment_walk.cuh``, whose constants these are): ``kUnroll`` (the
  most rows a lane has in flight), ``kMaxWarps`` (the most warps that share
  a segment), over path C's largest bucket (the DrugBank stand-in's
  readout ids, 22,656 rows into 423 molecules), F 128, f32 and bf16: the
  forward, and the backward as autograd calls it (on bounds found
  beforehand); exact;
- ``spr``: the sorted-COO SpMM (``csrc/spmm.cu``, ``spmm_rows`` and
  ``spmm_long``): ``kInFlightWide``, ``kInFlightNarrow`` (rows a lane
  loads at once in the row pass where a row fills the warp, where it
  shares it), ``kInFlightLong`` (in the long-row pass), ``kRowWarps``,
  ``kLongMin``, ``kSharePerSlot``, ``kFillSlots`` (a row spanning more
  than the positions over this many slots is split), ``kDependentLaunch``
  (1: programmatic dependent launches), over path A's largest bucket (f32, F
  128, forward and backward), path E's batch (bf16, F 128 forward;
  weighted F 64 forward) and the split SpMMs of path G(ii)'s shard 0
  (f32, F 128: the owned-source one forward and backward, the halo-source
  backward);
- ``a2a``: row 9 with its semaphores on the cards (``csrc/all_to_all.cu``,
  the kSync form of ``exchange``, ``bignn_all_to_all_sync``): ``kUnroll``
  (words a thread loads before it stores any), ``kWaveBlocks`` (the most
  blocks of a launch; a large value leaves the grid uncapped), ``kCopy``
  (0: the semaphores alone, no copy), over the first four visible cards
  (two or more) at ``chip_smoke.M_SHAPES`` through
  ``ops.all_to_all_cards`` with this variant's entry point in place of the
  checkout's: exact against the plain version where it copies, then
  timed as ``chip_smoke.m_exchange`` times the exchange
  (``cards_queued_ms``, the first reading discarded).

Each is built alone with ``nvcc`` (the flags of ``ops/cuda_lib.py``; all
the builds started together) into ``build/probe/`` and bound by ctypes.
The inputs are those of ``scripts/compare_kernel_trees.py``
(``build/compare_inputs.pt``, built as that script builds it when it is
missing), H 4, D 32: the multi-head SpMM
over the 16,384-drug outer graph (f32), shard 0 of path H's plan (f32),
config4's sampled outer graph (bf16) and, forward only, the 100K-drug
outer graph (f32); the softmax over the dst of the 16,384-drug graph (f32;
the backward also bf16), config4's graph (bf16) and, forward only, the
100K-drug graph (f32, bf16). Each result is held against the plain version
as ``scripts/compare_kernel_trees.py`` holds it and timed as that script
times a form (``device_ms``: 100 calls queued behind a device sleep).
Prints the card, then one JSON line per variant with its registers and
its bytes of spill stores (``-Xptxas -v``).
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import compare_kernel_trees as ckt  # noqa: E402
from bignn_tpu_torch import ops  # noqa: E402
from bignn_tpu_torch.ops import cuda_lib  # noqa: E402
from bignn_tpu_torch.ops.segment import segment_bounds_plain  # noqa: E402


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _bounds(n: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in range(2))


def call_mhb(entries, t, v, src, dst, alpha, n_out, g, perm, ssorted):
    n, heads, head_dim = v.shape
    d_v, d_alpha = torch.empty_like(v), torch.zeros_like(alpha)
    first, last = _bounds(n, v.device)
    return entries[t](
        v.data_ptr(), g.data_ptr(), dst.data_ptr(), alpha.data_ptr(),
        perm.data_ptr(), ssorted.data_ptr(), src.shape[0], n, n_out, heads,
        head_dim, first.data_ptr(), last.data_ptr(), d_v.data_ptr(),
        d_alpha.data_ptr(), None, 0, _stream()), (d_v, d_alpha)


def call_mhf(entries, t, v, src, dst, alpha, n_out):
    n, heads, head_dim = v.shape
    out = torch.empty((n_out, heads, head_dim), dtype=v.dtype,
                      device=v.device)
    first, last = _bounds(n_out, v.device)
    return entries[t](
        v.data_ptr(), src.data_ptr(), dst.data_ptr(), alpha.data_ptr(),
        src.shape[0], n, n_out, heads, head_dim, first.data_ptr(),
        last.data_ptr(), out.data_ptr(), _stream()), (out,)


def call_smf(entries, t, x, ids, n_seg):
    alpha = torch.empty_like(x)
    first, last = _bounds(n_seg, x.device)
    return entries[t](
        x.data_ptr(), ids.data_ptr(), x.shape[0], x.shape[1], n_seg,
        first.data_ptr(), last.data_ptr(), alpha.data_ptr(),
        _stream()), (alpha,)


def call_smb(entries, t, alpha, g, ids, n_seg, first, last):
    d_x = torch.empty_like(alpha)
    return entries[t](
        alpha.data_ptr(), g.data_ptr(), ids.data_ptr(), alpha.shape[0],
        alpha.shape[1], n_seg, first.data_ptr(), last.data_ptr(),
        d_x.data_ptr(), _stream()), (d_x,)


def call_adj(entries, t, src, dst, weight, estarts, n, dtype):
    out = torch.empty((n // 128, 128, 128), dtype=dtype, device=src.device)
    return entries[t](src.data_ptr(), dst.data_ptr(),
                      None if weight is None else weight.data_ptr(),
                      estarts.data_ptr(), src.shape[0], n // 128,
                      out.data_ptr(), _stream()), (out,)


def call_fgb(entries, t, sl, sr, v, cnt, lse, out, g, slope):
    n, heads, head_dim = v.shape
    delta = (g * out).sum(-1)
    size = ctypes.c_int64()
    entries["scratch"](n, heads, head_dim, ctypes.addressof(size), _stream())
    scratch = torch.empty(size.value, device=v.device)
    dsl, dsr = torch.empty_like(sl), torch.empty_like(sl)
    dv = torch.empty_like(v)
    return entries[t](sl.data_ptr(), sr.data_ptr(), v.data_ptr(),
                      cnt.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      g.data_ptr(), n, heads, head_dim, slope, dsl.data_ptr(),
                      dsr.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                      size.value, _stream()), (dsl, dsr, dv)


def call_fgf(entries, t, sl, sr, v, cnt, slope):
    n, heads, head_dim = v.shape
    out, lse = torch.empty_like(v), torch.empty_like(sl)
    return entries[t](sl.data_ptr(), sr.data_ptr(), v.data_ptr(),
                      cnt.data_ptr(), n, heads, head_dim, slope,
                      out.data_ptr(), lse.data_ptr(), _stream()), (out, lse)


def call_bsw(entries, t, x, src, dst, weight, starts, n):
    out = torch.empty_like(x)
    return entries[t](x.data_ptr(), src.data_ptr(), dst.data_ptr(),
                      None if weight is None else weight.data_ptr(),
                      starts.data_ptr(), src.shape[0], n // 128, x.shape[1],
                      out.data_ptr(), _stream()), (out,)


def call_spr(entries, t, x, src, dst, weight, n_out, perm=None, srt=None):
    """The forward (no perm) or the backward of the sorted-COO SpMM: x is
    then the cotangent and n_out the rows of d_x."""
    size = ctypes.c_int64()
    entries["scratch"](src.shape[0], x.shape[1], ctypes.addressof(size),
                       _stream())
    first, last = _bounds(n_out, x.device)
    scratch = torch.empty(size.value, dtype=torch.uint8, device=x.device)
    out = torch.empty((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    w = None if weight is None else weight.data_ptr()
    if perm is None:
        rc = entries[t](x.data_ptr(), x.shape[0], src.data_ptr(),
                        dst.data_ptr(), w, src.shape[0], n_out, x.shape[1],
                        first.data_ptr(), last.data_ptr(), scratch.data_ptr(),
                        out.data_ptr(), _stream())
    else:
        rc = entries[t](x.data_ptr(), x.shape[0], dst.data_ptr(), w,
                        perm.data_ptr(), srt.data_ptr(), src.shape[0], n_out,
                        x.shape[1], first.data_ptr(), last.data_ptr(),
                        scratch.data_ptr(), out.data_ptr(), _stream())
    return rc, (out,)


def call_smx(entries, t, x, ids, n, out=None, g=None, first=None,
             last=None):
    """The segment max forward (no ``out``), or its backward on the bounds
    ``first``, ``last`` (saved)."""
    e, f = x.shape
    if out is None:
        res = torch.empty((n, f), dtype=x.dtype, device=x.device)
        first, last = _bounds(n, x.device)
        return entries[t](x.data_ptr(), ids.data_ptr(), e, f, n,
                          first.data_ptr(), last.data_ptr(), res.data_ptr(),
                          _stream()), (res,)
    d = torch.empty_like(x)
    return entries[t](x.data_ptr(), ids.data_ptr(), out.data_ptr(),
                      g.data_ptr(), e, f, n, first.data_ptr(),
                      last.data_ptr(), 1, d.data_ptr(), _stream()), (d,)


def _graphs(dev) -> dict:
    inp = torch.load(ckt.INPUTS)
    return {k: {n: t.to(dev) if torch.is_tensor(t) else t
                for n, t in inp[k].items()}
            for k in ("outer", "shard", "config4", "outer100k",
                      "config4_blocks", "pathE", "gin")}


def _scores(o, seed: int, dtype):
    gen = torch.Generator(device=o["dst"].device).manual_seed(seed)
    return (3 * torch.randn(len(o["dst"]), 4, device=o["dst"].device,
                            generator=gen)).to(dtype)


def mh_cases(graphs, backward: bool) -> list:
    """(tag, arguments, plain result) of the multi-head SpMM."""
    out = []
    for tag, key, n_src, n_out, dtype in (
            ("f32", "outer", "n", "n", torch.float32),
            ("f32:shard", "shard", "n_src", "n_out", torch.float32),
            ("bf16", "config4", "n", "n", torch.bfloat16),
            ("f32:100k", "outer100k", "n", "n", torch.float32)):
        o = graphs[key]
        if backward and "perm" not in o:
            continue
        alpha = ops.segment_softmax_plain(_scores(o, 0, torch.float32),
                                          o["dst"], o[n_out]).to(dtype)
        gen = torch.Generator(device=alpha.device).manual_seed(1)
        v = torch.randn(o[n_src], 4, 32, device=alpha.device,
                        generator=gen).to(dtype)
        args = (v, o["src"], o["dst"], alpha, o[n_out])
        if backward:
            g = torch.randn(o[n_out], 4, 32, device=alpha.device,
                            generator=gen).to(dtype)
            args = (*args, g, o["perm"], o["ssorted"])
            out.append((tag, args, ops.spmm_multihead_bwd_plain(*args)))
        else:
            out.append((tag, args, (ops.spmm_multihead_plain(*args),)))
    return out


def mhs_cases(graphs) -> list:
    """(tag, arguments, plain result) of the multi-head backward's strips
    at the wide shapes over config4's graph."""
    out = []
    o = graphs["config4"]
    for (wide, (heads, head_dim)), dtype in (
            (w, d) for w in ckt.smoke().WIDE_SHAPES.items()
            for d in (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=o["dst"].device).manual_seed(2)
        alpha = ops.segment_softmax_plain(3 * torch.randn(
            len(o["dst"]), heads, device=gen.device, generator=gen),
            o["dst"], o["n"]).to(dtype)
        v, g = (torch.randn(o["n"], heads, head_dim, device=gen.device,
                            generator=gen).to(dtype) for _ in range(2))
        args = (v, o["src"], o["dst"], alpha, o["n"], g, o["perm"],
                o["ssorted"])
        t = cuda_lib.dtype_name(dtype)
        out.append((f"{t}:{wide.lower()}", args,
                    ops.spmm_multihead_bwd_plain(*args)))
    return out


def bst_cases(graphs) -> list:
    """(tag, arguments, plain result) of the tiled bf16 block SpMM at F
    300, forward and backward, over the 301,312-row bucket."""
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse import bucket_graphs

    dev = graphs["config4"]["dst"].device
    b = ckt.largest(bucket_graphs(load_dataset(
        "synthetic-large", num_drugs=16384).molecules)).to(dev)
    n = b.node_cap
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(n, 300, device=dev, generator=gen).to(torch.bfloat16)
    out = []
    for tag, s, d, st in (("bf16:fwd", b.edge_src, b.edge_dst,
                           b.block_estarts),
                          ("bf16:bwd", b.edge_tsrc, b.edge_tdst,
                           b.block_tstarts)):
        out.append((tag, (x, s, d, None, st, n),
                    (ops.block_spmm_plain(x, s, d, None, num_nodes=n),)))
    return out


def softmax_cases(graphs, backward: bool) -> list:
    """(tag, arguments, plain result) of the segment softmax."""
    out = []
    for tag, key, dtype, directions in (
            ("f32", "outer", torch.float32, "fb"),
            ("bf16", "outer", torch.bfloat16, "b"),
            ("bf16:config4", "config4", torch.bfloat16, "fb"),
            ("f32:100k", "outer100k", torch.float32, "f"),
            ("bf16:100k", "outer100k", torch.bfloat16, "f")):
        if ("b" if backward else "f") not in directions:
            continue
        o = graphs[key]
        x = _scores(o, 2, dtype)
        if backward:
            alpha = ops.segment_softmax_plain(x, o["dst"], o["n"])
            g = _scores(o, 3, dtype) / 3
            args = (alpha, g, o["dst"], o["n"])
            bounds = segment_bounds_plain(o["dst"], o["n"])
            out.append((tag, (*args, *bounds),
                        (ops.segment_softmax_bwd_plain(*args),)))
        else:
            args = (x, o["dst"], o["n"])
            out.append((tag, args, (ops.segment_softmax_plain(*args),)))
    return out


def adj_cases(graphs) -> list:
    """(tag, arguments, plain result) of the block adjacency over config4's
    sampled batch 0: int8 counts (the step's form), bf16 weights."""
    b = graphs["config4_blocks"]
    out = []
    for tag, w, dtype in (("int8", None, torch.int8),
                          ("bf16", b["weight"], torch.bfloat16)):
        args = (b["src"], b["dst"], w, b["estarts"], b["n"], dtype)
        out.append((tag, args, (ops.block_adjacency_plain(
            *args[:3], b["n"], dtype),)))
    return out


FLASH_SHAPES = (("f32", 4, 32), ("f32:h8d64", 8, 64), ("f32:d256", 4, 256),
                ("f32:d128", 8, 128))


def fgb_cases(graphs) -> list:
    """(tag, arguments, plain result) of the flash-GAT backward over
    config2's dense outer mask (N 1,704) at ``FLASH_SHAPES``, lse and out
    from the plain forward on the card."""
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse.formats import build_outer_graph

    dev = graphs["outer"]["dst"].device
    ds = load_dataset("drugbank")
    train = ds.split_edges("train")
    cnt = torch.as_tensor(build_outer_graph(
        train[:, 0], train[:, 1], ds.num_drugs).dense_cnt)
    cnt = cnt.to(dev)
    gen = torch.Generator().manual_seed(4)
    out = []
    for tag, heads, head_dim in FLASH_SHAPES:
        n = ds.num_drugs
        sl, sr = (torch.randn(n, heads, generator=gen).to(dev)
                  for _ in range(2))
        v, g = (torch.randn(n, heads, head_dim, generator=gen).to(dev)
                for _ in range(2))
        o, lse = ops.flash_gat_attention_plain(sl, sr, v, cnt)
        args = (sl, sr, v, cnt, lse, o, g, 0.2)
        out.append((tag, args, ops.flash_gat_attention_bwd_plain(*args)))
    return out


def fgf_cases(graphs) -> list:
    """(tag, arguments, plain result) of the flash-GAT forward over
    config2's dense outer mask (N 1,704) at ``FLASH_SHAPES``."""
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse.formats import build_outer_graph

    dev = graphs["outer"]["dst"].device
    ds = load_dataset("drugbank")
    train = ds.split_edges("train")
    cnt = torch.as_tensor(build_outer_graph(
        train[:, 0], train[:, 1], ds.num_drugs).dense_cnt, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for tag, heads, head_dim in FLASH_SHAPES:
        n = ds.num_drugs
        sl, sr = (torch.randn(n, heads, device=dev, generator=gen)
                  for _ in range(2))
        v = torch.randn(n, heads, head_dim, device=dev, generator=gen)
        args = (sl, sr, v, cnt, 0.2)
        out.append((tag, args, ops.flash_gat_attention_plain(*args)))
    return out


def bsw_cases(graphs) -> list:
    """(tag, arguments, plain result) of the block-local walk over the
    301,312-row bucket of synthetic-large at 16,384 drugs, F 128."""
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse import bucket_graphs

    dev = graphs["outer"]["dst"].device
    b = ckt.largest(bucket_graphs(load_dataset(
        "synthetic-large", num_drugs=16384).molecules)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b.node_cap, 128, device=dev, generator=gen)
    out = []
    for tag, dtype, w in (("f32", torch.float32, None),
                          ("f32:weighted", torch.float32, b.edge_weight),
                          ("bf16:weighted", torch.bfloat16, b.edge_weight)):
        args = (x.to(dtype), b.edge_src, b.edge_dst, w, b.block_estarts,
                b.node_cap)
        out.append((tag, args, (ops.block_spmm_plain(
            *args[:4], num_nodes=b.node_cap),)))
    return out


def spr_cases(graphs) -> list:
    """(tag, arguments, plain result) of the sorted-COO SpMM: path A's
    largest bucket (f32, F 128), path E's batch (bf16 F 128, weighted F 64;
    forward), path G(ii)'s split SpMMs on shard 0 (f32, F 128)."""
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse import bucket_graphs

    dev = graphs["outer"]["dst"].device
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(n, f, dtype=torch.float32):
        return torch.randn(n, f, device=dev, generator=gen).to(dtype)

    out = []
    a = ckt.largest(bucket_graphs(load_dataset(
        "drugbank", max_atoms=160).molecules)).to(dev)
    n = a.node_cap
    x, g = randn(n, 128), randn(n, 128)
    out.append(("f32:A", (x, a.edge_src, a.edge_dst, None, n),
                (ops.spmm_sorted_coo_plain(x, a.edge_src, a.edge_dst, None,
                                           n),)))
    out.append(("bwd:A", (g, a.edge_src, a.edge_dst, None, n,
                          a.edge_src_perm, a.edge_src_sorted),
                (ops.spmm_sorted_coo_bwd_plain(g, a.edge_src, a.edge_dst,
                                               None, n),)))
    e = graphs["pathE"]
    n = e["node_cap"]
    for tag, f, w in (("bf16:E", 128, None), ("bf16:E:weighted", 64,
                                               e["edge_weight"])):
        x = randn(n, f, torch.bfloat16)
        args = (x, e["edge_src"], e["edge_dst"], w, n)
        out.append((tag, args, (ops.spmm_sorted_coo_plain(*args),)))
    gin = graphs["gin"]
    loc, halo = ckt.smoke().gin_split_layouts(
        gin["src"], gin["dst"], gin["perm"], gin["ssorted"], gin["b"],
        gin["n_halo"])
    b = gin["b"]
    x, g = randn(b, 128), randn(b, 128)
    s, d, w, _, p, st = loc
    out.append(("f32:hub", (x, s, d, w, b),
                (ops.spmm_sorted_coo_plain(x, s, d, w, b),)))
    for tag, (s, d, w, nx, p, st) in (("bwd:hub", loc),
                                       ("bwd:hub:halo", halo)):
        out.append((tag, (g, s, d, w, nx, p, st),
                    (ops.spmm_sorted_coo_bwd_plain(g, s, d, w, nx),)))
    return out


def smx_cases(graphs) -> list:
    """(tag, arguments, plain result) of the segment max at path C's
    largest bucket, F 128: the forward and the backward, f32 and bf16."""
    dev = graphs["outer"]["dst"].device
    ids, s = max(torch.load(ckt.INPUTS)["buckets"], key=lambda b: len(b[0]))
    ids = ids.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn(len(ids), 128, device=dev, generator=gen)
    g32 = torch.randn(s, 128, device=dev, generator=gen)
    bounds = segment_bounds_plain(ids, s)
    out = []
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, g = x32.to(dtype), g32.to(dtype)
        o = ops.segment_max_plain(x, ids, s)
        out.append((tag, (x, ids, s), (o,)))
        out.append(("bwd" if tag == "f32" else "bwd_bf16",
                    (x, ids, s, o, g, *bounds),
                    (ops.segment_max_bwd_plain(x, ids, o, g, s),)))
    return out


def a2a_row(values: tuple[int, ...], entry) -> dict:
    """Row 9 across the cards with the variant's ``bignn_all_to_all_sync``
    (``entry``) routed in place of the checkout's: ms a call at each of
    ``chip_smoke.M_SHAPES``, device time queued behind a sleep on every
    card."""
    from bignn_tpu_torch.ops import collectives
    from bignn_tpu_torch.parallel import spread_devices

    smoke = ckt.smoke()
    cards = smoke.visible_cards()[:4]
    if len(cards) < 2:
        raise SystemExit("a2a needs two or more cards")
    call = cuda_lib.call

    def routed(name, device, *args):
        if name != "bignn_all_to_all_sync":
            return call(name, device, *args)
        with torch.cuda.device(device):
            rc = entry(*args)
        if rc:
            raise RuntimeError(f"a2a {values}: CUDA error {rc}")

    row = {}
    cuda_lib.call = routed
    try:
        for name, g, s, f in smoke.M_SHAPES:
            devices = spread_devices(g, cards)
            used = list(dict.fromkeys(devices))
            gen = torch.Generator().manual_seed(smoke.SEED)
            host = [torch.randn(g, s, f, generator=gen) for _ in range(g)]
            bufs = [h.to(d) for h, d in zip(host, devices)]
            got = collectives.all_to_all_cards(bufs)
            collectives.check_cards(used)
            if values[2] and not all(
                    torch.equal(a.cpu(), b)
                    for a, b in zip(got, collectives.all_to_all_plain(host))):
                raise SystemExit(f"a2a {values} {name}: differs from the "
                                 f"plain version")

            def run():
                return collectives.all_to_all_cards(bufs)

            smoke.cards_queued_ms(run, used)  # the first reading, discarded
            row[name] = smoke.cards_queued_ms(run, used)
            collectives.check_cards(used)
    finally:
        cuda_lib.call = call
    return row


class Kind(NamedTuple):
    source: str
    constants: tuple[str, ...]
    kernel: str  # whose registers ptxas reports
    entry: str  # the C entry point, less its type
    call: object
    cases: object  # graphs -> [(tag, arguments, plain result)]
    types: tuple[str, ...] = ("f32", "bf16")  # entry points bound, by type
    tol: object = None  # tag -> (tolerance, per value), if not the default
    build: str = ""  # the source compiled, where not `source` (a header)


KINDS = {
    "mhb": Kind("spmm_multihead.cu",
                ("kRowsInFlight", "kBwdMinBlocks", "kBwdWarps"),
                "mh_backward", "bignn_spmm_multihead_bwd_", call_mhb,
                lambda gr: mh_cases(gr, True)),
    "mhs": Kind("spmm_multihead.cu",
                ("kStripRows", "kStripMinBlocks"),
                "mh_backward_strips", "bignn_spmm_multihead_bwd_", call_mhb,
                mhs_cases),
    "mhf": Kind("spmm_multihead.cu",
                ("kFwdRows", "kFwdMinBlocks", "kFwdWarps"), "mh_forward",
                "bignn_spmm_multihead_fwd_", call_mhf,
                lambda gr: mh_cases(gr, False)),
    "smf": Kind("segment_softmax.cu",
                ("kRows", "kFwdMinBlocks", "kWarpsPerBlock"), "softmax_fwd",
                "bignn_segment_softmax_fwd_", call_smf,
                lambda gr: softmax_cases(gr, False)),
    "smb": Kind("segment_softmax.cu",
                ("kBwdRows", "kBwdMinBlocks", "kBwdWarps"), "softmax_bwd",
                "bignn_segment_softmax_bwd_saved_", call_smb,
                lambda gr: softmax_cases(gr, True)),
    "adj": Kind("block_adj.cu", ("kThreads",), "block_counts",
                "bignn_block_adj_", call_adj, adj_cases, ("int8", "bf16"),
                lambda tag: (0.0 if tag == "int8" else ckt.BF16_TOL, False)),
    "fgb": Kind("flash_gat_bwd.cu",
                ("kWideDvCols", "kWideMaxSplits", "kWideMinBlocks"),
                "flash_gat_bwd_wide", "bignn_flash_gat_bwd_", call_fgb,
                fgb_cases, ("f32", "scratch_f32"),
                lambda tag: (ckt.smoke().BWD_TOL, False)),
    "fgf": Kind("flash_gat.cu",
                ("kWideRows", "kWideMTiles", "kWideWarpCols", "kWideBuffers",
                 "kWideThreadsPerSm", "kWideInFlight"),
                "flash_gat_fwd_wide", "bignn_flash_gat_fwd_", call_fgf,
                fgf_cases,
                ("f32",), lambda tag: (ckt.smoke().FLASH_TOL, False)),
    "bsw": Kind("block_spmm.cu",
                ("kWalkWarps", "kInFlightBf16", "kInFlightF32",
                 "kMinBlocksBf16", "kMinBlocksF32", "kEdgeStage"),
                "block_walk", "bignn_block_spmm_", call_bsw, bsw_cases,
                ("f32", "bf16"),
                lambda tag: (ckt.smoke().BF16_WEIGHTED if "bf16" in tag
                             else (ckt.F32_TOL, False))),
    "bst": Kind("block_spmm.cu", ("kTiledCols",),
                "block_spmm_tc", "bignn_block_spmm_", call_bsw, bst_cases,
                ("bf16",)),
    "smx": Kind("segment_walk.cuh", ("kUnroll", "kMaxWarps"),
                "(?:reduce_segments|max_bwd)", "bignn_segment_max_",
                call_smx, smx_cases, ("f32", "bf16", "bwd_f32", "bwd_bf16"),
                lambda tag: (0.0, False), "segment_max.cu"),
    "spr": Kind("spmm.cu",
                ("kInFlightWide", "kInFlightNarrow", "kInFlightLong",
                 "kRowWarps", "kLongMin", "kSharePerSlot", "kFillSlots",
                 "kDependentLaunch"),
                "spmm_rows", "bignn_spmm_", call_spr, spr_cases,
                ("f32", "bf16", "bwd_f32", "bwd_bf16", "scratch")),
    "a2a": Kind("all_to_all.cu", ("kUnroll", "kWaveBlocks", "kCopy"),
                "exchange", "bignn_all_to_all_sync", None, None, ()),
}


def start_variant(kind: str, values: tuple[int, ...]):
    """Write the variant's source and start its build; returns the build's
    process and the library it makes."""
    k = KINDS[kind]
    out = ROOT / "build" / "probe" / f"{kind}_{'_'.join(map(str, values))}"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(cuda_lib.CSRC, out / "csrc")
    src = out / "csrc" / k.source
    text = src.read_text()
    for name, value in zip(k.constants, values):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{name} not found once in {src}")
    src.write_text(text)
    lib = out / "libprobe.so"
    proc = subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(out / "csrc" / (k.build or k.source))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def bind_variant(kind: str, proc, lib):
    """The variant's entry points by type, and the kernel's registers, once
    its build is done."""
    k = KINDS[kind]
    report, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(report)
    cdll = ctypes.CDLL(str(lib))
    entries = {}
    if kind == "a2a":  # a host entry point: its own signature, no stream
        fn = getattr(cdll, k.entry)
        fn.argtypes = cuda_lib._HOST_SIGNATURES[k.entry]
        fn.restype = ctypes.c_int
        entries[kind] = fn
    for t in k.types:
        fn = getattr(cdll, k.entry + t)
        fn.argtypes = [*cuda_lib._SIGNATURES[k.entry + t], ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[t.removesuffix("_f32") if t != "f32" else t] = fn
    registers = sorted({int(r) for r in re.findall(
        rf"{k.kernel}.*?Used (\d+) registers", report, flags=re.S)})
    spills = sorted({int(r) for r in re.findall(
        rf"{k.kernel}.*?(\d+) bytes spill stores", report, flags=re.S)})
    return entries, registers, spills


def main() -> int:
    variants = []
    for a in sys.argv[1:]:
        kind, *values = a.split(":")
        if kind not in KINDS or len(values) != len(KINDS[kind].constants):
            raise SystemExit(__doc__)
        variants.append((kind, tuple(int(x) for x in values)))
    if not variants:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    builds = [start_variant(kind, values) for kind, values in variants]
    for (kind, values), build in zip(variants, builds):
        if kind == "a2a":
            entries, registers, spills = bind_variant(kind, *build)
            row = dict(zip(KINDS[kind].constants, values), kind=kind,
                       registers=registers, spill_stores=spills)
            row.update(a2a_row(values, entries[kind]))
            print(json.dumps(row), flush=True)
    rest = [(v, b) for v, b in zip(variants, builds) if v[0] != "a2a"]
    if not rest:
        return 0
    variants, builds = zip(*rest)
    if not ckt.INPUTS.exists():
        ckt.build_inputs(str(ROOT), ckt.INPUTS)
    sleep = ckt.sleep_ms()
    check = ckt.smoke()._check_close
    with torch.no_grad():
        graphs = _graphs(dev)
        cases = {kind: KINDS[kind].cases(graphs)
                 for kind in {kind for kind, _ in variants}}
        for (kind, values), build in zip(variants, builds):
            k = KINDS[kind]
            entries, registers, spills = bind_variant(kind, *build)
            row = dict(zip(k.constants, values), kind=kind,
                       registers=registers, spill_stores=spills)
            for tag, args, want in cases[kind]:
                def run(t=tag.split(":")[0], args=args):
                    rc, got = k.call(entries, t, *args)
                    if rc:
                        raise RuntimeError(f"{kind} {values} {tag}: CUDA "
                                           f"error {rc}")
                    return got

                per_element = kind.startswith("sm") and "bf16" in tag
                tol = (ckt.smoke().BF16_STEP if per_element
                       else ckt.BF16_TOL if "bf16" in tag else ckt.F32_TOL)
                share = None
                if k.tol is not None:
                    tol, per_element, *share = k.tol(tag)
                    share = share[0] if share else None
                try:
                    check(f"{kind} {values} {tag}", run(), want, tol,
                          per_element, share)
                except AssertionError as exc:  # the variant is wrong
                    row[tag] = f"fails: {exc}"
                    continue
                dms, host, slept = ckt.device_ms(run, sleep, ckt.DEVICE_REPS)
                row[tag] = dms if host < slept else None
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
