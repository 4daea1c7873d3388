"""Time the port's kernels from several checkouts on the same inputs, in
one run on one card, so that a change to a kernel source can be told apart
from the spread between runs.

    python3 scripts/compare_kernel_trees.py [--only PREFIX[,PREFIX ...]] ROOT [ROOT ...]
    python3 scripts/compare_kernel_trees.py --steps [--only KEY[,KEY ...]] ROOT [ROOT ...]

Each ROOT is a checkout of this repository. Each is timed in a process of
its own that imports ``bignn_tpu_torch`` from that ROOT (and so builds that
ROOT's kernels under ROOT/build), in the order given: give them as A B B A.
The forms, at the shapes ``chip_smoke.py`` gives them:

- ``segment_sum:f32``: the readout of config2's 4 buckets (the DrugBank
  stand-in, block-local ids with padding runs), F 128;
- ``segment_sum:bf16``: config4's sampled batch 0, ``[448,512, 128]`` rows
  into its drug budget;
- ``gather_rows_sorted_grad_bwd:f32``: the GAT scores' gather over the
  outer graph of synthetic-large cut to 16,384 drugs (E 2.6M, H 4), in the
  permuted form (``:perm``, the src gather) and the sorted-dst form
  (``:dst``); ``:bf16``: config4's sampled outer graph, permuted;
- ``all_to_all:f32``: config5's (G 4, S 432, F 132) and config5-large's
  (G 8, S 12,504, F 132) send buffers, random; ``all_to_all:f32:g64``:
  config5's at 64 graph shards of the DrugBank stand-in (G 64, its halo
  S, F 132; a tree whose kernel takes at most 32 shards raises, and the
  form is left out of that tree's line: ``unsupported``);
- ``spmm_multihead{,_bwd}:f32``: the 16,384-drug outer graph, H 4, D 32;
  ``spmm_multihead{,_bwd}:f32:shard``: shard 0 of path H's 8-shard plan
  over the 100K drugs (12,500 destinations, 112,532 extended rows, 2.0M
  edge slots); ``spmm_multihead{,_bwd}:bf16``: config4's sampled outer
  graph; ``spmm_multihead:{f32,bf16}:100k``: the 100K-drug outer graph
  (E 16.1M); ``spmm_multihead_bwd:{f32,bf16}:{w1,w2}``: the backward at
  the wide BI-GNN's outer widths (``chip_smoke.WIDE_SHAPES``: W1 H 4, D
  256; W2 H 32, D 24) over config4's sampled outer graph; each bound
  counts the rows the form gathers (``chip_smoke.gathered_rows``);
- ``segment_softmax{,_bwd}:{f32,bf16}``: scores over the dst of the
  16,384-drug outer graph (E 2.6M, H 4); ``:config4``: over config4's
  sampled outer graph; ``segment_softmax:{f32,bf16}:100k``: over the
  100K-drug outer graph; ``segment_softmax_bwd:...:autograd``: the
  backward as the main path runs it, ``torch.autograd.grad`` through the
  forward's kernel (``chip_smoke.softmax_bwd_autograd``);
- row 2: ``block_adjacency:f32{,:weighted}`` over config2's 4 buckets
  (counts, and the edges' weights); ``block_adjacency:int8`` (config4's
  step), ``:int16`` and ``:bf16:weighted`` over config4's sampled batch 0
  (3,504 blocks);
- rows 3 and 3b: ``flash_gat_attention{,_bwd}:f32`` over config2's dense
  outer mask (N 1,704), H 4, D 32, the backward's ``lse`` and ``out`` from
  the plain forward on the CPU; ``flash_gat_attention{,_bwd}:f32:d256`` the
  same mask at W1's outer heads (H 4, D 256; ``chip_smoke.WIDE_SHAPES``),
  its inputs drawn as path O(i) draws them, and ``:d128`` at H 8, D 128
  (the wide forms, head_dim above 64);
- rows 5-7: ``segment_max:{f32,bf16}`` on the largest bucket of the
  DrugBank stand-in, F 128, and its backward as the main path runs it,
  ``segment_max_bwd:{f32,bf16}:autograd``: ``torch.autograd.grad`` through
  ``ops.segment_max`` (``chip_smoke.max_bwd_autograd``), which exists in
  every tree, so a tree from before the backward's kernel is timed on its
  composed route; ``spmm_sorted_coo{,_bwd}:f32{,:weighted}`` on
  the largest bucket of the stand-in with molecules up to 160 atoms, F 128
  unweighted, F 64 weighted; ``spmm_sorted_coo{,_bwd}:bf16{,:weighted}``
  the same at path E's batch 0 (config4 host-sampled, 4.1M edge slots);
  ``spmm_sorted_coo{,_bwd}:f32:hub``: the two SpMMs of ``dist_gin_apply``
  on shard 0 of path G's plan (config5, 4 shards), F 128, whose source
  orders each hold a hub row (``chip_smoke.gin_split_layouts``);
  ``block_spmm{,_bwd}:{f32,bf16}{,:weighted}`` on the largest bucket of
  synthetic-large cut to 16,384 drugs (301,312 rows), F 128;
  ``block_spmm{,_bwd}:bf16:f300`` the same bucket at F 300 (W1's inner
  width: the tiled forms).

The index arrays are built once, in a process of their own with the first
ROOT's package (config4's batch needs its sampler on the card), and saved
under ``build/``; every ROOT loads them, and draws its values from seeded
device generators, so all ROOTs see the same inputs.

Each form, and its PyTorch yardstick where ``chip_smoke.py`` names one
(``index_add_``, ``index_put_(..., accumulate=True)``, ``copy_``, an
amax ``scatter_reduce_``, ``torch.sparse.mm`` on a CSR matrix, the multi-head backward's
``torch.sparse.mm`` and ``sampled_addmm``, ``torch.sparse.softmax`` and its
backward on a COO tensor, ``torch.bmm`` over dense blocks; built outside the
timing, from this checkout's ``chip_smoke.py``), is timed by CUDA events in
two ways: ``ms``, the mean of 10 calls after 3 warm-ups, as
``chip_smoke.py`` times it (the host's cost of a call can set this rate);
``device_ms``, the mean of 100 calls (25 of config2's 4 buckets, so that
their launches fit the launch queue) queued behind a device sleep, so that
the card runs them back to back and the host does not set the rate.
``host_ms`` is the host's time to queue them, which must stay below the
sleep (lengthened to twice a probe of that time), or ``device_ms`` is null.
``lib_ms`` and ``lib_device_ms`` are the same for the yardstick. Each result
is checked against the plain version (f32 within 1e-4, bf16 within 1e-2, of
max(1, max |plain|); the bf16 softmax forms and the weighted bf16 SpMMs
value by value, as ``chip_smoke.py`` holds them; the exchange and the
block counts bit for bit, the float32 block weights within 1e-6, as
``chip_smoke.py`` holds them); a form that fails gets ``fails`` (the
message, with both measures) and no times, and the ROOT's process exits 1
after its line. The softmax forms and rows 6-7 also get ``kernels``: the
device ms a call of each kernel they launch (the bounds pass, the walks),
from ``torch.profiler``, and so do the flash-GAT forward and backward (the
backward's tiles and reduction). ``--only`` times just the forms whose names start
with one of the prefixes. Prints one JSON line per ROOT; needs a CUDA card. ``bound_ms`` and ``bound_by`` (rows 2-8):
``chip_smoke.bound_ms`` of the bytes the form must read and write and of the
operations it must do, counted as ``chip_smoke.py`` counts them (rows 3 and
3b are bound by operations). ``digest``: a hash of the kernel's output bits;
after the last ROOT a line ``same_bits`` lists, per form, whether every ROOT
gave the same bits.

``--steps`` times instead training steps in each ROOT: path C's (config2
with ``readout="max"`` on the DrugBank stand-in, as ``chip_smoke.py`` runs
it) in float32 and in bf16 (keys ``float32``, ``bfloat16``), and path
O(ii)'s, config2 with the wide BI-GNN W1 (``chip_smoke.wide_config``, GAT
4 x 256 outside, float32; key ``w1``): the median host-clock step up to a
synchronize over 20 steps after 5 of warm-up, and a ``torch.profiler``
trace of 5 steps (device busy ms a step, the union of the device's
intervals; device launches a step; the device ms a step of the segment
max's kernels and of the flash-GAT pair's). ``--only`` keeps the keys that
start with one of its prefixes. One JSON line per ROOT.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import itertools
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

SEED = 0
REPS, WARMUP = 10, 3
DEVICE_REPS = 100  # launches of a form's calls stay below the queue's ~1,000
# calls a form makes: its reps are divided
CALLS = {"segment_sum:f32": 4, "block_adjacency:f32": 4,
         "block_adjacency:f32:weighted": 4, "spmm_sorted_coo:f32:hub": 2,
         "spmm_sorted_coo_bwd:f32:hub": 2,
         # the composed route of a tree from before the backward's kernel
         # makes ~16 launches a call
         "segment_max_bwd:f32:autograd": 4,
         "segment_max_bwd:bf16:autograd": 4}
SLEEP_CYCLES = 400_000_000  # ~0.2 s at the H100's 1.98 GHz boost clock
# forms whose kernels are timed one by one
TRACED = ("segment_softmax", "flash_gat_attention", "spmm_sorted_coo",
          "block_spmm", "segment_max")


def events_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Mean milliseconds per call by CUDA events, as chip_smoke.py's
    ``cuda_ms``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sleep_ms() -> float:
    """Device milliseconds of one ``torch.cuda._sleep(SLEEP_CYCLES)``."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, sleep: float, reps: int) -> tuple[float, float, float]:
    """Mean device milliseconds per call with the calls queued behind a
    device sleep, the host's milliseconds to queue them all, and the
    sleep's milliseconds. ``sleep`` is the device time of
    ``_sleep(SLEEP_CYCLES)``; the sleep is lengthened to twice the host's
    time to queue ``reps`` calls, as a probe of 10 calls measures it."""
    import torch

    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    probe = (time.perf_counter() - t0) * 1e3 * reps / 10
    torch.cuda.synchronize()
    scale = max(1.0, 2 * probe / sleep)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_CYCLES * scale))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end) / reps, host, sleep * scale


INPUTS = Path(__file__).resolve().parents[1] / "build" / "compare_inputs.pt"
F32_TOL, BF16_TOL = 1e-4, 1e-2  # x max(1, max |plain|)
# bytes a form must read and operations it must do (as chip_smoke.py counts
# them), where its bound is reported: the bound adds the bytes of its
# outputs, and is chip_smoke.bound_ms of the two
IN_BYTES: dict[str, int] = {}
# bytes of rows a form gathers by id (row 8), for chip_smoke.bound_ms
GATHERED: dict[str, int] = {}
# forms a tree from before this one's kernel refused (a ValueError of the
# wrapper): left out of that tree's line
NEWER = ("all_to_all:f32:g64",)
# operations in float32, or (float32, TF32 on the tensor cores)
FLOPS: dict[str, int | tuple[int, int]] = {}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def largest(bucketing):
    return max(bucketing.batches, key=lambda b: b.node_cap)


def build_inputs(root: str, path: Path) -> None:
    """Save the index arrays of the new forms' inputs to ``path``: config2's
    bucket ids, the 16,384-drug and the 100K-drug outer graphs, shard 0 of
    path H's 8-shard plan over the 100K drugs, and config4's sampled batch 0
    (its rows' drug ids and its outer graph), built as ``chip_smoke.py``
    builds them."""
    sys.path.insert(0, root)
    import torch

    import numpy as np

    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.parallel import build_outer_partition
    from bignn_tpu_torch.sparse import bucket_graphs
    from bignn_tpu_torch.sparse.formats import build_outer_graph

    dev = torch.device("cuda")
    out = {"buckets": [(torch.as_tensor(b.graph_ids), b.num_graphs)
                       for b in bucket_graphs(
                           load_dataset("drugbank").molecules).batches]}
    chip_smoke = smoke()
    cfg, _ = chip_smoke.sparse_config()
    outer = prepare_device_data(load_dataset(
        cfg.dataset, num_drugs=cfg.max_drugs)).outer
    out["outer"] = dict(n=outer.num_nodes,
                        **{k: torch.as_tensor(getattr(outer, f)) for k, f in (
                            ("src", "edge_src"), ("dst", "edge_dst"),
                            ("perm", "edge_src_perm"),
                            ("ssorted", "edge_src_sorted"))})
    large = chip_smoke.load_large()
    train = large.split_edges("train")
    o100 = build_outer_graph(train[:, 0], train[:, 1],
                             num_nodes=large.num_drugs)
    out["outer100k"] = dict(n=o100.num_nodes,
                            src=torch.as_tensor(o100.edge_src),
                            dst=torch.as_tensor(o100.edge_dst))
    plan = build_outer_partition(train[:, 0], train[:, 1], large.num_drugs,
                                 8)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32))

    out["shard"] = dict(n_src=plan.ext_size, n_out=plan.node_block,
                        src=i32(plan.edge_src[0]), dst=i32(plan.edge_dst[0]),
                        perm=i32(plan.src_perm[0]),
                        ssorted=i32(plan.src_sorted[0]))
    tr = chip_smoke.config4_trainer(dev, large)
    d = tr.dsampler
    tr.init(SEED)
    cb, _ = d.sample(tr._dev_consts, d.key_at(0, 0))
    pb = tr._expand_compact(cb, tr.tables)
    o4 = tr._derive_outer(cb)
    out["config4"] = dict(n=d.D, ids=pb.graph_ids.cpu(),
                          src=o4.edge_src.cpu(), dst=o4.edge_dst.cpu(),
                          perm=o4.edge_src_perm.cpu(),
                          ssorted=o4.edge_src_sorted.cpu())
    out["config4_blocks"] = dict(n=pb.node_cap, src=pb.edge_src.cpu(),
                                 dst=pb.edge_dst.cpu(),
                                 estarts=pb.block_estarts.cpu(),
                                 weight=pb.edge_weight.cpu())
    del tr, pb
    # path E's batch 0 (config4 host-sampled, molecules up to 160 atoms)
    tr = chip_smoke.config4_host_trainer(dev)
    with torch.no_grad():
        pb = tr._expand_compact(tr.sampler.sample_compact_at(0, 0).to(dev),
                                tr.tables)
    out["pathE"] = dict(node_cap=pb.node_cap, **{
        k: getattr(pb, k).cpu() for k in (
            "edge_src", "edge_dst", "edge_weight", "edge_src_perm",
            "edge_src_sorted", "node_mask")})
    del tr, pb
    # shard 0 of path G's plan (config5: the DrugBank stand-in, 4 shards)
    ds = load_dataset("drugbank")
    train = ds.split_edges("train")
    plan = build_outer_partition(train[:, 0], train[:, 1], ds.num_drugs,
                                 get_config("config5").graph_shards)
    out["g64"] = dict(s=build_outer_partition(
        train[:, 0], train[:, 1], ds.num_drugs, 64).halo_size)
    out["gin"] = dict(b=plan.node_block,
                      n_halo=plan.n_shards * plan.halo_size,
                      src=i32(plan.edge_src[0]), dst=i32(plan.edge_dst[0]),
                      perm=i32(plan.src_perm[0]),
                      ssorted=i32(plan.src_sorted[0]))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)


@functools.cache
def smoke():
    """This checkout's chip_smoke.py, whatever ROOT is timed: its
    yardsticks and its check."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def new_cases(dev, path: Path):
    """(name, kernel call, plain call, library call or None, tolerance) for
    the segment sum, the gather backward, the exchange, the multi-head
    SpMM and the softmax; a tolerance ``(tol, True)`` holds each value."""
    import torch

    from bignn_tpu_torch import ops
    from bignn_tpu_torch.ops import cuda_lib

    index_add_call, multihead_library, softmax_library = (
        smoke().index_add_call, smoke().multihead_library,
        smoke().softmax_library)

    inp = torch.load(path)
    out = []

    def randn(seed, *shape, dtype=torch.float32):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    seg = [(randn(i, len(ids), 128), ids.to(dev), s)
           for i, (ids, s) in enumerate(inp["buckets"])]
    libs = [index_add_call(x, ids, s) for x, ids, s in seg]
    out.append(("segment_sum:f32",
                lambda: [ops.segment_sum(*c) for c in seg],
                lambda: [ops.segment_sum_plain(*c) for c in seg],
                lambda: [f() for f in libs], F32_TOL))

    c4 = inp["config4"]
    ids4 = c4["ids"].to(dev)
    x4 = randn(10, len(ids4), 128, dtype=torch.bfloat16)
    out.append(("segment_sum:bf16",
                lambda: ops.segment_sum(x4, ids4, c4["n"]),
                lambda: ops.segment_sum_plain(x4, ids4, c4["n"]),
                index_add_call(x4, ids4, c4["n"]), BF16_TOL))

    o = {k: v.to(dev) if torch.is_tensor(v) else v
         for k, v in inp["outer"].items()}
    n, e = o["n"], len(o["src"])
    g_e = randn(20, e, 4)
    perm = (g_e, o["src"], n, o["perm"], o["ssorted"])
    # the library call sums g_e by the gather's own (unsorted) indices
    out.append(("gather_rows_sorted_grad_bwd:f32:perm",
                lambda: ops.gather_rows_sorted_grad_bwd(*perm),
                lambda: ops.gather_rows_sorted_grad_bwd_plain(*perm),
                index_add_call(g_e, o["src"], n), F32_TOL))
    out.append(("gather_rows_sorted_grad_bwd:f32:dst",
                lambda: ops.gather_rows_sorted_grad_bwd(g_e, o["dst"], n),
                lambda: ops.gather_rows_sorted_grad_bwd_plain(g_e, o["dst"],
                                                              n),
                index_add_call(g_e, o["dst"], n), F32_TOL))
    o4 = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in c4.items()}
    g4 = randn(21, len(o4["src"]), 4, dtype=torch.bfloat16)
    perm4 = (g4, o4["src"], o4["n"], o4["perm"], o4["ssorted"])
    # padding edges (dst D) carry src 0 but sort as id D
    lib4 = torch.where(o4["dst"] < o4["n"], o4["src"], o4["n"])
    out.append(("gather_rows_sorted_grad_bwd:bf16",
                lambda: ops.gather_rows_sorted_grad_bwd(*perm4),
                lambda: ops.gather_rows_sorted_grad_bwd_plain(*perm4),
                index_add_call(g4, lib4, o4["n"]), BF16_TOL))

    for tag, g, sz in (("config5", 4, 432), ("config5-large", 8, 12_504),
                       ("g64", 64, inp["g64"]["s"])):
        bufs = [randn(30 + i, g, sz, 132) for i in range(g)]
        stacked = torch.stack(bufs)
        dst = torch.empty_like(stacked)
        out.append((f"all_to_all:f32:{tag}",
                    lambda bufs=bufs: ops.all_to_all(bufs),
                    lambda bufs=bufs: ops.all_to_all_plain(bufs),
                    lambda s=stacked, d=dst: d.copy_(s.transpose(0, 1)),
                    0.0))

    def cpu_softmax(x, ids, n_seg):
        """The plain softmax on the CPU, whose sums have a fixed order (on
        the card ``index_add`` takes float atomics), so that every ROOT
        gets the same bits."""
        return ops.segment_softmax_plain(x.cpu(), ids.cpu(), n_seg).to(dev)

    def multihead(tag, seed, o, n_src, n_out, dtype, tol):
        """The multi-head SpMM (H 4, D 32) over the edges of ``o``: alpha a
        softmax over dst of random scores; the library calls of
        ``chip_smoke.multihead_library``."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        alpha = cpu_softmax(3 * torch.randn(
            len(o["dst"]), 4, device=dev, generator=gen), o["dst"],
            n_out).to(dtype)
        v = randn(seed + 1, n_src, 4, 32, dtype=dtype)
        g = randn(seed + 2, n_out, 4, 32, dtype=dtype)
        fwd = (v, o["src"], o["dst"], alpha, n_out)
        IN_BYTES[f"spmm_multihead:{tag}"] = nbytes(v, o["src"], o["dst"],
                                                   alpha)
        IN_BYTES[f"spmm_multihead_bwd:{tag}"] = nbytes(
            v, o["dst"], alpha, g, *(o[k] for k in ("perm", "ssorted")
                                     if k in o))
        for name in ("spmm_multihead", "spmm_multihead_bwd"):
            GATHERED[f"{name}:{tag}"] = smoke().gathered_rows(
                o["dst"], n_out, 128, dtype)
        out.append((f"spmm_multihead:{tag}",
                    lambda: ops.spmm_multihead(*fwd),
                    lambda: ops.spmm_multihead_plain(*fwd),
                    multihead_library(o["src"], o["dst"], alpha, n_out, v),
                    tol))
        if "perm" in o:
            bwd = (*fwd, g, o["perm"], o["ssorted"])
            out.append((f"spmm_multihead_bwd:{tag}",
                        lambda: ops.spmm_multihead_bwd(*bwd),
                        lambda: ops.spmm_multihead_bwd_plain(*bwd),
                        multihead_library(o["src"], o["dst"], alpha, n_out,
                                          v, g), tol))

    multihead("f32", 40, o, n, n, torch.float32, F32_TOL)
    sh = {k: v.to(dev) if torch.is_tensor(v) else v
          for k, v in inp["shard"].items()}
    multihead("f32:shard", 50, sh, sh["n_src"], sh["n_out"], torch.float32,
              F32_TOL)
    multihead("bf16", 60, o4, o4["n"], o4["n"], torch.bfloat16, BF16_TOL)
    big = {k: v.to(dev) if torch.is_tensor(v) else v
           for k, v in inp["outer100k"].items()}
    multihead("f32:100k", 70, big, big["n"], big["n"], torch.float32,
              F32_TOL)
    multihead("bf16:100k", 75, big, big["n"], big["n"], torch.bfloat16,
              BF16_TOL)

    # the backward at the wide BI-GNN's outer widths, config4's graph
    for (tag, (heads, head_dim)), (t, dtype, tol) in itertools.product(
            smoke().WIDE_SHAPES.items(),
            (("f32", torch.float32, F32_TOL),
             ("bf16", torch.bfloat16, BF16_TOL))):
        gen = torch.Generator(device=dev).manual_seed(90)
        alpha = cpu_softmax(3 * torch.randn(
            len(o4["dst"]), heads, device=dev, generator=gen), o4["dst"],
            o4["n"]).to(dtype)
        v = randn(91, o4["n"], heads, head_dim, dtype=dtype)
        g = randn(92, o4["n"], heads, head_dim, dtype=dtype)
        bwd = (v, o4["src"], o4["dst"], alpha, o4["n"], g, o4["perm"],
               o4["ssorted"])
        name = f"spmm_multihead_bwd:{t}:{tag.lower()}"
        IN_BYTES[name] = nbytes(v, o4["dst"], alpha, g, o4["perm"],
                                o4["ssorted"])
        GATHERED[name] = smoke().gathered_rows(o4["dst"], o4["n"],
                                               heads * head_dim, dtype)
        out.append((name, lambda bwd=bwd: ops.spmm_multihead_bwd(*bwd),
                    lambda bwd=bwd: ops.spmm_multihead_bwd_plain(*bwd),
                    multihead_library(o4["src"], o4["dst"], alpha, o4["n"],
                                      v, g), tol))

    def softmax(tag, seed, ids, n_seg, backward=True):
        """The segment softmax of random scores ``[E, 4]`` over ``ids``;
        its backward on the plain forward's alpha and a random cotangent;
        the library calls of ``chip_smoke.softmax_library``."""
        dtype, tol = ((torch.bfloat16, (smoke().BF16_STEP, True))
                      if "bf16" in tag else (torch.float32, F32_TOL))
        x = 3 * randn(seed, len(ids), 4, dtype=dtype)
        IN_BYTES[f"segment_softmax:{tag}"] = nbytes(x, ids)
        out.append((f"segment_softmax:{tag}",
                    lambda: ops.segment_softmax(x, ids, n_seg),
                    lambda: ops.segment_softmax_plain(x, ids, n_seg),
                    softmax_library(x, ids, n_seg), tol))
        if backward:
            alpha = cpu_softmax(x, ids, n_seg)
            g = randn(seed + 1, len(ids), 4, dtype=dtype)
            IN_BYTES[f"segment_softmax_bwd:{tag}"] = nbytes(alpha, g, ids)
            library = softmax_library(alpha, ids, n_seg, g)
            out.append((f"segment_softmax_bwd:{tag}",
                        lambda: ops.segment_softmax_bwd(alpha, g, ids, n_seg),
                        lambda: ops.segment_softmax_bwd_plain(alpha, g, ids,
                                                              n_seg),
                        library, tol))
            # the main path's form: through autograd, on the forward
            # kernel's alpha and bounds
            name = f"segment_softmax_bwd:{tag}:autograd"
            kernel, a = smoke().softmax_bwd_autograd(x, g, ids, n_seg)
            IN_BYTES[name] = nbytes(a, g, ids) + 8 * n_seg
            out.append((name, kernel,
                        lambda: ops.segment_softmax_bwd_plain(a, g, ids,
                                                              n_seg),
                        library, tol))

    for t in ("f32", "bf16"):
        softmax(t, 80, o["dst"], n)
        softmax(f"{t}:config4", 82, o4["dst"], o4["n"])
        softmax(f"{t}:100k", 84, big["dst"], big["n"], backward=False)

    # row 7 in bf16 at path E's batch, and at path G(ii)'s GIN split
    pe = types.SimpleNamespace(**{k: v.to(dev) if torch.is_tensor(v) else v
                                  for k, v in inp["pathE"].items()})
    gin = {k: v.to(dev) if torch.is_tensor(v) else v
           for k, v in inp["gin"].items()}
    for name, kernel, plain, library, tol, nb, _ in (
            smoke().spmm_forms(pe, torch.bfloat16)
            + smoke().gin_split_forms(gin["src"], gin["dst"], gin["perm"],
                                      gin["ssorted"], gin["b"],
                                      gin["n_halo"])):
        IN_BYTES[name] = nb
        out.append((name, kernel, plain, library, tol))

    # row 2 at config4's sampled batch 0: int8 counts (the step's form),
    # int16 counts and bf16 weights (off the path), at the same edges
    blk = {k: v.to(dev) if torch.is_tensor(v) else v
           for k, v in inp["config4_blocks"].items()}
    for dt, w, tol in ((torch.int8, None, 0.0), (torch.int16, None, 0.0),
                       (torch.bfloat16, blk["weight"], BF16_TOL)):
        adj = (blk["src"], blk["dst"], w, blk["estarts"], blk["n"], dt)
        name = (f"block_adjacency:{cuda_lib.dtype_name(dt)}"
                + ("" if w is None else ":weighted"))
        IN_BYTES[name] = nbytes(*(t for t in adj[:4] if t is not None))
        out.append((name, lambda adj=adj: ops.block_adjacency(*adj),
                    lambda adj=adj: ops.block_adjacency_plain(
                        *adj[:3], adj[4], adj[5]),
                    smoke().index_put_call(blk["src"], blk["dst"], blk["n"],
                                           dt, w), tol))
    return out


def cases(dev):
    """(name, kernel call, plain call, library call, tolerance) for rows 2,
    3 and 3b at config2's shapes (no library call for 3 and 3b), and rows
    5-7: the segment max (no library call), the sorted-COO SpMM in float32,
    and the block-local SpMM in float32 and bf16."""
    import torch

    from bignn_tpu_torch import ops
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse import bucket_graphs
    from bignn_tpu_torch.sparse.formats import build_outer_graph

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = []

    # row 2 over config2's 4 buckets, counts and weights in float32
    ds = load_dataset("drugbank")
    adj = [(torch.as_tensor(b.edge_src, device=dev),
            torch.as_tensor(b.edge_dst, device=dev),
            torch.as_tensor(b.edge_weight, device=dev),
            torch.as_tensor(b.block_estarts, device=dev), b.node_cap)
           for b in bucket_graphs(ds.molecules).batches]
    for weighted, form, tol in ((False, "", 0.0),
                                (True, ":weighted", 1e-6)):
        cs = [(s, d, w if weighted else None, e, n)
              for s, d, w, e, n in adj]
        name = f"block_adjacency:f32{form}"
        IN_BYTES[name] = sum(nbytes(*(t for t in c[:4] if t is not None))
                             for c in cs)
        libs = [smoke().index_put_call(s, d, n, torch.float32, w)
                for s, d, w, _, n in cs]
        out.append((name, lambda cs=cs: [ops.block_adjacency(*c) for c in cs],
                    lambda cs=cs: [ops.block_adjacency_plain(*c[:3], c[4])
                                   for c in cs],
                    lambda libs=libs: [f() for f in libs], tol))

    # rows 3 and 3b over config2's dense outer mask, N 1,704, H 4, D 32; the
    # backward's lse and out from the plain forward on the CPU, whose sums
    # have a fixed order, so that every ROOT gets the same inputs
    train = ds.split_edges("train")
    cnt = torch.as_tensor(build_outer_graph(
        train[:, 0], train[:, 1], ds.num_drugs).dense_cnt, device=dev)
    n, heads, head_dim = ds.num_drugs, 4, 32
    sl, sr = (torch.randn(n, heads, device=dev, generator=gen)
              for _ in range(2))
    v, g = (torch.randn(n, heads, head_dim, device=dev, generator=gen)
            for _ in range(2))
    fwd = (sl, sr, v, cnt)
    out_p, lse_p = (t.to(dev) for t in ops.flash_gat_attention_plain(
        *(t.cpu() for t in fwd)))
    bwd = (*fwd, lse_p, out_p, g)
    IN_BYTES["flash_gat_attention:f32"] = nbytes(*fwd)
    FLOPS["flash_gat_attention:f32"] = smoke().flash_fwd_flops(
        n, heads, head_dim)
    IN_BYTES["flash_gat_attention_bwd:f32"] = nbytes(*bwd)
    FLOPS["flash_gat_attention_bwd:f32"] = smoke().flash_bwd_flops(
        n, heads, head_dim)
    out.append(("flash_gat_attention:f32",
                lambda fwd=fwd: ops.flash_gat_attention(*fwd),
                lambda fwd=fwd: ops.flash_gat_attention_plain(*fwd), None,
                F32_TOL))
    out.append(("flash_gat_attention_bwd:f32",
                lambda bwd=bwd: ops.flash_gat_attention_bwd(*bwd),
                lambda bwd=bwd: ops.flash_gat_attention_bwd_plain(*bwd), None,
                smoke().BWD_TOL))
    # the wide forms at W1's outer heads (drawn as path O(i) draws them) and
    # at H 8, D 128, over the same mask
    for tag, (heads, head_dim) in ((":d256", smoke().WIDE_SHAPES["W1"]),
                                   (":d128", (8, 128))):
        wgen = torch.Generator(device=dev).manual_seed(SEED)
        sl, sr = (torch.randn(n, heads, device=dev, generator=wgen)
                  for _ in range(2))
        v, g = (torch.randn(n, heads, head_dim, device=dev, generator=wgen)
                for _ in range(2))
        fwd = (sl, sr, v, cnt)
        out_p, lse_p = (t.to(dev) for t in ops.flash_gat_attention_plain(
            *(t.cpu() for t in fwd)))
        bwd = (*fwd, lse_p, out_p, g)
        for name, args, flops, kernel, plain, tol in (
                (f"flash_gat_attention:f32{tag}", fwd, smoke().flash_fwd_flops,
                 ops.flash_gat_attention, ops.flash_gat_attention_plain,
                 F32_TOL),
                (f"flash_gat_attention_bwd:f32{tag}", bwd,
                 smoke().flash_bwd_flops, ops.flash_gat_attention_bwd,
                 ops.flash_gat_attention_bwd_plain, smoke().BWD_TOL)):
            IN_BYTES[name] = nbytes(*args)
            FLOPS[name] = flops(n, heads, head_dim)
            out.append((name, lambda f=kernel, a=args: f(*a),
                        lambda f=plain, a=args: f(*a), None, tol))

    # rows 5 and 7 as chip_smoke.py builds them: the segment max at the
    # largest bucket of the stand-in, the sorted-COO SpMM at the largest
    # bucket of the stand-in with molecules up to 160 atoms
    bucket = largest(bucket_graphs(ds.molecules))
    for name, kernel, plain, library, tol, nb, _ in (
            smoke().segment_max_forms(dev, bucket)
            + smoke().spmm_forms(largest(bucket_graphs(load_dataset(
                "drugbank", max_atoms=160).molecules)).to(dev))):
        IN_BYTES[name] = nb
        out.append((name, kernel, plain, library, tol))
    # row 5's backward through autograd, against the composed plain rule:
    # segment_max_bwd_plain, or in a tree from before it the composed
    # segment_max_bwd (its tie counts by the segment-sum kernel, integer
    # sums: the same bits)
    from bignn_tpu_torch.ops import segment
    plain_bwd = getattr(segment, "segment_max_bwd_plain",
                        segment.segment_max_bwd)
    for t, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, ids, s, g, rows = smoke().max_bwd_inputs(dev, bucket, dtype)
        kernel, o = smoke().max_bwd_autograd(x, ids, s, g)
        name = f"segment_max_bwd:{t}:autograd"
        IN_BYTES[name] = nbytes(x[:rows], ids, o, g) + 8 * s
        out.append((name, kernel,
                    lambda x=x, ids=ids, s=s, g=g, o=o: plain_bwd(x, ids, o,
                                                                  g, s),
                    smoke().max_bwd_library(x, ids, s, g), 0.0))

    b = largest(bucket_graphs(load_dataset(
        "synthetic-large", num_drugs=16384).molecules)).to(dev)
    n = b.node_cap
    x32 = torch.randn(n, 128, device=dev, generator=gen)
    g32 = torch.randn(n, 128, device=dev, generator=gen)
    for (t, dtype, tol), (w, tw, form) in itertools.product(
            (("f32", torch.float32, F32_TOL),
             ("bf16", torch.bfloat16, BF16_TOL)),
            ((None, None, ""), (b.edge_weight, b.edge_tweight,
                                ":weighted"))):
        if t == "bf16" and w is not None:  # value by value, as chip_smoke.py
            tol = smoke().BF16_WEIGHTED
        xb, gb = x32.to(dtype), g32.to(dtype)
        fwd = (xb, b.edge_src, b.edge_dst, w, b.block_estarts, b.edge_tsrc,
               b.edge_tdst, tw, b.block_tstarts, n)
        bwd = (gb, b.edge_tsrc, b.edge_tdst, tw, b.block_tstarts, n)
        # the library: torch.bmm over the dense blocks in the form's type,
        # as chip_smoke.block_spmm_kernels builds them
        # the real rows and the real edges (the padding edges come last)
        rows = int(b.node_mask.sum())
        e_real = int((b.edge_dst < n).sum())
        wbytes = 0 if w is None else nbytes(w[:e_real])
        IN_BYTES[f"block_spmm:{t}{form}"] = nbytes(
            xb[:rows], b.edge_src[:e_real], b.edge_dst[:e_real],
            b.block_estarts) + wbytes
        IN_BYTES[f"block_spmm_bwd:{t}{form}"] = nbytes(
            gb[:rows], b.edge_tsrc[:e_real], b.edge_tdst[:e_real],
            b.block_tstarts) + wbytes
        blocks = ops.block_adjacency_plain(b.edge_src, b.edge_dst, w,
                                           n).to(dtype)
        blocks_t = blocks.transpose(1, 2).contiguous()
        out.append((f"block_spmm:{t}{form}",
                    lambda fwd=fwd: ops.block_spmm(*fwd),
                    lambda w=w, xb=xb: ops.block_spmm_plain(
                        xb, b.edge_src, b.edge_dst, w, num_nodes=n),
                    lambda a=blocks, x=xb: ops.block_diag_spmm(a, x), tol))
        out.append((f"block_spmm_bwd:{t}{form}",
                    lambda bwd=bwd: ops.block_spmm_bwd(*bwd),
                    lambda bwd=bwd: ops.block_spmm_plain(*bwd[:4],
                                                         num_nodes=n),
                    lambda a=blocks_t, x=gb: ops.block_diag_spmm(a, x), tol))
    # the tiled forms: bf16 at F 300 (W1's inner width), the same bucket
    blocks = ops.block_adjacency_plain(b.edge_src, b.edge_dst, None,
                                       n).to(torch.bfloat16)
    blocks_t = blocks.transpose(1, 2).contiguous()
    x300 = torch.randn(n, 300, device=dev, generator=gen).to(torch.bfloat16)
    g300 = torch.randn(n, 300, device=dev, generator=gen).to(torch.bfloat16)
    fwd = (x300, b.edge_src, b.edge_dst, None, b.block_estarts, b.edge_tsrc,
           b.edge_tdst, None, b.block_tstarts, n)
    bwd = (g300, b.edge_tsrc, b.edge_tdst, None, b.block_tstarts, n)
    rows = int(b.node_mask.sum())
    e_real = int((b.edge_dst < n).sum())
    IN_BYTES["block_spmm:bf16:f300"] = nbytes(
        x300[:rows], b.edge_src[:e_real], b.edge_dst[:e_real],
        b.block_estarts)
    IN_BYTES["block_spmm_bwd:bf16:f300"] = nbytes(
        g300[:rows], b.edge_tsrc[:e_real], b.edge_tdst[:e_real],
        b.block_tstarts)
    out.append(("block_spmm:bf16:f300", lambda: ops.block_spmm(*fwd),
                lambda: ops.block_spmm_plain(x300, b.edge_src, b.edge_dst,
                                             None, num_nodes=n),
                lambda: ops.block_diag_spmm(blocks, x300), BF16_TOL))
    out.append(("block_spmm_bwd:bf16:f300", lambda: ops.block_spmm_bwd(*bwd),
                lambda: ops.block_spmm_plain(*bwd[:4], num_nodes=n),
                lambda: ops.block_diag_spmm(blocks_t, g300), BF16_TOL))
    return out


def digest(tensors) -> str:
    """A hash of the tensors' bits, to tell whether two trees give the
    same result."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _tensors(x) -> list:
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return [x]


def kernel_ms(fn, reps: int = 20) -> dict:
    """Device milliseconds a call of each kernel that ``fn`` launches, by
    ``torch.profiler`` over ``reps`` calls; a kernel is named without its
    arguments."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"\w+(<[^(]*>)?(?=\()", e.name)
            key = m.group(0) if m else e.name[:60]
            per[key] = per.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return per


def run_one(root: str, inputs: Path, only: tuple[str, ...] = ()) -> dict:
    """Time every form (or those whose names start with one of ``only``)
    with the ``bignn_tpu_torch`` of ``root``."""
    sys.path.insert(0, root)
    import torch

    import bignn_tpu_torch
    from bignn_tpu_torch.ops import cuda_lib

    pkg = Path(bignn_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise SystemExit(f"imported {pkg}, not the package under {root}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    build_s = time.perf_counter() - t0
    sleep = sleep_ms()
    forms = {}
    with torch.no_grad():
        for name, kernel, plain, library, tol in (new_cases(dev, inputs)
                                                  + cases(dev)):
            if only and not name.startswith(only):
                continue
            tol = (tol + (None,))[:3] if isinstance(tol, tuple) else (
                tol, False, None)
            try:
                got = _tensors(kernel())
            except ValueError as exc:
                if name not in NEWER:
                    raise
                forms[name] = dict(unsupported=str(exc))
                continue
            want = _tensors(plain())
            try:
                err = smoke()._check_close(name, tuple(got), tuple(want),
                                           *tol)
            except AssertionError as exc:
                forms[name] = dict(fails=str(exc), digest=digest(got))
                continue
            row = dict(max_abs_err=err, digest=digest(got))
            if name.startswith(TRACED):
                row["kernels"] = kernel_ms(kernel)
            if name in IN_BYTES:
                flops = FLOPS.get(name, 0)
                flops = flops if isinstance(flops, tuple) else (flops, 0.0)
                row["bound_ms"], row["bound_by"] = smoke().bound_ms(
                    IN_BYTES[name] + nbytes(*got), *flops,
                    GATHERED.get(name, 0))
            for tag, fn in (("", kernel), ("lib_", library)):
                if fn is None:
                    continue
                row[f"{tag}ms"] = events_ms(fn)
                dms, host, slept = device_ms(
                    fn, sleep, DEVICE_REPS // CALLS.get(name, 1))
                # a host slower than the sleep sets the rate: no device time
                row[f"{tag}device_ms"] = dms if host < slept else None
                row[f"{tag}host_ms"], row[f"{tag}sleep_ms"] = host, slept
            forms[name] = row
    return dict(root=str(Path(root).resolve()), library=lib.name,
                build_s=build_s, sleep_ms=sleep, forms=forms,
                fails=[k for k, v in forms.items() if "fails" in v])


def run_steps(root: str, only: tuple[str, ...] = ()) -> dict:
    """Path C's step, float32 and bf16, and path O(ii)'s W1 step, with the
    ``bignn_tpu_torch`` of ``root`` (see ``--steps``)."""
    sys.path.insert(0, root)
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import bignn_tpu_torch
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.ops import cuda_lib
    from bignn_tpu_torch.train import Trainer

    pkg = Path(bignn_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise SystemExit(f"imported {pkg}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_lib.build()
    cfg = get_config("config2")
    data = prepare_device_data(load_dataset("drugbank"))
    batches = smoke()._epoch_batches(data, cfg.train)
    models = {dtype: dataclasses.replace(cfg.model, readout="max",
                                         dtype=dtype)
              for dtype in ("float32", "bfloat16")}
    models["w1"] = smoke().wide_config("config2", "W1").model
    out = {}
    for key, model in models.items():
        if only and not key.startswith(only):
            continue
        trainer = Trainer(BiGNN(model), data, cfg.train, device=dev)
        trainer.init(SEED)

        def step(i):
            pairs, mask = batches[i % len(batches)]
            trainer.train_step(pairs, mask, 0, i)

        for i in range(5):
            step(i)
        secs = []
        for i in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(5):
                step(i)
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        busy = smoke()._busy_ms((e.time_range.start, e.time_range.end)
                                for e in device)
        seg, flash = (sum(e.time_range.end - e.time_range.start
                          for e in device if re.search(pattern, e.name))
                      for pattern in (r"max_segments|max_bwd|MaxOp",
                                      r"flash_gat"))
        out[key] = dict(median_ms=float(np.median(secs)) * 1e3,
                        min_ms=min(secs) * 1e3,
                        device_busy_ms=busy / 5,
                        launches=len(device) / 5,
                        segment_max_kernels_ms=seg / 1e3 / 5,
                        flash_gat_kernels_ms=flash / 1e3 / 5)
    return dict(root=str(Path(root).resolve()), steps=out)


def _child(*args: str) -> str:
    out = subprocess.run([sys.executable, __file__, *args],
                         capture_output=True, text=True, timeout=900)
    sys.stderr.write(out.stderr[-4000:])
    if out.returncode:
        print(out.stdout, flush=True)  # a failing tree's line, its fails
        raise SystemExit(f"{' '.join(args)}: exit {out.returncode}")
    return out.stdout


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--inputs":
        build_inputs(sys.argv[2], Path(sys.argv[3]))
        return 0
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--step-one":
        only = tuple(sys.argv[3].split(",")) if len(sys.argv) == 4 else ()
        print(json.dumps(run_steps(sys.argv[2], only)), flush=True)
        return 0
    if len(sys.argv) in (4, 5) and sys.argv[1] == "--one":
        only = tuple(sys.argv[4].split(",")) if len(sys.argv) == 5 else ()
        result = run_one(sys.argv[2], Path(sys.argv[3]), only)
        print(json.dumps(result), flush=True)
        return 1 if result["fails"] else 0
    roots, only = sys.argv[1:], []
    steps = roots[:1] == ["--steps"]
    if steps:
        roots = roots[1:]
    if roots[:1] == ["--only"]:
        only, roots = roots[1:2], roots[2:]
    if not roots:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    if steps:
        for root in roots:
            print(_child("--step-one", root, *only).strip().splitlines()[-1],
                  flush=True)
        return 0
    t0 = time.perf_counter()
    _child("--inputs", roots[0], str(INPUTS))
    print(f"inputs: {time.perf_counter() - t0:.1f} s -> {INPUTS}", flush=True)
    digests = {}
    for root in roots:
        lines = _child("--one", root, str(INPUTS), *only).strip().splitlines()
        print("\n".join(lines), flush=True)
        line = lines[-1]
        for name, row in json.loads(line)["forms"].items():
            if "digest" in row:
                digests.setdefault(name, set()).add(row["digest"])
    print(json.dumps({"same_bits": {k: len(v) == 1
                                    for k, v in digests.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
