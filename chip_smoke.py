"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases:
  1. device: a CUDA card of compute capability 9.0; TF32 off.
  2. build: the kernels of bignn_tpu_torch/csrc, with nvcc, into build/.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the config2 serving path gives it (hole-interleaved readout
     ids included), with times for both.
  4. main path: config2 (GIN:128 x2 -> sum -> GAT:128:4 -> mlp:64, seeded
     random weights) on the DrugBank stand-in, served by Scorer: encode,
     pair scoring, top-k, batched top-k with known partners excluded. Every
     kernel's launch count must be > 0, and the embeddings must match the
     same forward run with the plain versions on the card.
The last line is {"ok": true, "device": {...}}; any failure raises, and the
script exits non-zero without it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
SEGMENT_SUM_TOL = 1e-4  # f32 sums of <= 48 unit-scale rows in another order
FLASH_TOL = 1e-4  # f32 softmax sums over up to N=1704 sources, other order
EMB_RTOL, EMB_ATOL = 2e-4, 2e-5  # atol scaled by max |embedding|


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events."""
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


def check_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}, capability {cap}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card_line())
    return torch.device("cuda", 0)


def build_kernels() -> None:
    from bignn_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())


def compare_kernels(dev, ds, bucketing, outer_host) -> dict:
    """Each kernel against its plain version at the main path's shapes;
    returns name -> (max_abs_err, ms, plain_ms, tol)."""
    from bignn_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # segment_sum: the readout of every bucket, real hole-interleaved ids
    seg_cases = []
    for i, b in enumerate(bucketing.batches):
        ids = torch.as_tensor(b.graph_ids, device=dev)
        is_valid = b.graph_ids < b.num_graphs
        holes = int(np.sum(np.diff(is_valid.astype(np.int8)) == 1))
        log(f"  bucket {i}: node_cap {b.node_cap}, edge_cap {b.edge_cap}, "
            f"{b.num_graphs} molecules, {holes} padding runs between them, "
            f"ids sorted: {bool(np.all(np.diff(b.graph_ids) >= 0))}, valid "
            f"ids sorted: {bool(np.all(np.diff(b.graph_ids[is_valid]) >= 0))}")
        x = torch.randn(b.node_cap, 128, device=dev, generator=gen)
        seg_cases.append((x, ids, b.num_graphs))
    err = 0.0
    for x, ids, s in seg_cases:
        got = ops.segment_sum(x, ids, s)
        want = ops.segment_sum_plain(x, ids, s)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
    ms = cuda_ms(lambda: [ops.segment_sum(*c) for c in seg_cases])
    plain_ms = cuda_ms(lambda: [ops.segment_sum_plain(*c) for c in seg_cases])
    results["segment_sum"] = (err, ms, plain_ms, SEGMENT_SUM_TOL)

    # block_adjacency: the count adjacency of every bucket (exact), and the
    # weighted form once
    adj_cases = [
        (torch.as_tensor(b.edge_src, device=dev),
         torch.as_tensor(b.edge_dst, device=dev),
         torch.as_tensor(b.block_estarts, device=dev), b.node_cap,
         torch.as_tensor(b.edge_weight, device=dev))
        for b in bucketing.batches]
    err = 0.0
    for src, dst, est, n, w in adj_cases:
        got = ops.block_adjacency(src, dst, None, est, n)
        want = ops.block_adjacency_plain(src, dst, None, n)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        wgot = ops.block_adjacency(src, dst, w, est, n)
        wwant = ops.block_adjacency_plain(src, dst, w, n)
        torch.cuda.synchronize()
        werr = (wgot - wwant).abs().max().item()
        if werr > 1e-6:
            raise AssertionError(f"weighted block_adjacency error {werr}")
    ms = cuda_ms(lambda: [ops.block_adjacency(s, d, None, e, n)
                          for s, d, e, n, _ in adj_cases])
    plain_ms = cuda_ms(lambda: [ops.block_adjacency_plain(s, d, None, n)
                                for s, d, e, n, _ in adj_cases])
    results["block_adjacency"] = (err, ms, plain_ms, 0.0)

    # flash_gat_attention: the dense outer graph's mask, N=1704, H=4, D=32
    n, heads, head_dim = ds.num_drugs, 4, 32
    cnt = torch.as_tensor(outer_host.dense_cnt, device=dev)
    sl = torch.randn(n, heads, device=dev, generator=gen)
    sr = torch.randn(n, heads, device=dev, generator=gen)
    v = torch.randn(n, heads, head_dim, device=dev, generator=gen)
    out, lse = ops.flash_gat_attention(sl, sr, v, cnt)
    out_p, lse_p = ops.flash_gat_attention_plain(sl, sr, v, cnt)
    torch.cuda.synchronize()
    err = max((out - out_p).abs().max().item(),
              (lse - lse_p).abs().max().item())
    ms = cuda_ms(lambda: ops.flash_gat_attention(sl, sr, v, cnt))
    plain_ms = cuda_ms(lambda: ops.flash_gat_attention_plain(sl, sr, v, cnt))
    results["flash_gat_attention"] = (err, ms, plain_ms, FLASH_TOL)

    for name, (err, ms, plain_ms, tol) in results.items():
        log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}), kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"{name}: error {err} above {tol}")
    return results


def negatives(ds, pos: np.ndarray) -> np.ndarray:
    """One corrupted partner per positive, as MinibatchTrainer.evaluate
    draws them."""
    rng = np.random.default_rng(1234)
    right = rng.random(len(pos)) < 0.5
    rand = rng.integers(0, ds.num_drugs, len(pos))
    return np.stack([np.where(right, pos[:, 0], rand),
                     np.where(right, rand, pos[:, 1])], axis=1)


def run_main_path(dev, ds) -> dict:
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.serve import Scorer

    cfg = get_config("config2")
    model = BiGNN(cfg.model, generator=torch.Generator().manual_seed(SEED))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    kernels = (ops.segment_sum, ops.block_adjacency, ops.flash_gat_attention)
    for k in kernels:
        k.launches = 0

    t0 = time.perf_counter()
    scorer = Scorer(model, ds, params, device=dev)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scorer.refresh(params)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    emb = scorer.embeddings
    log(f"  Scorer build (host layout + upload + device encode): "
        f"{encode_s:.4f} s; refresh (device encode alone): {refresh_s:.4f} s")
    if tuple(emb.shape) != (ds.num_drugs, 128) or not torch.isfinite(emb).all():
        raise AssertionError(f"bad embeddings {tuple(emb.shape)}")

    pos = ds.split_edges("val").astype(np.int64)
    pairs = np.concatenate([pos, negatives(ds, pos)])
    scorer.score_pairs(pairs)  # warm-up: first-use allocations
    t0 = time.perf_counter()
    scores = scorer.score_pairs(pairs)
    pairs_ms = (time.perf_counter() - t0) * 1e3
    if scores.shape != (len(pairs),) or not np.isfinite(scores).all():
        raise AssertionError("bad pair scores")
    log(f"  score_pairs: {len(pairs)} pairs in {pairs_ms:.3f} ms")

    drugs = np.arange(8) * 211 % ds.num_drugs
    scorer.top_k(int(drugs[0]), k=20)  # warm-up
    top_ms = []
    for d in drugs:
        t0 = time.perf_counter()
        ids, s = scorer.top_k(int(d), k=20)
        top_ms.append((time.perf_counter() - t0) * 1e3)
        if d in ids or not np.isfinite(s).all() or np.any(np.diff(s) > 0):
            raise AssertionError(f"bad top_k for drug {d}")
    log(f"  top_k(k=20): median {np.median(top_ms):.3f} ms over "
        f"{len(drugs)} queries (min {min(top_ms):.3f}, max {max(top_ms):.3f})")

    batch = np.arange(64) * 26 % ds.num_drugs
    scorer.top_k_batch(batch, k=20, exclude_known=True)  # warm-up
    t0 = time.perf_counter()
    cand, s = scorer.top_k_batch(batch, k=20, exclude_known=True)
    batch_ms = (time.perf_counter() - t0) * 1e3
    known = np.concatenate([ds.split_edges("train"), ds.split_edges("val")])
    for row, d in enumerate(batch):
        partners = set(known[known[:, 0] == d, 1]) | set(
            known[known[:, 1] == d, 0]) | {d}
        if partners & set(cand[row].tolist()) or not np.isfinite(s[row]).all():
            raise AssertionError(f"known partner ranked for drug {d}")
    log(f"  top_k_batch(64 drugs, k=20, exclude_known): {batch_ms:.3f} ms "
        f"({batch_ms / 64:.4f} ms per query)")

    launches = {k.__name__: k.launches for k in kernels}
    log(f"  launches on the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # the same forward with the plain versions on the card
    with mock.patch.multiple(
            ops,
            segment_sum=ops.segment_sum_plain,
            block_adjacency=lambda s, d, w, e, n: ops.block_adjacency_plain(
                s, d, w, n),
            flash_gat_attention=ops.flash_gat_attention_plain):
        ref = Scorer(model, ds, params, device=dev)
    scale = ref.embeddings.abs().max().item()
    diff = (emb - ref.embeddings).abs()
    bound = EMB_ATOL * scale + EMB_RTOL * ref.embeddings.abs()
    log(f"  embeddings vs plain forward: max_abs_err {diff.max().item():.3e} "
        f"(max |emb| {scale:.3e}; rtol {EMB_RTOL}, atol {EMB_ATOL} x max)")
    if not bool((diff <= bound).all()):
        raise AssertionError("embeddings disagree with the plain forward")
    ref_scores = ref.score_pairs(pairs)
    if not np.allclose(scores, ref_scores, rtol=EMB_RTOL,
                       atol=EMB_ATOL * np.abs(ref_scores).max()):
        raise AssertionError("pair scores disagree with the plain forward")
    return launches


def main() -> int:
    dev = check_device()
    log("== build")
    build_kernels()

    from bignn_tpu_torch import native
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.sparse import bucket_graphs, build_outer_graph

    log(f"native host library loaded: {native.available()} "
        f"({native.LIB_PATH.name})")
    t0 = time.perf_counter()
    ds = load_dataset("drugbank")
    log(f"dataset {ds.name}: {ds.num_drugs} drugs, "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, "
        f"{len(ds.edges)} DDI edges ({len(ds.train_idx)} train), "
        f"{time.perf_counter() - t0:.2f} s")
    bucketing = bucket_graphs(ds.molecules)
    train = ds.split_edges("train")
    outer = build_outer_graph(train[:, 0], train[:, 1], ds.num_drugs)

    log("== kernels vs plain (config2 shapes)")
    results = compare_kernels(dev, ds, bucketing, outer)

    log("== main path: config2 served by Scorer")
    launches = run_main_path(dev, ds)

    sources = {
        "segment_sum": ("bignn_tpu_torch/csrc/segment_sum.cu",
                        "bignn_tpu/ops/pallas/segment.py:58"),
        "block_adjacency": ("bignn_tpu_torch/csrc/block_adj.cu",
                            "bignn_tpu/ops/pallas/block_adj.py:49"),
        "flash_gat_attention": ("bignn_tpu_torch/csrc/flash_gat.cu",
                                "bignn_tpu/ops/pallas/flash_gat.py:65"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms, _) in results.items()]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
