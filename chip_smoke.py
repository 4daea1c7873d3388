"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # phases 1-2, then the profiles

Phases:
  1. device: a CUDA card of compute capability 9.0; TF32 off.
  2. build: the kernels of bignn_tpu_torch/csrc, with nvcc, into build/.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes config2 gives it (hole-interleaved readout ids included; the
     flash-GAT backward on the dense train graph), with times for both.
  4. serving path: config2 (GIN:128 x2 -> sum -> GAT:128:4 -> mlp:64,
     the JAX package's init of seed 0) on the DrugBank stand-in, served by
     Scorer:
     encode, pair scoring, top-k, batched top-k with known partners
     excluded. Its three kernels' launch counts must be > 0, and the
     embeddings must match the same forward run with the plain versions.
  5. training path: a config2 Trainer at full width (batch 2048 positives +
     2048 negatives, Adam lr 1e-3) takes 20 steps. All four kernels' launch
     counts must be > 0; step 1's gradients must match the same step run
     with the plain versions; the loss must be finite and fall.
  6. config2-real: Trainer.fit on the in-repo real drugs for seeds 0 and 1
     through the kernels (head_dim 8); the means of the best val AUC and of
     the test AUC must reach 0.70, the JAX package's learning gate.
  7. sparse serving: config4's model in float32 (GIN:128 x2 -> sum ->
     GAT:128:4 -> mlp:64, feat 32) served by Scorer over the whole
     100,000-drug synthetic-large graph, whose outer graph is above
     dense_max_nodes and so takes GATConv's edge-list branch: build, refresh,
     pair scoring of the val positives and as many negatives, top-k, batched
     top-k with known partners excluded. segment_sum, block_adjacency,
     segment_softmax and spmm_multihead must launch, flash_gat_attention
     must not. Then the new forward kernels against their plain versions at
     these shapes, and the embeddings and pair scores against a refresh of
     the same Scorer with the plain versions.
  8. sparse training: the full-graph Trainer with config4's model in
     float32 and config4's optimizer (Adam lr 3e-4, batch 1024 + 1024) on
     synthetic-large cut to 16,384 drugs (config4's max_drugs), 20 steps.
     First the new backward kernels against their plain versions at these
     shapes. Every sparse-outer kernel, forward and backward, must launch;
     step 1's gradients must match the same step with the plain versions;
     the loss must be finite and fall.
Each path runs with the launch counts set to 0 just before it and read just
after; the kernels line reports the sum of the paths' counts. The 100K
tensors are freed before phase 8. The last line is {"ok": true, "device":
{...}}; any failure raises, and the script exits non-zero without it.

--profile times instead of phases 3-8: the config2 training step and the
16,384-drug sparse training step (step medians with the kernels and with
the plain versions in turns: kernels, plain, plain, kernels; the
synchronized time of each part of a step; a torch.profiler trace of 5
steps: wall and device-busy time, device launches per step, the device
time of the busiest kernels), and the 100K-drug Scorer (the parts of its
build, a trace of 5 refreshes). It prints no ok line.
"""

from __future__ import annotations

import dataclasses
import gc
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
BWD_TOL = 1e-4  # x max(1, max |plain|): sums over whole rows and columns
EMB_RTOL, EMB_ATOL = 2e-4, 2e-5  # atol scaled by max |embedding|
GRAD_TOL = 1e-4  # x max |plain gradient|, per parameter tensor
SPARSE_TOL = 1e-5  # x max(1, max |plain|): f32 sums over <= 232 edges
TRAIN_STEPS = 20
REAL_GATE = 0.70  # tests/test_real_data.py:66-67


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
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"numpy {np.__version__}")
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

    # flash_gat_attention_bwd: the same mask, lse and out from the forward
    # kernel, a seeded cotangent; each output held to BWD_TOL x its scale
    g = torch.randn(n, heads, head_dim, device=dev, generator=gen)
    args = (sl, sr, v, cnt, lse, out, g)
    got = ops.flash_gat_attention_bwd(*args)
    want = ops.flash_gat_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    err, ratio = 0.0, 0.0
    for name, a, b in zip(("d_score_l", "d_score_r", "d_v"), got, want):
        e = (a - b).abs().max().item()
        scale = max(1.0, b.abs().max().item())
        log(f"  flash_gat_attention_bwd {name}: max_abs_err {e:.3e}, "
            f"max |plain| {b.abs().max().item():.3e}")
        err, ratio = max(err, e), max(ratio, e / scale)
    ms = cuda_ms(lambda: ops.flash_gat_attention_bwd(*args))
    plain_ms = cuda_ms(lambda: ops.flash_gat_attention_bwd_plain(*args))
    results["flash_gat_attention_bwd"] = (err, ms, plain_ms, BWD_TOL)

    for name, (err, ms, plain_ms, tol) in results.items():
        scaled = " x max(1, max |plain|)" if name.endswith("_bwd") else ""
        log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}{scaled}), kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not scaled and not err <= tol:
            raise AssertionError(f"{name}: error {err} above {tol}")
    if not ratio <= BWD_TOL:
        raise AssertionError(f"flash_gat_attention_bwd: error {ratio} of "
                             f"the scale, above {BWD_TOL}")
    return results


def negatives(ds, pos: np.ndarray) -> np.ndarray:
    """One corrupted partner per positive, as MinibatchTrainer.evaluate
    draws them."""
    rng = np.random.default_rng(1234)
    right = rng.random(len(pos)) < 0.5
    rand = rng.integers(0, ds.num_drugs, len(pos))
    return np.stack([np.where(right, pos[:, 0], rand),
                     np.where(right, rand, pos[:, 1])], axis=1)


def plain_ops():
    """The plain versions in place of the kernels, for a reference run."""
    from bignn_tpu_torch import ops

    return mock.patch.multiple(
        ops,
        segment_sum=ops.segment_sum_plain,
        block_adjacency=lambda s, d, w, e, n: ops.block_adjacency_plain(
            s, d, w, n),
        flash_gat_attention=ops.flash_gat_attention_plain,
        segment_softmax=ops.segment_softmax_plain,
        spmm_multihead=ops.spmm_multihead_plain,
        gather_rows_sorted_grad=ops.gather_rows_sorted_grad_plain)


# kernel wrapper -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "segment_sum": ("bignn_tpu_torch/csrc/segment_sum.cu",
                    "bignn_tpu/ops/pallas/segment.py:58"),
    "block_adjacency": ("bignn_tpu_torch/csrc/block_adj.cu",
                        "bignn_tpu/ops/pallas/block_adj.py:49"),
    "flash_gat_attention": ("bignn_tpu_torch/csrc/flash_gat.cu",
                            "bignn_tpu/ops/pallas/flash_gat.py:65"),
    "flash_gat_attention_bwd": ("bignn_tpu_torch/csrc/flash_gat_bwd.cu",
                                "bignn_tpu/ops/pallas/flash_gat.py:85"),
    "segment_softmax": ("bignn_tpu_torch/csrc/segment_softmax.cu",
                        "bignn_tpu/ops/pallas/segment.py:307"),
    "segment_softmax_bwd": ("bignn_tpu_torch/csrc/segment_softmax.cu",
                            "bignn_tpu/ops/pallas/segment.py:293"),
    "spmm_multihead": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                       "bignn_tpu/ops/multihead.py:76"),
    "spmm_multihead_bwd": ("bignn_tpu_torch/csrc/spmm_multihead.cu",
                           "bignn_tpu/ops/multihead.py:91"),
    "gather_rows_sorted_grad_bwd": ("bignn_tpu_torch/csrc/segment_sum.cu",
                                    "bignn_tpu/ops/gather.py:72"),
}


def reset_counts() -> None:
    from bignn_tpu_torch import ops

    for name in KERNELS:
        getattr(ops, name).launches = 0


def read_counts() -> dict:
    from bignn_tpu_torch import ops

    return {name: getattr(ops, name).launches for name in KERNELS}


def run_serving(dev, ds) -> dict:
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.serve import Scorer

    cfg = get_config("config2")
    model = BiGNN(cfg.model, seed=SEED)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    reset_counts()
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

    launches = read_counts()
    log(f"  launches on the serving path: {launches}")
    for name in ("segment_sum", "block_adjacency", "flash_gat_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # the same forward with the plain versions on the card
    with plain_ops():
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


def _timed_steps(trainer, batches, label: str):
    """Run ``batches`` as steps 0.. of epoch 0, each timed on the host clock
    up to a synchronize; logs the times, returns (losses, step-1 grads)."""
    losses, secs = [], []
    for i, (pairs, mask) in enumerate(batches):
        t0 = time.perf_counter()
        loss = trainer.train_step(pairs, mask, 0, i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if i == 0:
            grads = {k: p.grad.clone()
                     for k, p in trainer.model.named_parameters()}
    log(f"  {label}: median step {np.median(secs) * 1e3:.3f} ms over "
        f"{len(secs)} steps (first {secs[0] * 1e3:.3f}, min "
        f"{min(secs) * 1e3:.3f}, max {max(secs) * 1e3:.3f})")
    return losses, grads


def run_training(dev, ds) -> dict:
    """config2 training at full width through the kernels, and the same
    steps with the plain versions."""
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import prepare_device_data
    from bignn_tpu_torch.data.sampler import EdgeMinibatchSampler

    cfg = get_config("config2")
    data = prepare_device_data(ds)
    sampler = EdgeMinibatchSampler(data.train_pairs, cfg.train.batch_size,
                                   cfg.train.seed)
    batches = [b for _, b in zip(range(TRAIN_STEPS), sampler.epoch(0))]
    return _train_and_check(dev, cfg.model, data, cfg.train, batches,
                            ("segment_sum", "block_adjacency",
                             "flash_gat_attention", "flash_gat_attention_bwd"))


def _train_and_check(dev, model_cfg, data, train_cfg, batches,
                     must_launch) -> dict:
    """TRAIN_STEPS steps of a Trainer through the kernels from the JAX init
    of SEED (the launch counts read just after), then the same steps with
    the plain versions; checks launches, gradients and losses and returns
    the counts."""
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    reset_counts()
    trainer = Trainer(BiGNN(model_cfg), data, train_cfg, device=dev)
    params0, _ = trainer.init(SEED)
    losses, grads = _timed_steps(trainer, batches, "kernels")
    launches = read_counts()
    log(f"  launches on the training path: {launches}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in training")
    log("  losses: " + " ".join(f"{x:.5f}" for x in losses))

    for name, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient of {name}")
        if name.startswith(("inner.0.", "inner.1.", "outer.0.")) and not (
                g.abs().max().item() > 0):
            raise AssertionError(f"zero gradient of {name}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")

    with plain_ops():
        plain = Trainer(BiGNN(model_cfg), data, train_cfg, device=dev)
        plain.model.load_state_dict(params0)
        plain_losses, plain_grads = _timed_steps(plain, batches,
                                                 "plain versions")
    worst = 0.0
    for name, g in grads.items():
        ref = plain_grads[name]
        scale = ref.abs().max().item()
        err = (g - ref).abs().max().item()
        worst = max(worst, err / scale if scale > 0 else err)
        log(f"  step-1 grad {name}: max_abs_err {err:.3e}, max |plain| "
            f"{scale:.3e}")
    log(f"  step-1 gradients vs plain: worst max|d| / max|g_plain| "
        f"{worst:.3e} (bound {GRAD_TOL:g}); plain losses step 1 / "
        f"{len(batches)}: {plain_losses[0]:.5f} / {plain_losses[-1]:.5f}")
    if not worst <= GRAD_TOL:
        raise AssertionError(f"step-1 gradients off the plain run: {worst}")
    metrics = trainer.evaluate(split="val")
    log(f"  after {len(batches)} steps: val AUC {metrics['val_auc']:.4f}, "
        f"AP {metrics['val_ap']:.4f}")
    return launches


def run_real_gate(dev) -> None:
    """config2-real through the kernels: the JAX learning gate."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    cfg = get_config("config2-real")
    ds = load_dataset(cfg.dataset)
    data = prepare_device_data(ds)
    ops.flash_gat_attention_bwd.launches = 0
    best_vals, tests = [], []
    for seed in (0, 1):
        t0 = time.perf_counter()
        model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
        trainer = Trainer(model, data, dataclasses.replace(cfg.train,
                                                           seed=seed), dev)
        _, result = trainer.fit()
        best_vals.append(max(r["val_auc"] for r in result["history"]))
        tests.append(result["test_auc"])
        log(f"  seed {seed}: best val AUC {best_vals[-1]:.4f} (epoch "
            f"{result['best_epoch']}), test AUC {tests[-1]:.4f}, "
            f"{cfg.train.epochs} epochs in {time.perf_counter() - t0:.2f} s")
    log(f"  means: best val AUC {np.mean(best_vals):.4f}, test AUC "
        f"{np.mean(tests):.4f} (gate {REAL_GATE}); backward kernel "
        f"launches {ops.flash_gat_attention_bwd.launches}")
    if ops.flash_gat_attention_bwd.launches <= 0:
        raise AssertionError("config2-real did not run the backward kernel")
    if not (np.mean(best_vals) >= REAL_GATE and np.mean(tests) >= REAL_GATE):
        raise AssertionError(f"config2-real below the gate: {best_vals}, "
                             f"{tests}")


def _check_close(name: str, got, want, tol: float) -> float:
    """Worst max|got - want| / max(1, max|want|) over the outputs of a
    kernel and its plain version; raises above ``tol``. Returns the worst
    absolute error."""
    torch.cuda.synchronize()
    err, ratio = 0.0, 0.0
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        e = (a - b).abs().max().item()
        err, ratio = max(err, e), max(ratio, e / max(1.0, b.abs().max().item()))
    if not ratio <= tol:
        raise AssertionError(f"{name}: error {ratio} of the scale, above {tol}")
    return err


def _compare(results: dict, name: str, kernel, plain, tol: float) -> None:
    err = _check_close(name, kernel(), plain(), tol)
    ms, plain_ms = cuda_ms(kernel, reps=10), cuda_ms(plain, reps=10)
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g} x max(1, max "
        f"|plain|)), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results[name] = (err, ms, plain_ms, tol)


def sparse_config():
    """config4 and its model in float32 (bf16 comes with MinibatchTrainer,
    ROADMAP Queue 1 item 3)."""
    from bignn_tpu_torch.config import get_config

    cfg = get_config("config4")
    return cfg, dataclasses.replace(cfg.model, dtype="float32")


def run_sparse_serving(dev) -> tuple[dict, dict]:
    """config4's model served over the whole 100K-drug graph; returns the
    launch counts and the forward kernels' comparisons."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.serve import Scorer

    cfg, model_cfg = sparse_config()
    t0 = time.perf_counter()
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    log(f"  dataset {ds.name}: {ds.num_drugs} drugs, "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, {len(ds.edges)} "
        f"DDI edges ({len(ds.train_idx)} train), "
        f"{time.perf_counter() - t0:.2f} s")
    model = BiGNN(model_cfg, seed=SEED)
    params = {k: v.clone() for k, v in model.state_dict().items()}

    reset_counts()
    t0 = time.perf_counter()
    scorer = Scorer(model, ds, params, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scorer.refresh(params)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    emb = scorer.embeddings
    log(f"  Scorer build (host layouts + upload + device encode): "
        f"{build_s:.4f} s; refresh (device encode alone): {refresh_s:.4f} s")
    if tuple(emb.shape) != (ds.num_drugs, 128) or not torch.isfinite(emb).all():
        raise AssertionError(f"bad embeddings {tuple(emb.shape)}")

    pos = ds.split_edges("val").astype(np.int64)
    pairs = np.concatenate([pos, negatives(ds, pos)])
    scorer.score_pairs(pairs[:scorer.chunk])  # warm-up
    t0 = time.perf_counter()
    scores = scorer.score_pairs(pairs)
    pairs_ms = (time.perf_counter() - t0) * 1e3
    if scores.shape != (len(pairs),) or not np.isfinite(scores).all():
        raise AssertionError("bad pair scores")
    log(f"  score_pairs: {len(pairs)} pairs in {pairs_ms:.3f} ms")

    drugs = np.arange(8) * 12_347 % ds.num_drugs
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

    batch = np.arange(64) * 1_543 % ds.num_drugs
    scorer.top_k_batch(batch, k=20, exclude_known=True)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cand, s = scorer.top_k_batch(batch, k=20, exclude_known=True)
    batch_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = read_counts()
    known = np.concatenate([ds.split_edges("train"), ds.split_edges("val")])
    near = known[np.isin(known[:, 0], batch) | np.isin(known[:, 1], batch)]
    for row, d in enumerate(batch):
        partners = set(near[near[:, 0] == d, 1]) | set(
            near[near[:, 1] == d, 0]) | {d}
        if partners & set(cand[row].tolist()) or not np.isfinite(s[row]).all():
            raise AssertionError(f"known partner ranked for drug {d}")
    log(f"  top_k_batch(64 drugs, k=20, exclude_known): {batch_ms:.3f} ms "
        f"({batch_ms / 64:.4f} ms per query); peak device memory "
        f"{peak:.2f} GiB")
    log(f"  launches on the serving path: {launches}")
    for name in ("segment_sum", "block_adjacency", "segment_softmax",
                 "spmm_multihead"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if launches["flash_gat_attention"] != 0:
        raise AssertionError("the dense flash-GAT ran on the sparse path")

    # the new forward kernels against their plain versions at these shapes
    outer = scorer._outer
    n, e = outer.num_nodes, outer.edge_cap
    log(f"  kernels at N {n}, E {e}, H 4, D 32 (E*H*D = {e * 128})")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = 3 * torch.randn(e, 4, device=dev, generator=gen)
    v = torch.randn(n, 4, 32, device=dev, generator=gen)
    results = {}
    _compare(results, "segment_softmax",
             lambda: ops.segment_softmax(x, outer.edge_dst, n),
             lambda: ops.segment_softmax_plain(x, outer.edge_dst, n),
             SPARSE_TOL)
    alpha = ops.segment_softmax_plain(x, outer.edge_dst, n)
    del x
    _compare(results, "spmm_multihead",
             lambda: ops.spmm_multihead(v, outer.edge_src, outer.edge_dst,
                                        alpha, n),
             lambda: ops.spmm_multihead_plain(v, outer.edge_src,
                                              outer.edge_dst, alpha, n),
             SPARSE_TOL)
    del v, alpha
    torch.cuda.empty_cache()

    # the same Scorer refreshed with the plain versions on the card
    with plain_ops():
        scorer.refresh(params)
        ref_scores = scorer.score_pairs(pairs)
    ref = scorer.embeddings
    scale = ref.abs().max().item()
    diff = (emb - ref).abs()
    log(f"  embeddings vs plain refresh: max_abs_err {diff.max().item():.3e} "
        f"(max |emb| {scale:.3e}; rtol {EMB_RTOL}, atol {EMB_ATOL} x max)")
    if not bool((diff <= EMB_ATOL * scale + EMB_RTOL * ref.abs()).all()):
        raise AssertionError("embeddings disagree with the plain refresh")
    if not np.allclose(scores, ref_scores, rtol=EMB_RTOL,
                       atol=EMB_ATOL * np.abs(ref_scores).max()):
        raise AssertionError("pair scores disagree with the plain refresh")
    log(f"  pair scores vs plain refresh: max_abs_err "
        f"{np.abs(scores - ref_scores).max():.3e}")
    return launches, results


def run_sparse_training(dev) -> tuple[dict, dict]:
    """The full-graph Trainer with config4's model and optimizer on 16,384
    drugs; returns the launch counts and the backward kernels'
    comparisons."""
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.data import load_dataset, prepare_device_data
    from bignn_tpu_torch.data.sampler import EdgeMinibatchSampler

    cfg, model_cfg = sparse_config()
    t0 = time.perf_counter()
    ds = load_dataset(cfg.dataset, num_drugs=cfg.max_drugs)
    data = prepare_device_data(ds)
    log(f"  dataset {ds.name} at {ds.num_drugs} drugs: "
        f"{sum(m.num_nodes for m in ds.molecules)} atoms, "
        f"{len(ds.train_idx)} train edges; data + layouts "
        f"{time.perf_counter() - t0:.2f} s")
    outer = data.outer.to(dev)
    if outer.dense_cnt is not None:
        raise AssertionError("the outer graph has dense masks")
    n, e = outer.num_nodes, outer.edge_cap
    log(f"  outer graph: {n} drugs, edge_cap {e} (directed, self-loops, "
        f"padded), no dense masks")

    # the new backward kernels against their plain versions at these shapes
    log(f"  kernels at N {n}, E {e}, H 4, D 32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    alpha = ops.segment_softmax_plain(
        3 * torch.randn(e, 4, device=dev, generator=gen), outer.edge_dst, n)
    g_e = torch.randn(e, 4, device=dev, generator=gen)
    v = torch.randn(n, 4, 32, device=dev, generator=gen)
    g = torch.randn(n, 4, 32, device=dev, generator=gen)
    results = {}
    _compare(results, "segment_softmax_bwd",
             lambda: ops.segment_softmax_bwd(alpha, g_e, outer.edge_dst, n),
             lambda: ops.segment_softmax_bwd_plain(alpha, g_e,
                                                   outer.edge_dst, n),
             BWD_TOL)
    mh = (v, outer.edge_src, outer.edge_dst, alpha, n, g,
          outer.edge_src_perm, outer.edge_src_sorted)
    _compare(results, "spmm_multihead_bwd",
             lambda: ops.spmm_multihead_bwd(*mh),
             lambda: ops.spmm_multihead_bwd_plain(*mh), BWD_TOL)
    gather = (g_e, outer.edge_src, n, outer.edge_src_perm,
              outer.edge_src_sorted)
    _compare(results, "gather_rows_sorted_grad_bwd",
             lambda: ops.gather_rows_sorted_grad_bwd(*gather),
             lambda: ops.gather_rows_sorted_grad_bwd_plain(*gather), BWD_TOL)
    _check_close("gather_rows_sorted_grad_bwd (sorted dst)",
                 ops.gather_rows_sorted_grad_bwd(g_e, outer.edge_dst, n),
                 ops.gather_rows_sorted_grad_bwd_plain(g_e, outer.edge_dst, n),
                 BWD_TOL)
    del alpha, g_e, v, g, mh, gather, outer
    torch.cuda.empty_cache()

    sampler = EdgeMinibatchSampler(data.train_pairs, cfg.train.batch_size,
                                   cfg.train.seed)
    batches = [b for _, b in zip(range(TRAIN_STEPS), sampler.epoch(0))]
    launches = _train_and_check(
        dev, model_cfg, data, cfg.train, batches,
        ("segment_sum", "block_adjacency", "segment_softmax",
         "segment_softmax_bwd", "spmm_multihead", "spmm_multihead_bwd",
         "gather_rows_sorted_grad_bwd"))
    if launches["flash_gat_attention"] or launches["flash_gat_attention_bwd"]:
        raise AssertionError("the dense flash-GAT ran on the sparse path")
    return launches, results


def _median_ms(fn, reps: int = 20) -> float:
    """Median host-clock milliseconds of ``fn()`` up to a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _trace(run, reps: int, unit: str) -> None:
    """torch.profiler over ``run()``, which repeats a ``unit`` of work
    ``reps`` times: wall and device-busy time, device launches per unit,
    the device time of the busiest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_ms((e.time_range.start, e.time_range.end) for e in device)
    log(f"  profiled {reps} x {unit}: wall {wall_ms:.3f} ms (profiler on), "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} %), "
        f"{len(device) / reps:.1f} device launches per {unit}")
    per_name: dict[str, list[float]] = {}
    for e in device:
        per_name.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    for name, times in top:
        log(f"    {sum(times) / reps:8.4f} ms {len(times) / reps:6.1f}x  "
            f"{name[:90]}")


def profile_training(dev, model_cfg, data, train_cfg) -> None:
    """Where a training step's time goes (see --profile above)."""
    from bignn_tpu_torch import prng
    from bignn_tpu_torch.data.sampler import (
        EdgeMinibatchSampler,
        sample_negative_pairs,
    )
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    sampler = EdgeMinibatchSampler(data.train_pairs, train_cfg.batch_size,
                                   train_cfg.seed)
    batches = [b for _, b in zip(range(TRAIN_STEPS), sampler.epoch(0))]
    trainer = Trainer(BiGNN(model_cfg), data, train_cfg, device=dev)
    trainer.init(SEED)
    _timed_steps(trainer, batches, "warm-up")
    for label in ("kernels", "plain", "plain", "kernels"):
        trainer.init(SEED)
        if label == "plain":
            with plain_ops():
                _timed_steps(trainer, batches, label)
        else:
            _timed_steps(trainer, batches, label)

    pairs, mask = batches[0]
    pos = torch.as_tensor(pairs, device=dev)
    pmask = torch.as_tensor(mask, device=dev)
    key = prng.fold_in(prng.fold_in(prng.key(train_cfg.seed + 1), 0), 0)

    def backward():
        trainer.optimizer.zero_grad(set_to_none=True)
        trainer._loss_fn(pos, pmask, key).backward()

    parts = {
        "negatives (host threefry + one upload)": lambda: sample_negative_pairs(
            key, pos, data.num_drugs, train_cfg.neg_ratio),
        "forward + loss": lambda: trainer._loss_fn(pos, pmask, key),
        "forward + loss + backward": backward,
        "optimizer step": trainer.optimizer.step,
    }
    for name, fn in parts.items():
        log(f"  {name}: {_median_ms(fn):.3f} ms (median of 20, synchronized)")

    def five_steps():
        for i, (pairs, mask) in enumerate(batches[:5]):
            trainer.train_step(pairs, mask, 1, i)

    _trace(five_steps, 5, "step")


def profile_sparse_serving(dev) -> None:
    """Where the 100K-drug Scorer's build goes (each part synchronized on
    its own clock; "rest" is the known-partner CSR and the model upload),
    then a trace of 5 refreshes."""
    from bignn_tpu_torch import serve
    from bignn_tpu_torch.data import load_dataset
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.sparse import formats

    cfg, model_cfg = sparse_config()
    t0 = time.perf_counter()
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    log(f"  load_dataset: {time.perf_counter() - t0:.3f} s")
    model = BiGNN(model_cfg, seed=SEED)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    parts: dict[str, float] = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    with mock.patch.multiple(
            serve, bucket_graphs=timed("bucket_graphs", serve.bucket_graphs),
            upload_buckets=timed("upload_buckets", serve.upload_buckets),
            build_outer_graph=timed("build_outer_graph",
                                    serve.build_outer_graph)), \
            mock.patch.object(serve.Scorer, "refresh",
                              timed("refresh", serve.Scorer.refresh)):
        t0 = time.perf_counter()
        scorer = serve.Scorer(model, ds, params, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    for name, sec in parts.items():
        log(f"  {name}: {sec:.3f} s")
    log(f"  rest: {total - sum(parts.values()):.3f} s; Scorer build "
        f"{total:.3f} s")
    train = ds.split_edges("train").astype(np.int64)
    t0 = time.perf_counter()
    src, dst = formats.symmetrize(train[:, 0], train[:, 1])
    t1 = time.perf_counter()
    src, _, _ = formats._build_sorted(src, dst, ds.num_drugs, True, True)
    t2 = time.perf_counter()
    formats.src_sort_arrays(src.astype(np.int32))
    log(f"  build_outer_graph again, by part: symmetrize {t1 - t0:.3f} s, "
        f"dst sort + self-loops + weights {t2 - t1:.3f} s, source sort "
        f"{time.perf_counter() - t2:.3f} s")

    def refreshes():
        for _ in range(5):
            scorer.refresh(params)

    scorer.refresh(params)
    _trace(refreshes, 5, "refresh")


def main() -> int:
    profiling = sys.argv[1:] == ["--profile"]
    if sys.argv[1:] and not profiling:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
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

    if profiling:
        from bignn_tpu_torch.config import get_config
        from bignn_tpu_torch.data import prepare_device_data

        log("== profile: config2 training step, full width")
        cfg = get_config("config2")
        profile_training(dev, cfg.model, prepare_device_data(ds), cfg.train)
        log("== profile: config4's model served over 100,000 drugs")
        profile_sparse_serving(dev)
        gc.collect()
        torch.cuda.empty_cache()
        log("== profile: config4's model, training step on 16,384 drugs")
        cfg, model_cfg = sparse_config()
        data = prepare_device_data(load_dataset(cfg.dataset,
                                                num_drugs=cfg.max_drugs))
        profile_training(dev, model_cfg, data, cfg.train)
        return 0

    log("== kernels vs plain (config2 shapes)")
    results = compare_kernels(dev, ds, bucketing, outer)

    log("== serving path: config2 served by Scorer")
    counts = [run_serving(dev, ds)]
    log("== training path: config2 Trainer, full width")
    counts.append(run_training(dev, ds))
    log("== config2-real through the kernels")
    run_real_gate(dev)
    log("== sparse serving: config4's model over 100,000 drugs")
    served, fwd = run_sparse_serving(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("== sparse training: config4's model, full graph of 16,384 drugs")
    trained, bwd = run_sparse_training(dev)
    counts += [served, trained]
    results.update(fwd)
    results.update(bwd)

    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": tpu,
         "launches": sum(c[name] for c in counts),
         "max_abs_err": results[name][0], "ms": results[name][1],
         "plain_ms": results[name][2]}
        for name, (source, tpu) in KERNELS.items()]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
