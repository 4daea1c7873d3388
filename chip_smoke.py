"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # phases 1-2, then the step profile

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
Each path runs with the launch counts set to 0 just before it; the kernels
line reports the sum of the serving and the training path's counts. The
last line is {"ok": true, "device": {...}}; any failure raises, and the
script exits non-zero without it.

--profile times the config2 training step instead of phases 3-6: step
medians with the kernels and with the plain versions in turns (kernels,
plain, plain, kernels), the synchronized time of each part of a step, and
a torch.profiler trace of 5 steps (wall and device-busy time, device
launches per step, the device time of the busiest kernels). It prints no
ok line.
"""

from __future__ import annotations

import dataclasses
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
        flash_gat_attention=ops.flash_gat_attention_plain)


def run_serving(dev, ds) -> dict:
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.serve import Scorer

    cfg = get_config("config2")
    model = BiGNN(cfg.model, seed=SEED)
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
    log(f"  launches on the serving path: {launches}")
    for name, count in launches.items():
        if count <= 0:
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
    from bignn_tpu_torch import ops
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import prepare_device_data
    from bignn_tpu_torch.data.sampler import EdgeMinibatchSampler
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    cfg = get_config("config2")
    data = prepare_device_data(ds)
    sampler = EdgeMinibatchSampler(data.train_pairs, cfg.train.batch_size,
                                   cfg.train.seed)
    batches = [b for _, b in zip(range(TRAIN_STEPS), sampler.epoch(0))]
    kernels = (ops.segment_sum, ops.block_adjacency, ops.flash_gat_attention,
               ops.flash_gat_attention_bwd)
    for k in kernels:
        k.launches = 0
    trainer = Trainer(BiGNN(cfg.model), data, cfg.train, device=dev)
    params0, _ = trainer.init(SEED)
    losses, grads = _timed_steps(trainer, batches, "kernels")
    launches = {k.__name__: k.launches for k in kernels}
    log(f"  launches on the training path: {launches}")
    for name, count in launches.items():
        if count <= 0:
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
        plain = Trainer(BiGNN(cfg.model), data, cfg.train, device=dev)
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
        f"{TRAIN_STEPS}: {plain_losses[0]:.5f} / {plain_losses[-1]:.5f}")
    if not worst <= GRAD_TOL:
        raise AssertionError(f"step-1 gradients off the plain run: {worst}")
    metrics = trainer.evaluate(split="val")
    log(f"  after {TRAIN_STEPS} steps: val AUC {metrics['val_auc']:.4f}, "
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


def profile_training(dev, ds) -> None:
    """Where a config2 training step's time goes (see --profile above)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bignn_tpu_torch import prng
    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import prepare_device_data
    from bignn_tpu_torch.data.sampler import (
        EdgeMinibatchSampler,
        sample_negative_pairs,
    )
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import Trainer

    cfg = get_config("config2")
    data = prepare_device_data(ds)
    sampler = EdgeMinibatchSampler(data.train_pairs, cfg.train.batch_size,
                                   cfg.train.seed)
    batches = [b for _, b in zip(range(TRAIN_STEPS), sampler.epoch(0))]
    trainer = Trainer(BiGNN(cfg.model), data, cfg.train, device=dev)
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
    key = prng.fold_in(prng.fold_in(prng.key(cfg.train.seed + 1), 0), 0)

    def backward():
        trainer.optimizer.zero_grad(set_to_none=True)
        trainer._loss_fn(pos, pmask, key).backward()

    parts = {
        "negatives (host threefry + one upload)": lambda: sample_negative_pairs(
            key, pos, data.num_drugs, cfg.train.neg_ratio),
        "forward + loss": lambda: trainer._loss_fn(pos, pmask, key),
        "forward + loss + backward": backward,
        "optimizer step": trainer.optimizer.step,
    }
    for name, fn in parts.items():
        log(f"  {name}: {_median_ms(fn):.3f} ms (median of 20, synchronized)")

    traced = batches[:5]
    steps = len(traced)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, (pairs, mask) in enumerate(traced):
            trainer.train_step(pairs, mask, 1, i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_ms((e.time_range.start, e.time_range.end) for e in device)
    log(f"  profiled {steps} steps: wall {wall_ms:.3f} ms (profiler on), "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} %), "
        f"{len(device) / steps:.1f} device launches per step")
    per_name: dict[str, list[float]] = {}
    for e in device:
        per_name.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    for name, times in top:
        log(f"    {sum(times) / steps:8.4f} ms/step {len(times) / steps:6.1f}"
            f"/step  {name[:90]}")


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
        log("== profile: config2 training step, full width")
        profile_training(dev, ds)
        return 0

    log("== kernels vs plain (config2 shapes)")
    results = compare_kernels(dev, ds, bucketing, outer)

    log("== serving path: config2 served by Scorer")
    launches = run_serving(dev, ds)
    log("== training path: config2 Trainer, full width")
    trained = run_training(dev, ds)
    launches = {k: launches.get(k, 0) + trained[k] for k in trained}
    log("== config2-real through the kernels")
    run_real_gate(dev)

    sources = {
        "segment_sum": ("bignn_tpu_torch/csrc/segment_sum.cu",
                        "bignn_tpu/ops/pallas/segment.py:58"),
        "block_adjacency": ("bignn_tpu_torch/csrc/block_adj.cu",
                            "bignn_tpu/ops/pallas/block_adj.py:49"),
        "flash_gat_attention": ("bignn_tpu_torch/csrc/flash_gat.cu",
                                "bignn_tpu/ops/pallas/flash_gat.py:65"),
        "flash_gat_attention_bwd": ("bignn_tpu_torch/csrc/flash_gat_bwd.cu",
                                    "bignn_tpu/ops/pallas/flash_gat.py:85"),
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
