"""config4's paired learning run on the port: the registry config4 model
trained through both of ``MinibatchTrainer``'s samplers at one step budget
and seed, the counterpart of ``scripts/validate_config4_learning.py``.

    python scripts/torch_config4_learning.py [--modes device,host]
        [--epochs 4] [--steps-per-epoch 500] [--out FILE] [--device cuda]

Each mode trains ``get_config("config4")`` (bf16 compute over float32
parameters, fanouts (10,), 16,384 drugs a batch's neighbourhood at most,
chunks of 8 steps) on ``load_dataset("synthetic-large")`` (100,000 drugs),
with ``device_sample=True`` (the card's sampler, a ``torch.Generator``) or
``False`` (the host sampler, threefry-seeded NumPy draws), seed 0,
evaluating every epoch. It prints one JSON line an epoch (loss, sampled
val AUC/AP, wall seconds since the trainer was built), then one with the
sampled and the exact (full-propagation, ``evaluate(exact=True)``) val and
test AUC/AP of the best-val parameters. The two modes draw from different
streams, so they are two estimators of one gradient: equivalence means
curves that track and final AUCs within noise, not equal bits.

Imports no JAX. The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run_mode(mode: str, ds, cfg, epochs: int, steps: int, device: str,
             emit) -> dict:
    """Train one mode; ``emit`` each record; returns the final record."""
    from bignn_tpu_torch.models import BiGNN
    from bignn_tpu_torch.train import MinibatchTrainer

    tcfg = dataclasses.replace(cfg.train, epochs=epochs, eval_every=1)
    t0 = time.perf_counter()
    tr = MinibatchTrainer(
        BiGNN(cfg.model), ds, tcfg, fanouts=cfg.fanouts,
        max_drugs=cfg.max_drugs, dispatch_chunk=cfg.dispatch_chunk,
        device_sample=(mode == "device"), device=device)
    emit({"mode": mode, "event": "built",
          "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()

    def log(rec):
        emit({"mode": mode, "step": (rec["epoch"] + 1) * steps,
              "loss": rec["loss"], "val_auc": rec.get("val_auc"),
              "val_ap": rec.get("val_ap"), "epoch_s": rec["epoch_time_s"],
              "wall_s": time.perf_counter() - t0})

    params, result = tr.fit(steps_per_epoch=steps, log_fn=log)
    final = {"mode": mode, "best_epoch": result["best_epoch"],
             "sampled_test_auc": result["test_auc"],
             "sampled_test_ap": result["test_ap"]}
    for split in ("val", "test"):
        t1 = time.perf_counter()
        ex = tr.evaluate(params, split, exact=True)
        final[f"exact_{split}_auc"] = ex[f"{split}_auc"]
        final[f"exact_{split}_ap"] = ex[f"{split}_ap"]
        final[f"exact_{split}_s"] = time.perf_counter() - t1
    final["wall_s"] = time.perf_counter() - t0
    emit(final)
    return final


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--modes", default="device,host",
                   help="comma list of device, host")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--steps-per-epoch", type=int, default=500)
    p.add_argument("--out", default=None, help="also write the lines here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    modes = args.modes.split(",")
    if not set(modes) <= {"device", "host"}:
        raise SystemExit(f"unknown modes {modes}")

    import torch

    from bignn_tpu_torch.config import get_config
    from bignn_tpu_torch.data import load_dataset

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("torch_config4_learning: no CUDA device")
        print(card_line(), flush=True)
        # float32 products in float32, as the JAX reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    try:
        cfg = get_config("config4")
        t0 = time.perf_counter()
        ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
        emit({"event": "dataset", "drugs": ds.num_drugs,
              "edges": int(len(ds.edges)), "wall_s": time.perf_counter() - t0})
        for mode in modes:
            run_mode(mode, ds, cfg, args.epochs, args.steps_per_epoch,
                     args.device, emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
