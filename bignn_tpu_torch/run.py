"""Experiment runner CLI (counterpart of ``bignn_tpu/run.py``).

  python -m bignn_tpu_torch.run --config config1
  python -m bignn_tpu_torch.run --config config2 --epochs 5 --run-dir runs/db
  python -m bignn_tpu_torch.run --config config4 --exact-eval
  python -m bignn_tpu_torch.run --config config5    # p2: 4 graph shards

The config's ``mode`` picks the trainer: ``full`` (``Trainer``),
``minibatch`` (``MinibatchTrainer``) or ``p2`` (``_run_p2``, the
edge-partitioned loop). ``--run-dir`` receives ``metrics.jsonl`` (one record
per epoch or event) and ``result.json``; with ``--checkpoint-every N`` the
full training state goes to ``<run-dir>/ckpt`` every N epochs, and the same
command line resumes from it exactly.

Everything runs on ``--device`` (default ``cuda``): a CUDA device launches
the kernels or raises, and a CPU run must ask for ``--device cpu``.

Where the JAX runner differs:
  * p2 on one card. JAX takes ``graph = min(graph_shards, devices)`` shards
    over its devices, which is 1 on one device. The port names the one
    device ``graph_shards`` times (``make_mesh(dp=1, graph=G, devices=[dev]
    * G)``), so the G shards run in turn on it and every outer layer's halo
    exchange moves real payloads between them, with ``dp`` 1.
  * ``--halo-impl lax|pallas`` parses, and both run the port's one exchange
    (``ops.all_to_all``), with a logged note, so that JAX command lines run.
  * ``--dp``, ``--coordinator``, ``--num-processes`` and ``--process-id``
    raise ``NotImplementedError``: data parallelism and the multi-host run
    are still to port (ROADMAP Queue 1 item 5).
  * No ``--backend``: the tensor's device decides; ``--device`` takes its
    place. ``--profile DIR`` writes a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from bignn_tpu_torch import prng
from bignn_tpu_torch.config import get_config
from bignn_tpu_torch.data import load_dataset, prepare_device_data
from bignn_tpu_torch.models import BiGNN
from bignn_tpu_torch.train import MinibatchTrainer, Trainer
from bignn_tpu_torch.train.checkpoint import CheckpointManager
from bignn_tpu_torch.utils import MetricLogger, profile_trace

_WAITS = "is still to port (ROADMAP Queue 1 item 5)"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="config1")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--run-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="epochs between checkpoints (0 = off)")
    p.add_argument("--graph-shards", type=int, default=None)
    p.add_argument("--dp", type=int, default=None,
                   help=f"data-parallel shards: {_WAITS}")
    p.add_argument("--overlap", action="store_true",
                   help="p2 mode: overlap the halo exchange with the "
                        "interior drugs' inner encode")
    p.add_argument("--halo-impl", default=None, choices=["lax", "pallas"],
                   help="accepted for JAX command lines: both run the "
                        "port's one exchange (ops.all_to_all)")
    p.add_argument("--device-sample", dest="device_sample", default=None,
                   action="store_true",
                   help="minibatch mode: sample on the device. Default "
                        "from the config.")
    p.add_argument("--no-device-sample", dest="device_sample",
                   action="store_false")
    p.add_argument("--remat", action="store_true",
                   help="p2 mode: recompute the inner encode and the outer "
                        "attention temporaries in the backward")
    p.add_argument("--exact-eval", action="store_true",
                   help="minibatch mode: after training, also report final "
                        "val/test metrics by full propagation "
                        "(evaluate(exact=True)), free of the sampled "
                        "estimator")
    p.add_argument("--profile", default=None,
                   help="directory for a torch.profiler trace of the run")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no CPU fallback)")
    p.add_argument("--coordinator", default=None,
                   help=f"multi-host coordinator: {_WAITS}")
    p.add_argument("--num-processes", type=int, default=None,
                   help=f"multi-host process count: {_WAITS}")
    p.add_argument("--process-id", type=int, default=None,
                   help=f"multi-host process index: {_WAITS}")
    args = p.parse_args(argv)

    for flag in ("dp", "coordinator", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: data parallelism and the "
                f"multi-host run {_WAITS}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (a CPU run asks for --device cpu)")

    cfg = get_config(args.config)
    train_over = {
        k: v
        for k, v in dict(epochs=args.epochs, batch_size=args.batch_size,
                         lr=args.lr, seed=args.seed).items()
        if v is not None
    }
    if train_over:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **train_over))
    if args.graph_shards is not None:
        cfg = dataclasses.replace(cfg, graph_shards=args.graph_shards)

    logger = MetricLogger(args.run_dir)
    try:
        result = _run(args, cfg, logger, dev)
    finally:
        logger.close()
    return result


def _run(args, cfg, logger, dev) -> dict:
    """Train ``cfg`` by its mode and write the summary; ``main``'s body."""
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    logger.log({"event": "dataset",
                **{k: str(v) for k, v in ds.stats().items()}})
    model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim),
                  seed=cfg.train.seed)

    ckpt = CheckpointManager(f"{args.run_dir}/ckpt") if (
        args.run_dir and args.checkpoint_every) else None
    fit_kw = dict(log_fn=logger)
    if ckpt is not None:
        fit_kw.update(ckpt=ckpt, checkpoint_every=args.checkpoint_every)
    with profile_trace(args.profile):
        if cfg.mode == "minibatch":
            dev_sample = (cfg.device_sample if args.device_sample is None
                          else args.device_sample)
            trainer = MinibatchTrainer(
                model, ds, cfg.train, fanouts=cfg.fanouts,
                max_drugs=cfg.max_drugs, dispatch_chunk=cfg.dispatch_chunk,
                device_sample=dev_sample, device=dev)
            params, result = trainer.fit(**fit_kw)
            if args.exact_eval:
                for split in ("val", "test"):
                    ex = trainer.evaluate(params, split, exact=True)
                    result.update({f"exact_{k}": v for k, v in ex.items()})
                logger.log({"event": "exact_eval",
                            **{k: v for k, v in result.items()
                               if k.startswith("exact_")}})
        elif cfg.mode == "p2":
            if args.exact_eval:
                logger.log({"event": "note", "msg":
                            "p2 mode evaluates by full propagation already: "
                            "--exact-eval is a no-op outside minibatch mode"})
            if args.halo_impl is not None:
                logger.log({"event": "note", "msg":
                            f"--halo-impl {args.halo_impl}: the port has one "
                            "halo exchange, ops.all_to_all"})
            params, result = _run_p2(
                model, ds, cfg, logger, overlap=args.overlap,
                remat_inner=args.remat, ckpt=ckpt,
                checkpoint_every=args.checkpoint_every or 1, device=dev)
        else:
            data = prepare_device_data(ds, max_buckets=cfg.max_buckets)
            trainer = Trainer(model, data, cfg.train, device=dev)
            params, result = trainer.fit(**fit_kw)

    summary = {k: v for k, v in result.items() if k != "history"}
    logger.log({"event": "done", **summary})
    if args.run_dir:
        with open(f"{args.run_dir}/result.json", "w") as f:
            json.dump(summary, f, indent=2)
    return result


def _run_p2(model, ds, cfg, logger, overlap: bool = False, ckpt=None,
            checkpoint_every: int = 1, remat_inner: bool = False,
            device: str | torch.device = "cuda"):
    """The edge-partitioned training loop of config5 (JAX
    ``run.py:_run_p2``), ``cfg.graph_shards`` shards on ``device``; returns
    ``(best_params, result)``.

    The trainers' semantics: the parameters of the best val AUC are kept
    and give the final test metrics, and ``ckpt`` saves the full state
    every ``checkpoint_every`` epochs. The epoch shuffle
    (``EdgeMinibatchSampler``, seeded by (seed, epoch)) and every step's
    negatives (``fold_in(fold_in(key(seed + 1), epoch), step)``) are pure
    functions of the epoch and step, so a resumed run repeats the
    uninterrupted one. Evaluation scores the split's positives and one
    negative each from ``key(1234)``, padded to ``dp`` with a mask, by the
    distributed forward; AUC and AP are computed on the device."""
    from bignn_tpu_torch.data.sampler import (
        EdgeMinibatchSampler,
        sample_negative_pairs,
    )
    from bignn_tpu_torch.parallel import (
        build_outer_partition,
        build_sharded_inner,
        device_put_plan,
        make_mesh,
        make_p2_score_fn,
        make_p2_train_step,
    )
    from bignn_tpu_torch.train.metrics import (
        average_precision_torch,
        roc_auc_torch,
    )
    from bignn_tpu_torch.train.trainer import (
        _fit_state,
        _restore_fit_state,
        make_optimizer,
    )

    if cfg.train.grad_clip:
        raise ValueError("the p2 step does not clip gradients: grad_clip "
                         "must be 0")
    dev = torch.device(device)
    graph = int(cfg.graph_shards)
    mesh = make_mesh(dp=1, graph=graph, devices=[dev] * graph)
    dp = mesh.shape["dp"]
    logger.log({"event": "mesh", "dp": dp, "graph": graph, "processes": 1})

    train_edges = ds.split_edges("train")
    plan = build_outer_partition(train_edges[:, 0], train_edges[:, 1],
                                 ds.num_drugs, graph)
    logger.log({"event": "partition",
                **{k: str(v) for k, v in plan.stats().items()}})
    inner = build_sharded_inner(ds.molecules, plan, split_boundary=overlap)
    model.to(dev)
    model.load_state_dict(model.init_params(cfg.train.seed))
    optimizer = make_optimizer(model.parameters(), cfg.train)
    step = make_p2_train_step(model, optimizer, mesh, ds.num_drugs,
                              cfg.train.neg_ratio, overlap=overlap,
                              remat=remat_inner)
    plan_d = device_put_plan(mesh, plan, inner, model.config.inner_layers)
    sampler = EdgeMinibatchSampler(train_edges.astype(np.int32),
                                   cfg.train.batch_size, cfg.train.seed)
    base_key = prng.key(cfg.train.seed + 1)
    score_fn = make_p2_score_fn(model, mesh, overlap=overlap)

    def params():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def evaluate(eval_params, split: str) -> dict:
        if eval_params is not None:
            model.load_state_dict(eval_params)
        pos = torch.as_tensor(ds.split_edges(split).astype(np.int32),
                              device=dev)
        neg = sample_negative_pairs(prng.key(1234), pos, ds.num_drugs, 1)
        n = len(pos) + len(neg)
        pad = (-n) % dp  # the pairs split over dp
        pairs = torch.cat([pos, neg, pos.new_zeros((pad, 2))])
        labels = torch.cat([torch.ones(len(pos), device=dev),
                            torch.zeros(len(neg) + pad, device=dev)])
        mask = torch.cat([torch.ones(n, device=dev),
                          torch.zeros(pad, device=dev)])
        scores = score_fn(pairs, plan_d)
        return {f"{split}_auc": float(roc_auc_torch(labels, scores, mask)),
                f"{split}_ap": float(average_precision_torch(labels, scores,
                                                             mask))}

    history = []
    best = {"val_auc": -1.0, "params": params(), "epoch": -1}
    start_epoch = 0
    restored = _restore_fit_state(ckpt)
    if restored is not None:
        state, opt_state, best, start_epoch = restored
        model.load_state_dict(state)
        optimizer.load_state_dict(opt_state)
    epochs = cfg.train.epochs
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        ekey = prng.fold_in(base_key, epoch)
        losses = [step(prng.fold_in(ekey, i), pairs, mask, plan_d)
                  for i, (pairs, mask) in enumerate(sampler.epoch(epoch))]
        rec = {"epoch": epoch, "loss": float(torch.stack(losses).mean()),
               "epoch_time_s": time.perf_counter() - t0}
        if (epoch + 1) % cfg.train.eval_every == 0 or epoch == epochs - 1:
            rec.update(evaluate(None, "val"))
            if rec["val_auc"] > best["val_auc"]:
                best = {"val_auc": rec["val_auc"], "params": params(),
                        "epoch": epoch}
        history.append(rec)
        logger.log(rec)
        if ckpt is not None and (epoch + 1) % checkpoint_every == 0:
            ckpt.save_state(epoch, _fit_state(
                params(), optimizer.state_dict(), best, epoch))
    final = evaluate(best["params"], "test")
    return best["params"], {
        "history": history,
        # a resume of a finished run trains no epoch
        "final_loss": history[-1]["loss"] if history else None,
        "best_epoch": best["epoch"], **final}


if __name__ == "__main__":
    main()
