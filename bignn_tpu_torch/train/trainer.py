"""Full-graph training (counterpart of ``bignn_tpu/train/trainer.py``,
``make_optimizer`` and ``Trainer``).

One step covers negative sampling, the full bi-level forward, the masked
BCE loss, the backward through the port's kernels, and an Adam update.
The epoch loop, evaluation and best-by-val-AUC selection mirror the JAX
``Trainer.fit``. Parameters are state dicts and the optimizer state is
``optimizer.state_dict()``, where the JAX package passes pytrees.

Every random draw is the JAX package's, from the same threefry keys
(``prng.py``), so a seed names the same experiment in both packages and on
every device: ``init`` gives ``BiGNN.init(jax.random.key(seed))``, the
epoch shuffle is NumPy's, seeded by (seed, epoch), and a step's negatives
come from ``fold_in(fold_in(key(seed + 1), epoch), step)`` (JAX
``trainer.py:203-217``), drawn on the host and uploaded in one copy;
evaluation negatives come from ``key(neg_seed)``. A resumed run therefore
repeats the uninterrupted one.
Still to port: the data-parallel ``mesh`` (ROADMAP Queue 1 item 5) and
``MinibatchTrainer`` (item 3).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from bignn_tpu_torch import prng
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data.sampler import (
    EdgeMinibatchSampler,
    sample_negative_pairs,
)
from bignn_tpu_torch.data.schema import DeviceData
from bignn_tpu_torch.models.bignn import BiGNN, upload_buckets
from bignn_tpu_torch.models.loss import bce_with_logits_loss
from bignn_tpu_torch.train.metrics import (
    average_precision,
    average_precision_torch,
    roc_auc,
    roc_auc_torch,
)


def make_optimizer(params, config: TrainConfig) -> torch.optim.Optimizer:
    """Adam, or AdamW (decoupled decay, as optax.adamw) when
    ``config.weight_decay``; ``Trainer`` clips the global gradient norm
    first when ``config.grad_clip``."""
    if config.weight_decay:
        return torch.optim.AdamW(params, lr=config.lr,
                                 weight_decay=config.weight_decay)
    return torch.optim.Adam(params, lr=config.lr)


class Trainer:
    """Single-device full-graph trainer on ``device`` (no CPU fallback).

    The buckets go to the device with their block adjacency built there
    (``upload_buckets``); the outer graph and its dense masks are uploaded
    as built on the host."""

    def __init__(self, model: BiGNN, data: DeviceData, config: TrainConfig,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.data = data
        self.config = config
        self.optimizer = make_optimizer(self.model.parameters(), config)
        self.buckets, self.graph_index = upload_buckets(
            data.bucketing, model.config.inner_layers, self.device)
        self.outer = data.outer.to(self.device)

    # -- one step ----------------------------------------------------------
    def _loss_fn(self, pos_pairs: torch.Tensor, pos_mask: torch.Tensor,
                 key: prng.Key) -> torch.Tensor:
        r = self.config.neg_ratio
        neg = sample_negative_pairs(key, pos_pairs, self.data.num_drugs, r)
        pairs = torch.cat([pos_pairs, neg])
        labels = torch.cat([torch.ones(len(pos_pairs), device=self.device),
                            torch.zeros(len(neg), device=self.device)])
        mask = torch.cat([pos_mask, pos_mask.repeat(r)])
        logits = self.model(self.buckets, self.graph_index, self.outer, pairs)
        return bce_with_logits_loss(logits, labels, mask)

    def _step(self, pos_pairs, pos_mask, key: prng.Key) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss_fn(pos_pairs, pos_mask, key)
        loss.backward()
        if self.config.grad_clip:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                           self.config.grad_clip)
        self.optimizer.step()
        return loss.detach()

    def train_step(self, pairs: np.ndarray, mask: np.ndarray, epoch: int,
                   step: int) -> torch.Tensor:
        """One optimizer step on a host batch of positives (``[B, 2]``
        pairs, ``[B]`` mask); negatives are drawn for (epoch, step). Returns
        the loss as a device scalar (no synchronization). The gradients
        stay in ``param.grad`` until the next step."""
        key = prng.fold_in(
            prng.fold_in(prng.key(self.config.seed + 1), epoch), step)
        return self._step(torch.as_tensor(pairs, device=self.device),
                          torch.as_tensor(mask, device=self.device), key)

    # -- parameters and evaluation ------------------------------------------
    def params(self) -> dict[str, torch.Tensor]:
        """A copy of the model's current state dict."""
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def init(self, seed: int | None = None):
        """The JAX package's initial parameters for ``seed`` (default
        ``config.seed``) and a fresh optimizer; returns ``(params,
        opt_state)``."""
        seed = self.config.seed if seed is None else seed
        self.model.load_state_dict(self.model.init_params(seed))
        self.optimizer = make_optimizer(self.model.parameters(), self.config)
        return self.params(), self.optimizer.state_dict()

    def evaluate(self, params=None, split: str = "val", neg_seed: int = 1234,
                 on_device: bool = False) -> dict:
        """Score held-out positives and as many negatives, one corrupted
        endpoint each, drawn from ``key(neg_seed)`` as the JAX ``Trainer``
        draws them. ``params`` (a state dict) is loaded first when given.
        ``on_device`` computes the sort-based AUC/AP in torch where the
        scores are; the default takes the exact tie-aware host versions."""
        if params is not None:
            self.model.load_state_dict(params)
        pos = {"val": self.data.val_pairs, "test": self.data.test_pairs,
               "train": self.data.train_pairs}[split]
        pos = torch.as_tensor(pos, device=self.device)
        neg = sample_negative_pairs(prng.key(neg_seed), pos,
                                    self.data.num_drugs, 1)
        pairs = torch.cat([pos, neg])
        labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        with torch.no_grad():
            scores = self.model(self.buckets, self.graph_index, self.outer,
                                pairs)
        if on_device:
            lab = torch.as_tensor(labels, device=self.device)
            return {f"{split}_auc": float(roc_auc_torch(lab, scores)),
                    f"{split}_ap": float(average_precision_torch(lab, scores))}
        scores = scores.cpu().numpy()
        return {f"{split}_auc": roc_auc(labels, scores),
                f"{split}_ap": average_precision(labels, scores)}

    # -- the run -------------------------------------------------------------
    def fit(self, params=None, opt_state=None,
            log_fn: Callable[[dict], None] | None = None, ckpt=None,
            checkpoint_every: int = 1) -> tuple[Any, dict]:
        """Full training run; returns ``(best_params, result)``, with
        ``result`` holding ``history``, ``best_epoch`` and the test metrics
        of the best parameters, which the model holds at the end.

        ``params``/``opt_state`` start from a given state (default:
        ``init()``). ``ckpt`` (a ``train.checkpoint.CheckpointManager``)
        saves the full state every ``checkpoint_every`` epochs and resumes
        from its latest one; ``history`` then covers only the epochs run
        here."""
        cfg = self.config
        if params is None:
            self.init()
        else:
            self.model.load_state_dict(params)
            self.optimizer = make_optimizer(self.model.parameters(), cfg)
            if opt_state is not None:
                self.optimizer.load_state_dict(opt_state)
        sampler = EdgeMinibatchSampler(self.data.train_pairs, cfg.batch_size,
                                       cfg.seed)
        best = {"val_auc": -1.0, "params": self.params(), "epoch": -1}
        start_epoch = 0
        if ckpt is not None:
            restored = ckpt.restore_state()
            if restored is not None:
                params, opt_state, best, start_epoch = _unpack_fit_state(
                    restored)
                self.model.load_state_dict(params)
                self.optimizer.load_state_dict(opt_state)
        history = []
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            losses = [self.train_step(pairs, mask, epoch, i)
                      for i, (pairs, mask) in enumerate(sampler.epoch(epoch))]
            rec = {"epoch": epoch, "loss": float(torch.stack(losses).mean()),
                   "epoch_time_s": time.perf_counter() - t0}
            if (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1:
                rec.update(self.evaluate(split="val"))
                if rec["val_auc"] > best["val_auc"]:
                    best = {"val_auc": rec["val_auc"],
                            "params": self.params(), "epoch": epoch}
            history.append(rec)
            if log_fn:
                log_fn(rec)
            if ckpt is not None and (epoch + 1) % checkpoint_every == 0:
                ckpt.save_state(epoch, _fit_state(
                    self.params(), self.optimizer.state_dict(), best, epoch))
        final = self.evaluate(best["params"], "test")
        return best["params"], {"history": history,
                                "best_epoch": best["epoch"], **final}


def _fit_state(params, opt_state, best, epoch: int = 0) -> dict:
    """The full training state that a checkpoint holds."""
    return {
        "params": params,
        "opt_state": opt_state,
        "best_params": best["params"],
        "meta": {"epoch": epoch, "best_val_auc": float(best["val_auc"]),
                 "best_epoch": int(best["epoch"])},
    }


def _unpack_fit_state(state: dict):
    best = {"val_auc": float(state["meta"]["best_val_auc"]),
            "params": state["best_params"],
            "epoch": int(state["meta"]["best_epoch"])}
    return (state["params"], state["opt_state"], best,
            int(state["meta"]["epoch"]) + 1)
