"""Full-graph training (counterpart of ``bignn_tpu/train/trainer.py``,
``make_optimizer`` and ``Trainer``).

One step covers negative sampling, the full bi-level forward, the masked
BCE loss, the backward through the port's kernels, and an Adam update.
The epoch loop, evaluation and best-by-val-AUC selection mirror the JAX
``Trainer.fit``. Parameters are state dicts and the optimizer state is
Adam's keyed by parameter name (``optimizer_state``), where the JAX package
passes pytrees.

Every random draw is the JAX package's, from the same threefry keys
(``prng.py``), so a seed names the same experiment in both packages and on
every device: ``init`` gives ``BiGNN.init(jax.random.key(seed))``, the
epoch shuffle is NumPy's, seeded by (seed, epoch), and a step's negatives
come from ``fold_in(fold_in(key(seed + 1), epoch), step)`` (JAX
``trainer.py:203-217``), drawn on the host and uploaded in one copy;
evaluation negatives come from ``key(neg_seed)``. A resumed run therefore
repeats the uninterrupted one.

``MinibatchTrainer`` is the hierarchical minibatch trainer of configs 3-4:
each step trains on a sampled neighbourhood of its pair batch, drawn on the
host (``data/hierarchical.py``) or on the card (``data/device_sampler.py``),
and expanded on the card from molecule tables uploaded once, or (with
``resident=False``) drawn whole on the host and uploaded each step. Its
exact evaluation encodes every molecule and propagates over the whole train
graph, with no sampling.

Both trainers take a dp-only ``mesh`` (``parallel/mesh.py``, which may
name one card several times, or lie over distinct cards): the pair batch
splits over ``dp`` and the update equals the single-device one on the
whole batch (``parallel/dp.py``; the minibatch trainer draws one batch a
shard and steps on their union). Over distinct cards each card holds a
replica of the model and optimizer (``parallel/replicas.py``) and its
shards' work; the trainer's ``model`` and ``optimizer`` are replica 0 on
the first card, where evaluation runs as one stream and which checkpoints
hold.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from bignn_tpu_torch import ops, prng
from bignn_tpu_torch.config import TrainConfig
from bignn_tpu_torch.data.device_sampler import DeviceSampler
from bignn_tpu_torch.data.hierarchical import (
    CompactBatch,
    HierarchicalBatch,
    HierarchicalSampler,
    MoleculeTables,
)
from bignn_tpu_torch.data.prefetch import ParallelPrefetcher
from bignn_tpu_torch.data.sampler import (
    EdgeMinibatchSampler,
    sample_negative_pairs,
)
from bignn_tpu_torch.data.schema import DDIDataset, DeviceData
from bignn_tpu_torch.models.bignn import BiGNN, upload_buckets
from bignn_tpu_torch.models.loss import masked_sums
from bignn_tpu_torch.parallel.dp import (
    PerReplica,
    dp_size,
    dp_train_step_fn,
    replica_layout,
    union_over_replicas,
)
from bignn_tpu_torch.parallel.mesh import make_mesh
from bignn_tpu_torch.parallel.replicas import Replicas
from bignn_tpu_torch.sparse.formats import (
    OuterGraph,
    PaddedGraphBatch,
    build_outer_graph,
)
from bignn_tpu_torch.train.metrics import (
    average_precision,
    average_precision_torch,
    roc_auc,
    roc_auc_torch,
)


def make_optimizer(params, config: TrainConfig) -> torch.optim.Optimizer:
    """Adam, or AdamW (decoupled decay, as optax.adamw) when
    ``config.weight_decay``; the trainers' steps clip the global gradient
    norm first when ``config.grad_clip`` (``Replicas.step``)."""
    if config.weight_decay:
        return torch.optim.AdamW(params, lr=config.lr,
                                 weight_decay=config.weight_decay)
    return torch.optim.Adam(params, lr=config.lr)


def _device(device, mesh) -> torch.device:
    """The trainer's device: ``mesh.first_device`` under a mesh (a
    ``device`` that names another raises), else ``device`` (default
    ``cuda``)."""
    if mesh is None:
        return torch.device("cuda" if device is None else device)
    dev = mesh.first_device
    if device is not None:
        want = torch.device(device)
        if (want.type, want.index or 0) != (dev.type, dev.index or 0):
            raise ValueError(f"device {want} is not the mesh's device {dev}")
    return dev


class Trainer:
    """Full-graph trainer on ``device`` (no CPU fallback).

    The buckets go to the device with their block adjacency built there
    (``upload_buckets``); the outer graph and its dense masks are uploaded
    as built on the host. Every step is ``parallel/dp.py``'s
    ``dp_train_step_fn`` on ``mesh`` (dp-only; default one shard on
    ``device``): the pairs split over ``dp``, the encode and the outer
    propagation run once, and the trajectory equals the one without a mesh
    (JAX ``tests/test_dp.py``)."""

    def __init__(self, model: BiGNN, data: DeviceData, config: TrainConfig,
                 device: str | torch.device | None = None, mesh=None):
        dp = 1 if mesh is None else dp_size(mesh)
        if config.batch_size % dp:
            raise ValueError(f"batch_size {config.batch_size} not "
                             f"divisible by dp={dp}")
        self.device = _device(device, mesh)
        self.mesh = (make_mesh(dp=1, devices=[self.device]) if mesh is None
                     else mesh)
        self.model = model.to(self.device)
        self.data = data
        self.config = config
        self._set_optimizer()
        self.buckets, self.graph_index = upload_buckets(
            data.bucketing, model.config.inner_layers, self.device)
        self.outer = data.outer.to(self.device)

    # -- one step ----------------------------------------------------------
    def _set_optimizer(self, opt_state=None) -> None:
        """A fresh optimizer (loaded from ``opt_state`` when given) and the
        step that updates through it."""
        self.optimizer = make_optimizer(self.model.parameters(), self.config)
        if opt_state is not None:
            load_optimizer_state(self.optimizer, self.model, opt_state)
        self._step = dp_train_step_fn(
            self.model, self.optimizer, self.mesh, self.data.num_drugs,
            self.config.neg_ratio, self.config.grad_clip)

    def train_step(self, pairs: np.ndarray, mask: np.ndarray, epoch: int,
                   step: int) -> torch.Tensor:
        """One optimizer step on a host batch of positives (``[B, 2]``
        pairs, ``[B]`` mask); negatives are drawn for (epoch, step). Returns
        the loss as a device scalar (no synchronization). The gradients
        stay in ``param.grad`` until the next step."""
        key = prng.fold_in(
            prng.fold_in(prng.key(self.config.seed + 1), epoch), step)
        return self._step(key, pairs, mask, self.buckets, self.graph_index,
                          self.outer)

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
        self._set_optimizer()
        return self.params(), optimizer_state(self.optimizer, self.model)

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
            self._set_optimizer(opt_state)
        sampler = EdgeMinibatchSampler(self.data.train_pairs, cfg.batch_size,
                                       cfg.seed)
        best = {"val_auc": -1.0, "params": self.params(), "epoch": -1}
        start_epoch = 0
        restored = _restore_fit_state(ckpt)
        if restored is not None:
            params, opt_state, best, start_epoch = restored
            self.model.load_state_dict(params)
            load_optimizer_state(self.optimizer, self.model, opt_state)
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
                    self.params(), optimizer_state(self.optimizer,
                                                   self.model), best, epoch))
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


def _restore_fit_state(ckpt):
    """``_unpack_fit_state`` of ``ckpt``'s latest state, or None when there
    is no manager or nothing saved. A state without optimizer state (one
    written by hand, say) serves but cannot resume: Adam would restart from
    zero moments."""
    state = None if ckpt is None else ckpt.restore_state()
    if state is None:
        return None
    if state.get("opt_state") is None:
        raise ValueError(
            f"checkpoint in {ckpt.directory} has no optimizer state: it can "
            "be served (Scorer.from_checkpoint) but not resumed")
    return _unpack_fit_state(state)


def _check_optimizer(optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module) -> dict:
    """``model``'s named parameters, which must be ``optimizer``'s in
    order."""
    params = dict(model.named_parameters())
    if [id(p) for p in params.values()] != [
            id(p) for g in optimizer.param_groups for p in g["params"]]:
        raise ValueError("the optimizer's parameters are not the model's, "
                         "in order")
    return params


def optimizer_state(optimizer: torch.optim.Optimizer,
                    model: torch.nn.Module) -> dict:
    """``optimizer``'s Adam state keyed by the parameter's name, the one
    layout that checkpoints hold (``scripts/convert_jax_checkpoint.py``
    writes it from optax's): ``{name: {"step", "exp_avg",
    "exp_avg_sq"}}`` for every parameter of ``model``, in order. A
    parameter that no step has updated yet gets Adam's initial state (step
    0, zero moments), which loads as no state at all would."""
    state = {}
    for name, p in _check_optimizer(optimizer, model).items():
        s = optimizer.state.get(p)
        if not s:
            s = {"step": 0.0, "exp_avg": torch.zeros_like(p),
                 "exp_avg_sq": torch.zeros_like(p)}
        state[name] = {"step": torch.tensor(float(s["step"]),
                                            dtype=torch.float32),
                       "exp_avg": s["exp_avg"],
                       "exp_avg_sq": s["exp_avg_sq"]}
    return state


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, opt_state: dict) -> None:
    """Load ``opt_state`` (``optimizer_state``'s layout) into
    ``optimizer``, whose parameters are ``model.parameters()`` in order,
    under the optimizer's own hyperparameters (the config's). A name
    missing from either side or a shape that differs raises.
    ``load_state_dict`` moves the moments to each parameter's device; each
    parameter gets its own float32 ``step``."""
    params = _check_optimizer(optimizer, model)
    if opt_state.keys() != params.keys():
        raise ValueError(
            f"optimizer state names {sorted(opt_state.keys() ^ params.keys())}"
            " not both in the state and in the model")
    state = {}
    for i, (name, p) in enumerate(params.items()):
        s = opt_state[name]
        for k in ("exp_avg", "exp_avg_sq"):
            if s[k].shape != p.shape:
                raise ValueError(f"{k} of {name} is {tuple(s[k].shape)}, "
                                 f"the parameter {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(float(s["step"]),
                                         dtype=torch.float32),
                    "exp_avg": s["exp_avg"], "exp_avg_sq": s["exp_avg_sq"]}
    optimizer.load_state_dict({**optimizer.state_dict(), "state": state})


class MinibatchTrainer:
    """Hierarchical minibatch trainer (counterpart of the JAX
    ``MinibatchTrainer``, ``bignn_tpu/train/trainer.py:262-1169``; configs
    3-4), on ``device`` (no CPU fallback).

    Each step trains on the sampled L-hop neighbourhood of its pair batch
    with static shapes. With ``resident`` (the default) the per-molecule
    tables go to the device once (the feature table in bf16 for a bf16
    model); a step ships only an index-sized ``CompactBatch``, drawn on the
    host (``sample_compact_at``, prefetched on threads) or, with
    ``device_sample``, on the card (``DeviceSampler``), and
    ``_expand_compact`` builds the padded batch there: with int8 (or int16)
    block counts when every molecule fits a 128-row block, else the edge
    list and its source-sort arrays for the streaming convs (molecules over
    128 atoms). Without ``resident`` each step uploads a whole host-built
    ``HierarchicalBatch`` (``sample``/``sample_at``), which carries no block
    fields and streams through ``ops.spmm_sorted_coo``. Parameters stay
    float32 (the model casts them to its compute type); the optimizer is
    ``make_optimizer``'s Adam.

    ``evaluate(exact=True)``, ``embed_all_exact`` and ``score_exact``
    evaluate without sampling: every molecule encoded in fixed chunks, one
    outer pass over the whole train graph, as one replicated stream under
    a mesh too. ``mesh`` (dp-only; JAX ``trainer.py:280-313``, ``716-885``)
    makes each step draw ``dp`` batches, shard ``s`` of step ``i`` the
    batch ``(epoch, i * dp + s)`` on the host or on the card, and take one
    update on their union: the shards' (masked loss sum, mask count) pairs
    added in shard order (``parallel/dp.py``); an epoch is then
    ``ceil(len(sampler) / dp)`` steps. Over distinct cards each shard's
    batch is drawn on (or goes up to) its card, where its card's replica
    expands and trains on it with that card's copy of the tables (the
    device sampler keys its generators by device).
    ``device_sample`` needs resident
    tables and a block-local layout, as in JAX. JAX's
    ``optimization_barrier`` fences have no counterpart: PyTorch runs each
    op as written.
    """

    def __init__(self, model: BiGNN, ds: DDIDataset, config: TrainConfig,
                 fanouts: tuple[int, ...] = (10,),
                 max_drugs: int | None = None, resident: bool = True,
                 calibrate_caps: int = 8, mesh=None,
                 prefetch_workers: int = 2, dispatch_chunk: int = 1,
                 device_sample: bool = False,
                 device: str | torch.device | None = None):
        self.mesh = mesh
        self.dp = 1 if mesh is None else dp_size(mesh)
        if device_sample and not resident:
            raise ValueError("device_sample requires resident tables")
        self.device = _device(device, mesh)
        self.model = model.to(self.device)
        self.ds = ds
        self.config = config
        self.resident = bool(resident)
        self.prefetch_workers = prefetch_workers
        self.dispatch_chunk = int(dispatch_chunk)
        self.device_sample = bool(device_sample)
        self.setup_seconds: dict[str, float] = {}
        kinds = {spec.split(":")[0] for spec in model.config.inner_layers}
        t0 = time.perf_counter()
        # superrow-quantized tables put masked padding between molecules,
        # which every inner conv takes on the block-dense path (the sampler
        # quantizes only a block-local layout)
        self.sampler = HierarchicalSampler(
            ds, batch_size=config.batch_size, neg_ratio=config.neg_ratio,
            fanouts=fanouts, seed=config.seed, max_drugs=max_drugs,
            calibrate_caps=calibrate_caps,
            quantize=kinds <= {"gin", "gcn", "gat", "dotattn"})
        self.setup_seconds["host_sampler"] = time.perf_counter() - t0
        self.optimizer = make_optimizer(self.model.parameters(), config)
        t0 = time.perf_counter()
        self.tables = self._upload_tables() if resident else None
        if device_sample:
            t1 = time.perf_counter()
            self.dsampler = DeviceSampler(self.sampler)
            self.setup_seconds["device_sampler"] = time.perf_counter() - t1
            # epoch 0's constants: an opt-in reshuffle derives epoch e's
            # adjacency from them, a pure function of (seed, epoch)
            self._dev_consts0 = self.dsampler.constants().to(self.device)
            self._dev_consts = self._dev_consts0
        # each card's replica (one on one card), and its copies of the
        # tables and sampler constants (slot 0: the trainer's own)
        self._slots, self._slot_of = (
            replica_layout(mesh) if mesh is not None
            else ([self.device], [0] * self.dp))
        self._reps: Replicas | None = None
        self._copies: PerReplica | None = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_seconds["upload"] = (
            time.perf_counter() - t0
            - self.setup_seconds.get("device_sampler", 0.0))
        self._warned_ncap = False
        # exact evaluation: a non-resident trainer's tables, built at its
        # first call (self.tables stays None: the training route reads it),
        # and the whole train graph
        self._exact_tables: MoleculeTables | None = None
        self._full_outer_cached: OuterGraph | None = None

    def resident_bytes(self) -> dict[str, int]:
        """Bytes of the device-resident tables and sampler constants."""
        out = {} if self.tables is None else {
            f"tables.{f.name}": getattr(self.tables, f.name).nbytes
            for f in dataclasses.fields(self.tables)
            if isinstance(getattr(self.tables, f.name), torch.Tensor)}
        if self.device_sample:
            out.update({f"sampler.{name}": t.nbytes for name, t in
                        zip(self._dev_consts._fields, self._dev_consts)})
        return out

    # -- device-side ragged expansion ----------------------------------------
    @staticmethod
    def _rank_slots(cum: torch.Tensor, length: int) -> torch.Tensor:
        """``slot[p] = #{d : cum[d] <= p}`` (``searchsorted(cum, p,
        'right')``) for p in [0, length), as a scatter-add and one cumsum."""
        ind = torch.zeros(length + 1, dtype=torch.int64, device=cum.device)
        ind.index_add_(0, torch.clamp(cum, max=length),
                       torch.ones_like(cum))
        return torch.cumsum(ind[:length], 0)

    def _expand_compact(self, cb: CompactBatch,
                        tb: MoleculeTables) -> PaddedGraphBatch:
        """CompactBatch (indices) -> PaddedGraphBatch, on the device, with
        static shapes (``trainer.py:413-627``): each sampled molecule's rows
        are located by a cumsum and a rank pass; the features and the packed
        edge fields come in superrows (``r_node`` rows, ``r_edge`` edges);
        per-molecule edges are pre-sorted by local dst, so the batch's edge
        list is dst-sorted up to masked padding.

        Block-local (every molecule <= 128 atoms): molecules sit at the
        host's packing offsets, and the block counts are built by
        ``ops.block_adjacency`` in int8 (int16 when ``r_node**2 > 127``: a
        superrow pair of molecules holds at most ``r_node**2`` edges between
        two rows). Otherwise molecules are packed one after another (a
        cumsum of their sizes), the source-sort arrays come from packed
        columns 3-4, and the batch has no block fields: the convs stream."""
        D, NC, EC = cb.drug_budget, cb.node_cap, cb.edge_cap
        s = self.sampler
        r_n, r_e = s.r_node, s.r_edge
        ncs, ecs = NC // r_n, EC // r_e
        dev = cb.nodes.device
        i64 = torch.int64

        def rep(x, r):  # a per-superrow value to per-row
            return x if r == 1 else x[:, None].expand(-1, r).reshape(-1)

        def take(t, idx):  # jnp.take(..., mode="clip")
            return t[torch.clamp(idx, 0, t.shape[0] - 1)]

        def arange(n):
            return torch.arange(n, dtype=i64, device=dev)

        nodes = cb.nodes.long()
        slot_valid = arange(D) < cb.n_real
        qstart = take(tb.mol_ptr, nodes)  # quantized row offsets
        n_q = torch.where(slot_valid, take(tb.mol_ptr, nodes + 1) - qstart, 0)
        n_x = torch.where(slot_valid, take(tb.mol_ncnt, nodes).long(), 0)
        if s.block_local:  # the host's packing: no molecule straddles
            off = cb.pack_off.long()
        else:  # one after another
            off = torch.cumsum(n_q, 0) - n_q
        # slot of each node superrow (empty slots rank to ncs, masked below)
        off_eff = torch.where(n_q > 0, off // r_n, ncs)
        slot_s = torch.clamp(self._rank_slots(off_eff, ncs) - 1, min=0)
        slot_sc = torch.clamp(slot_s, max=D - 1)
        nrow = torch.stack([off, n_x, qstart], 1)[slot_sc]  # [ncs, 3]
        sr_idx = nrow[:, 2] // r_n + (arange(ncs) - nrow[:, 0] // r_n)
        feat_s = take(tb.feat, sr_idx)  # superrow gather
        f = tb.feat.shape[1] // r_n
        local_row = arange(NC) - rep(nrow[:, 0], r_n)
        row_valid = (local_row >= 0) & (local_row < rep(nrow[:, 1], r_n))
        node_feat = torch.where(row_valid[:, None], feat_s.reshape(NC, f), 0)
        graph_ids = torch.where(row_valid, rep(slot_sc, r_n), D).int()

        qe = take(tb.mol_eptr, nodes)
        e_q = torch.where(slot_valid, take(tb.mol_eptr, nodes + 1) - qe, 0)
        e_x = torch.where(slot_valid, take(tb.mol_ecnt, nodes).long(), 0)
        zero = torch.zeros(1, dtype=i64, device=dev)
        ecum0 = torch.cat([zero, torch.cumsum(e_q, 0)])  # [D+1]
        eslot_s = self._rank_slots(ecum0[1:] // r_e, ecs)  # [ecs] in [0, D]
        # per-slot side table, one superrow-granular row gather; row D (tail
        # padding) is read only by masked outputs
        erow = take(torch.stack([torch.cat([off, zero]),
                                 torch.cat([qe, zero]), ecum0,
                                 torch.cat([e_x, zero])], 1), eslot_s)
        esr_idx = erow[:, 1] // r_e + (arange(ecs) - erow[:, 2] // r_e)
        # superrows are field-major ([r_e src][r_e dst]...): a field is a
        # contiguous slice of each gathered row
        pf = take(tb.edge_packed, esr_idx).view(ecs, 8, r_e)

        def col(j):
            return pf[:, j, :].reshape(EC)

        node_off = rep(erow[:, 0], r_e)
        evalid = (arange(EC) - rep(erow[:, 2], r_e)) < rep(erow[:, 3], r_e)
        edge_src = torch.where(evalid, col(0) + node_off, 0).int()
        edge_dst = torch.where(evalid, col(1) + node_off, NC).int()
        edge_w = torch.where(evalid, col(2).view(torch.float32), 0.0)
        batch = dict(node_feat=node_feat, node_mask=row_valid.float(),
                     edge_src=edge_src, edge_dst=edge_dst, edge_weight=edge_w,
                     graph_ids=graph_ids, graph_n_nodes=n_x.float(),
                     num_graphs=D, node_cap=NC, edge_cap=EC)
        if not s.block_local:
            # the source-sort permutation from the per-molecule tables: a
            # molecule's edges, at its batch edge offset, in local source
            # order, enumerate the real edges in global source order;
            # padding positions map to themselves with id NC (dropped)
            return PaddedGraphBatch(
                **batch,
                edge_src_perm=torch.where(
                    evalid, rep(erow[:, 2], r_e) + col(3), arange(EC)).int(),
                edge_src_sorted=torch.where(evalid, col(4) + node_off,
                                            NC).int())
        # block edge ranges: block b's molecules start at slot
        # block_slot0[b], so estarts[b] = ecum0[block_slot0[b]]
        estarts = take(ecum0, cb.block_slot0.long()).int()
        kinds = {sp.split(":")[0] for sp in self.model.config.inner_layers}
        cnt = adj = None
        if kinds & {"gin", "gat", "dotattn"}:
            cnt = ops.block_adjacency(
                edge_src, edge_dst, None, estarts, NC,
                torch.int8 if r_n * r_n <= 127 else torch.int16)
        if "gcn" in kinds:
            adj = ops.block_adjacency(edge_src, edge_dst, edge_w, estarts, NC,
                                      self.model.compute_dtype)
        return PaddedGraphBatch(
            **batch, block_estarts=estarts,
            block_adj=adj if adj is not None else cnt,
            block_cnt=cnt if cnt is not None else adj)

    # -- one step ------------------------------------------------------------
    def _derive_outer(self, hb: CompactBatch,
                      tables: MoleculeTables | None = None) -> OuterGraph:
        """The outer subgraph of a batch, with what a CompactBatch does not
        ship derived on the device: GCN weights from the resident
        ``inv_sqrt_deg`` table (``tables``, default the trainer's), and
        (host-drawn batches) the source-sort permutation by a stable sort,
        equal to the host's."""
        tables = self.tables if tables is None else tables
        osrc = hb.outer_src.int()
        odst = hb.outer_dst.int()
        D = hb.drug_budget
        w = hb.outer_weight
        if w is None:
            gw = tables.inv_sqrt_deg[
                torch.clamp(hb.nodes.long(), 0,
                            tables.inv_sqrt_deg.shape[0] - 1)]
            w = torch.where(odst < D, gw[torch.clamp(osrc.long(), max=D - 1)]
                            * gw[torch.clamp(odst.long(), max=D - 1)], 0.0)
        operm, osorted = hb.outer_src_perm, hb.outer_src_sorted
        if operm is not None:
            operm, osorted = operm.int(), osorted.int()
        else:
            operm = torch.sort(osrc, stable=True).indices.int()
            osorted = osrc[operm.long()]
        return OuterGraph(edge_src=osrc, edge_dst=odst, edge_weight=w,
                          num_nodes=D, edge_cap=hb.outer_edge_cap,
                          edge_src_perm=operm, edge_src_sorted=osorted)

    @staticmethod
    def _padded(hb: HierarchicalBatch) -> PaddedGraphBatch:
        """A host-built batch as the inner level takes it: no block fields,
        so every inner conv streams (JAX ``trainer.py:640-654``)."""
        return PaddedGraphBatch(
            node_feat=hb.node_feat,
            node_mask=torch.ones(hb.node_cap, device=hb.node_feat.device),
            edge_src=hb.edge_src,
            edge_dst=hb.edge_dst,
            edge_weight=hb.edge_weight,
            graph_ids=hb.graph_ids,
            graph_n_nodes=hb.graph_n_nodes,
            num_graphs=hb.drug_budget,
            node_cap=hb.node_cap,
            edge_cap=hb.edge_cap,
            edge_src_perm=hb.edge_src_perm,
            edge_src_sorted=hb.edge_src_sorted)

    def _on_slot(self, name: str, obj, slot: int):
        """``obj`` (the trainer's, on the first card) on replica ``slot``'s
        card (``PerReplica``)."""
        if slot == 0:
            return obj
        if self._copies is None:
            self._copies = PerReplica(self._slots)
        return self._copies(name, obj)[slot]

    def _forward(self, hb: CompactBatch | HierarchicalBatch,
                 slot: int = 0) -> torch.Tensor:
        model = self.model if slot == 0 else self._reps.models[slot]
        tables = self._on_slot("tables", self.tables, slot)
        if isinstance(hb, CompactBatch):
            pb = self._expand_compact(hb, tables)
        else:
            pb = self._padded(hb)
        emb = model.encode_inner(pb)
        emb = model.propagate_outer(emb, self._derive_outer(hb, tables))
        return model.score_pairs(emb, hb.pairs.long())

    def _loss(self, hbs: list) -> torch.Tensor:
        """The masked-mean loss of the union of a step's ``dp`` shard
        batches (one without a mesh), their (sum, count) pairs added in
        shard order on the first card."""
        parts = [masked_sums(self._forward(b, s), b.labels, b.mask)
                 for b, s in zip(hbs, self._slot_of)]
        return union_over_replicas(parts, self._slot_of, self.device)

    def _replicas(self) -> Replicas:
        if self._reps is None:
            self._reps = Replicas(self.model, self.optimizer, self._slots)
        return self._reps

    def _step(self, hbs: list) -> torch.Tensor:
        return self._replicas().update(lambda: self._loss(hbs),
                                       self.config.grad_clip,
                                       optimizer=self.optimizer)

    def _draw_host(self, at: tuple[int, int] | None = None) -> list:
        """One step's ``dp`` host-drawn NumPy batches (each a
        ``CompactBatch`` with resident tables, else a whole
        ``HierarchicalBatch``): shard ``s`` of ``at=(epoch, step)`` is batch
        ``(epoch, step * dp + s)``, a pure function of (seed, epoch, step)
        and safe on prefetch threads; without ``at``, the sampler's next
        sequential draws."""
        s = self.sampler
        if at is None:
            draw = s.sample_compact if self.resident else s.sample
            return [draw() for _ in range(self.dp)]
        epoch, step = at
        draw = s.sample_compact_at if self.resident else s.sample_at
        return [draw(epoch, step * self.dp + i) for i in range(self.dp)]

    def _put(self, hb) -> list:
        """A step's ``dp`` batches, each on its shard's card; one batch
        stands for a list of one."""
        hbs = hb if isinstance(hb, list) else [hb]
        if len(hbs) != self.dp:
            raise ValueError(f"{len(hbs)} batches for a step on dp={self.dp}")
        return [b.to(self._slots[s]) for b, s in zip(hbs, self._slot_of)]

    def train_step(self, hb=None) -> torch.Tensor:
        """One optimizer step on ``hb`` (a list of ``dp`` host or device
        batches, or one batch without a mesh; default fresh host draws);
        returns the loss as a device scalar. The gradients stay in
        ``param.grad`` until the next step."""
        return self._step(self._put(self._draw_host() if hb is None else hb))

    def train_chunk(self, hbs) -> torch.Tensor:
        """``len(hbs)`` steps in order, the losses kept on the device
        (``[K]``): the same trajectory as as many ``train_step`` calls."""
        return torch.stack([self._step(self._put(hb)) for hb in hbs])

    def train_chunk_device(self, epoch: int, step0: int,
                           k: int | None = None):
        """``k`` (default ``dispatch_chunk``) steps on device-drawn batches
        (epoch, step0 + j), with no host synchronisation; under a mesh
        step ``i`` draws ``(epoch, i * dp + s)`` for shard ``s``. Returns
        ``(losses [k], stats)``, the truncation counters summed over the
        chunk's draws as device scalars."""
        k = int(k if k is not None else max(1, self.dispatch_chunk))
        d = self.dsampler
        losses, totals = [], None
        for i in range(step0, step0 + k):
            cbs = []
            for s in range(self.dp):
                slot = self._slot_of[s]
                cb, stats = d.sample(
                    self._on_slot("consts", self._dev_consts, slot),
                    d.key_at(epoch, i * self.dp + s))
                cbs.append(cb)
                if slot:  # a device-to-device copy: no host synchronisation
                    stats = {name: v.to(self.device)
                             for name, v in stats.items()}
                totals = stats if totals is None else {
                    name: totals[name] + v for name, v in stats.items()}
            losses.append(self._step(cbs))
        return torch.stack(losses), totals

    def _fit_epoch_device(self, epoch: int, n_steps: int) -> torch.Tensor:
        """One epoch of device-drawn steps; losses and counters stay on the
        device until the epoch ends."""
        if self.config.reshuffle_epochs:
            self._dev_consts = self.dsampler.reshuffle_adj(
                self._dev_consts0, epoch)
        chunk = max(1, self.dispatch_chunk)
        losses, stats = [], []
        for step in range(0, n_steps, chunk):
            ls, st = self.train_chunk_device(epoch, step,
                                             min(chunk, n_steps - step))
            losses.append(ls)
            stats.append(st)
        for name in stats[0] if stats else ():
            self.sampler.truncation[name] = self.sampler.truncation.get(
                name, 0) + int(sum(st[name] for st in stats))
        dropped = self.sampler.truncation.get("trunc_ncap_dropped", 0)
        if dropped > 0 and not self._warned_ncap:
            # the device-calibrated node cap is a statistical max over
            # simulated draws: persistent drops bias the estimator
            self._warned_ncap = True
            warnings.warn(
                f"device sampler node cap truncated {dropped} molecules "
                "this epoch; raise the calibration margin or draws "
                "(DeviceSampler._calibrate_node_hops)", RuntimeWarning)
        return torch.cat(losses) if losses else torch.zeros(0)

    def _flush(self, pending: list, losses: list) -> list:
        """Run the buffered host batches: a whole chunk, or a short tail
        step by step (the same trajectory either way)."""
        if len(pending) == self.dispatch_chunk and len(pending) > 1:
            losses.extend(self.train_chunk(pending))
        else:
            losses.extend(self.train_step(hb) for hb in pending)
        pending.clear()
        return losses

    # -- parameters and evaluation ---------------------------------------------
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
        return self.params(), optimizer_state(self.optimizer, self.model)

    def evaluate(self, params=None, split: str = "val", neg_seed: int = 1234,
                 exact: bool = False) -> dict:
        """Score held-out positives and as many negatives (one corrupted
        endpoint each, NumPy ``default_rng(neg_seed)``, as the JAX trainer
        draws them); the scores stay on the device and the AUC/AP are
        computed there. ``params`` (a state dict) is loaded first when
        given. By default each ``pair_cap`` pairs are scored on a sampled
        neighbourhood, the training estimator; ``exact`` scores them on
        ``embed_all_exact``'s embeddings, with no sampling, as the
        full-graph ``Trainer`` would on the same parameters."""
        if params is not None:
            self.model.load_state_dict(params)
        pos = self.ds.split_edges(split).astype(np.int64)
        rng = np.random.default_rng(neg_seed)
        corrupt_right = rng.random(len(pos)) < 0.5
        rand = rng.integers(0, self.ds.num_drugs, len(pos))
        neg = np.stack([np.where(corrupt_right, pos[:, 0], rand),
                        np.where(corrupt_right, rand, pos[:, 1])], axis=1)
        pairs = np.concatenate([pos, neg])
        labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        if exact:
            parts = self._score_exact_parts(pairs)
        else:
            cap = self.sampler.pair_cap
            make = (self.sampler.compact_from_pairs if self.resident
                    else self.sampler.batch_from_pairs)
            parts = []
            with torch.no_grad():
                for start in range(0, len(pairs), cap):
                    chunk = pairs[start:start + cap]
                    hb = make(chunk,
                              labels[start:start + cap].astype(np.float32))
                    parts.append(
                        self._forward(hb.to(self.device))[:len(chunk)])
        scores = torch.cat(parts)
        lab = torch.as_tensor(labels, dtype=torch.float32, device=self.device)
        return {f"{split}_auc": float(roc_auc_torch(lab, scores)),
                f"{split}_ap": float(average_precision_torch(lab, scores))}

    # -- exact (full-propagation) evaluation ----------------------------------
    def _full_outer(self) -> OuterGraph:
        """The whole train graph on the device, built as
        ``prepare_device_data`` builds it, so that exact evaluation matches
        the full-graph ``Trainer``."""
        if self._full_outer_cached is None:
            tr = self.ds.split_edges("train")
            self._full_outer_cached = build_outer_graph(
                tr[:, 0], tr[:, 1], self.ds.num_drugs).to(self.device)
        return self._full_outer_cached

    def _upload_tables(self) -> MoleculeTables:
        """The sampler's molecule tables on the device; a bf16 model's
        feature table in bf16: half the expansion's gather bytes, and the
        inner convs' own type."""
        tables = self.sampler.tables().to(self.device)
        if self.model.compute_dtype == torch.bfloat16:
            tables.feat = tables.feat.to(torch.bfloat16)
        return tables

    def _tables_for_exact(self) -> MoleculeTables:
        if self.tables is not None:
            return self.tables
        if self._exact_tables is None:
            self._exact_tables = self._upload_tables()
        return self._exact_tables

    @torch.no_grad()
    def embed_all_exact(self, params=None) -> torch.Tensor:
        """``[num_drugs, d]`` drug embeddings with no sampling: every
        molecule encoded in the sampler's all-nodes chunks (each expanded on
        the device as a training batch is), the chunks cast to float32 and
        joined in id order on the device, then one outer pass over the whole
        train graph. ``params`` (a state dict) is loaded first when given."""
        if params is not None:
            self.model.load_state_dict(params)
        tables = self._tables_for_exact()
        parts = []
        for cb, ids in self.sampler.compact_chunks_all_nodes():
            pb = self._expand_compact(cb.to(self.device), tables)
            parts.append(self.model.encode_inner(pb)[:len(ids)].float())
        return self.model.propagate_outer(torch.cat(parts),
                                          self._full_outer())

    @torch.no_grad()
    def _score_exact_parts(self, pairs: np.ndarray,
                           chunk: int = 65536) -> list[torch.Tensor]:
        """float32 device logits of ``[P, 2]`` drug-id pairs on
        ``embed_all_exact``'s embeddings, ``chunk`` pairs a part."""
        emb = self.embed_all_exact()
        pairs = torch.as_tensor(np.asarray(pairs, np.int64),
                                device=self.device)
        return [self.model.score_pairs(emb, pairs[s:s + chunk])
                for s in range(0, len(pairs), chunk)]

    def score_exact(self, params, pairs: np.ndarray,
                    chunk: int = 65536) -> np.ndarray:
        """Exact float32 logits of ``[P, 2]`` drug-id pairs, on the host.
        ``params`` (a state dict, or None for the model's own) is loaded
        first."""
        if params is not None:
            self.model.load_state_dict(params)
        return torch.cat(self._score_exact_parts(pairs, chunk)).cpu().numpy()

    # -- the run -------------------------------------------------------------
    def fit(self, params=None, opt_state=None, steps_per_epoch=None,
            log_fn: Callable[[dict], None] | None = None, ckpt=None,
            checkpoint_every: int = 1) -> tuple[Any, dict]:
        """Training run as the JAX ``MinibatchTrainer.fit``; returns
        ``(best_params, result)``. Every batch is a pure function of (seed,
        epoch, step), on the host (``sample_compact_at``, drawn ahead by
        ``prefetch_workers`` threads) or on the card, so ``ckpt`` (a
        ``CheckpointManager``) resumes exactly; ``history`` then covers only
        the epochs run here."""
        cfg = self.config
        if params is None:
            self.init()
        else:
            self.model.load_state_dict(params)
            self.optimizer = make_optimizer(self.model.parameters(), cfg)
            if opt_state is not None:
                load_optimizer_state(self.optimizer, self.model, opt_state)
        n_steps = steps_per_epoch or -(-len(self.sampler) // self.dp)
        best = {"val_auc": -1.0, "params": self.params(), "epoch": -1}
        start_epoch = 0
        restored = _restore_fit_state(ckpt)
        if restored is not None:
            params, opt_state, best, start_epoch = restored
            self.model.load_state_dict(params)
            load_optimizer_state(self.optimizer, self.model, opt_state)
        history = []
        for epoch in range(start_epoch, cfg.epochs):
            self.sampler.reseed(epoch)
            t0 = time.perf_counter()
            if self.device_sample:
                losses = self._fit_epoch_device(epoch, n_steps)
            else:
                draws = ParallelPrefetcher(
                    lambda i, _e=epoch: self._draw_host(at=(_e, i)),
                    n_steps, workers=self.prefetch_workers)
                pending, steps = [], []
                for hb in draws:
                    pending.append(hb)
                    if len(pending) == max(1, self.dispatch_chunk):
                        steps = self._flush(pending, steps)
                if pending:
                    steps = self._flush(pending, steps)
                losses = torch.stack(steps)
            rec = {"epoch": epoch, "loss": float(losses.mean()),
                   "epoch_time_s": time.perf_counter() - t0,
                   # cap-truncation counters ("no silent caps")
                   **self.sampler.truncation_stats(reset=True)}
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
                    self.params(), optimizer_state(self.optimizer,
                                                   self.model), best, epoch))
        final = self.evaluate(best["params"], "test")
        return best["params"], {"history": history,
                                "best_epoch": best["epoch"], **final}
