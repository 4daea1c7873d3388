"""Serving (counterpart of ``bignn_tpu/serve.py``).

  1. OFFLINE, once per parameter set: encode every molecule through the
     inner level and run one full outer propagation over the train graph,
     giving a ``[num_drugs, d]`` embedding matrix on the device. No sampling.
  2. ONLINE: a (u, v) pair is two embedding rows through the pair scorer;
     ranking the partners of a drug is a one-vs-all scorer pass and a
     top-k, optionally with the drug's known (train/val) partners masked.

The encode uses the bucketed block-local layout of ``sparse/``, uploaded by
``models.bignn.upload_buckets``: each bucket's edge list and block ranges go
up and its block adjacency is built on the device by the
``block_adjacency`` kernel. (The JAX Scorer encodes through
``MinibatchTrainer.embed_all_exact``; both routes give the same exact
embeddings.)

Usage (library):
    scorer = Scorer.from_checkpoint(cfg, ckpt_dir)   # or Scorer(model, ds, params)
    scores = scorer.score_pairs(pairs)               # [P] logits
    ids, s = scorer.top_k(drug_id, k=20)             # best candidate partners

CLI, over a run's checkpoints (``python -m bignn_tpu_torch.run ...
--run-dir R --checkpoint-every 1`` writes them to ``R/ckpt``; a JAX run's
go through ``scripts/convert_jax_checkpoint.py`` first):
    python -m bignn_tpu_torch.serve --config config2 --ckpt R/ckpt \
        --pairs pairs.npy --out scores.npy
    python -m bignn_tpu_torch.serve --config config2 --ckpt R/ckpt \
        --topk 42 --k 20
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bignn_tpu_torch.models.bignn import upload_buckets
from bignn_tpu_torch.sparse.bucketing import bucket_graphs
from bignn_tpu_torch.sparse.formats import build_outer_graph

# ranking queries per one-vs-all pass, as the JAX Scorer's qchunk: bounds
# the MLP scorer's [B, N, 3d] features (4.9 GB in f32 at 100K drugs, d 128)
QUERY_CHUNK = 32


class Scorer:
    """Device-resident scorer over a BiGNN.

    ``params`` is a state dict for ``model`` (e.g. ``model.state_dict()``
    or ``bridge.params_from_jax(tree)``); the model moves to ``device``.
    ``chunk`` caps the pairs scored per pass."""

    def __init__(self, model, ds, params, chunk: int = 65536,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.ds = ds
        self.chunk = int(chunk)
        self._buckets, self._graph_index = upload_buckets(
            bucket_graphs(ds.molecules), model.config.inner_layers,
            self.device)
        train = ds.split_edges("train")
        self._outer = build_outer_graph(
            train[:, 0], train[:, 1], ds.num_drugs).to(self.device)
        # known partners (train + val, both directions) as a CSR: ranking
        # wants NEW candidates, not the partners already in the graph.
        # Sorted by the first drug on the device (18M entries at 100K
        # drugs); the order within a drug's partners does not matter.
        known = torch.as_tensor(np.concatenate(
            [ds.split_edges("train"), ds.split_edges("val")]).astype(np.int64),
            device=self.device)
        u = torch.cat([known[:, 0], known[:, 1]])
        deg = torch.bincount(u, minlength=ds.num_drugs)
        self._kptr = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
        self._kdst = torch.cat([known[:, 1], known[:, 0]])[
            torch.argsort(u, stable=True)]
        self._kmax = max(int(deg.max()), 1)
        self.refresh(params)

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_dir: str, chunk: int = 65536,
                        use_best: bool = True,
                        device: str | torch.device = "cuda") -> "Scorer":
        """A Scorer over the latest state in ``ckpt_dir`` (a
        ``train.checkpoint.CheckpointManager`` directory): its best-val
        parameters, or with ``use_best=False`` the last ones. ``cfg`` is an
        ``ExperimentConfig`` (``config.get_config``) naming the dataset and
        the model."""
        from bignn_tpu_torch.data import load_dataset
        from bignn_tpu_torch.models import BiGNN
        from bignn_tpu_torch.train.checkpoint import CheckpointManager

        state = CheckpointManager(ckpt_dir).restore_state()
        if state is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
        model = BiGNN(dataclasses.replace(cfg.model, feat_dim=ds.feat_dim))
        return cls(model, ds, state["best_params" if use_best else "params"],
                   chunk=chunk, device=device)

    def refresh(self, params) -> None:
        """Load new parameters (a state dict) and re-embed every drug."""
        self.model.load_state_dict(params)
        with torch.inference_mode():
            emb = self.model.embed_drugs(
                self._buckets, self._graph_index, self.ds.num_drugs)
            self.embeddings = self.model.propagate_outer(emb, self._outer)

    # -- online scoring ---------------------------------------------------
    def score_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """Logits for ``[P, 2]`` drug-id pairs: one upload, ``chunk`` pairs
        per scorer pass, one copy back."""
        pairs = torch.as_tensor(np.asarray(pairs, np.int64),
                                device=self.device)
        if not len(pairs):
            return np.zeros(0, np.float32)
        with torch.inference_mode():
            out = [self.model.score_pairs(self.embeddings,
                                          pairs[s : s + self.chunk])
                   for s in range(0, len(pairs), self.chunk)]
        return torch.cat(out).cpu().numpy()

    def _rank(self, drug_ids: torch.Tensor, k: int, exclude_known: bool):
        """Top-k over one-vs-all scores of a ``[B]`` query batch, with the
        query drug (and optionally its known partners) set to -inf."""
        scores = self.model.score_one_vs_all(self.embeddings, drug_ids)
        rows = torch.arange(len(drug_ids), device=self.device)
        scores[rows, drug_ids] = -torch.inf
        if exclude_known:
            lo = self._kptr[drug_ids]
            deg = self._kptr[drug_ids + 1] - lo
            j = torch.arange(self._kmax, device=self.device)
            part = self._kdst[(lo[:, None] + j).clamp_max(len(self._kdst) - 1)]
            # slots past the drug's degree point at the drug itself,
            # already -inf
            part = torch.where(j < deg[:, None], part, drug_ids[:, None])
            scores.scatter_(1, part, -torch.inf)
        return torch.topk(scores, k, dim=1)

    def top_k_batch(self, drug_ids, k: int = 20, exclude_known: bool = False):
        """``([B, k] candidate ids, [B, k] logits)`` for a batch of query
        drugs, best first."""
        ids = torch.as_tensor(np.asarray(drug_ids, np.int64),
                              device=self.device)
        vals, cand = [], []
        with torch.inference_mode():
            for s in range(0, len(ids), QUERY_CHUNK):
                v, c = self._rank(ids[s : s + QUERY_CHUNK], k, exclude_known)
                vals.append(v)
                cand.append(c)
        return (torch.cat(cand).to(torch.int32).cpu().numpy(),
                torch.cat(vals).cpu().numpy())

    def top_k(self, drug_id: int, k: int = 20, exclude_known: bool = False):
        """``(candidate ids, logits)`` of drug_id's k best predicted
        partners. ``exclude_known`` also masks its train/val partners."""
        ids, scores = self.top_k_batch([drug_id], k, exclude_known)
        return ids[0], scores[0]


def main(argv=None):
    """Serve one request from a checkpoint and print one JSON line: the
    ranking of ``--topk`` (one drug id, or a comma list for one batched
    pass), or the scores of ``--pairs`` (``.npy``/``.npz`` ``[P, 2]``),
    saved to ``--out``. Returns ``(ids, logits)`` or the scores."""
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True, help="CheckpointManager dir")
    p.add_argument("--pairs", default=None,
                   help=".npy/.npz [P, 2] int drug-id pairs to score")
    p.add_argument("--out", default=None, help="output .npy for scores")
    p.add_argument("--topk", default=None,
                   help="rank partners for this drug id (or a comma list "
                        "of ids for one batched pass) instead")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--exclude-known", action="store_true",
                   help="mask train/val partners from rankings (surface "
                        "NEW candidate interactions)")
    p.add_argument("--last", action="store_true",
                   help="use last params instead of best-val params")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no CPU fallback)")
    args = p.parse_args(argv)

    from bignn_tpu_torch.config import get_config

    scorer = Scorer.from_checkpoint(
        get_config(args.config), args.ckpt, use_best=not args.last,
        device=args.device)
    if args.topk is not None:
        drugs = [int(x) for x in str(args.topk).split(",")]
        if len(drugs) == 1:
            ids, scores = scorer.top_k(
                drugs[0], args.k, exclude_known=args.exclude_known)
        else:
            ids, scores = scorer.top_k_batch(
                drugs, args.k, exclude_known=args.exclude_known)
        print(json.dumps({
            "drug": drugs[0] if len(drugs) == 1 else drugs,
            "candidates": ids.tolist(),
            "logits": np.round(scores.astype(float), 4).tolist(),
        }))
        return ids, scores
    if args.pairs is None:
        raise SystemExit("need --pairs or --topk")
    arr = np.load(args.pairs)
    if hasattr(arr, "files"):  # npz
        arr = arr[arr.files[0]]
    scores = scorer.score_pairs(arr)
    if args.out:
        np.save(args.out, scores)
    print(json.dumps({
        "n": len(scores),
        "mean_logit": round(float(scores.mean()), 4),
        "out": args.out,
    }))
    return scores


if __name__ == "__main__":
    main()
