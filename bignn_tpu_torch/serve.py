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
``block_adjacency`` kernel. Still to port (ROADMAP Queue 1 item 6): reading
a JAX checkpoint (``from_checkpoint``) and the command line.
"""

from __future__ import annotations

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
