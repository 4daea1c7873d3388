"""Serving (counterpart of ``bignn_tpu/serve.py``).

  1. OFFLINE, once per parameter set: encode every molecule through the
     inner level and run one full outer propagation over the train graph,
     giving a ``[num_drugs, d]`` embedding matrix on the device. No sampling.
  2. ONLINE: a (u, v) pair is two embedding rows through the pair scorer;
     ranking the partners of a drug is a one-vs-all scorer pass and a
     top-k, optionally with the drug's known (train/val) partners masked.

The encode uses the bucketed block-local layout of ``sparse/``: each
bucket's edge list and block ranges are uploaded and its block adjacency is
built on the device by the ``block_adjacency`` kernel; the host-built dense
blocks are not uploaded. Still to port (ROADMAP Queue 1 item 9): reading a
JAX checkpoint (``from_checkpoint``) and the command line.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bignn_tpu_torch import ops
from bignn_tpu_torch.sparse.bucketing import bucket_graphs
from bignn_tpu_torch.sparse.formats import build_outer_graph

QUERY_CHUNK = 32  # ranking queries per one-vs-all pass: bounds [B, N, 3d]


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
        kinds = {s.split(":")[0] for s in model.config.inner_layers}
        bucketing = bucket_graphs(ds.molecules)
        self._buckets = [self._upload_bucket(b, "gcn" in kinds)
                         for b in bucketing.batches]
        self._graph_index = [torch.as_tensor(i, device=self.device)
                             for i in bucketing.graph_index]
        train = ds.split_edges("train")
        self._outer = build_outer_graph(
            train[:, 0], train[:, 1], ds.num_drugs).to(self.device)
        # known partners (train + val, both directions) as a CSR: ranking
        # wants NEW candidates, not the partners already in the graph
        known = np.concatenate(
            [ds.split_edges("train"), ds.split_edges("val")]).astype(np.int64)
        und = np.concatenate([known, known[:, ::-1]])
        und = und[np.lexsort((und[:, 1], und[:, 0]))]
        kptr = np.searchsorted(und[:, 0], np.arange(ds.num_drugs + 1))
        self._kmax = int(max(np.diff(kptr).max(), 1))
        self._kptr = torch.as_tensor(kptr, device=self.device)
        self._kdst = torch.as_tensor(und[:, 1], device=self.device)
        self.refresh(params)

    def _upload_bucket(self, batch, weighted: bool):
        """Upload a bucket without its host adjacencies and build them on
        the device: the multiplicity always (GIN sum, attention mask), the
        GCN weights when an inner conv needs them."""
        dev = dataclasses.replace(batch, block_adj=None,
                                  block_cnt=None).to(self.device)
        if dev.block_estarts is None:
            raise NotImplementedError(
                "molecules over 128 atoms need the streaming inner layout, "
                "still to port (ROADMAP Queue 1 item 4)")
        dev.block_cnt = ops.block_adjacency(
            dev.edge_src, dev.edge_dst, None, dev.block_estarts, dev.node_cap)
        if weighted:
            dev.block_adj = ops.block_adjacency(
                dev.edge_src, dev.edge_dst, dev.edge_weight,
                dev.block_estarts, dev.node_cap)
        return dev

    def refresh(self, params) -> None:
        """Load new parameters (a state dict) and re-embed every drug."""
        self.model.load_state_dict(params)
        with torch.inference_mode():
            emb = self.model.embed_drugs(
                self._buckets, self._graph_index, self.ds.num_drugs)
            self.embeddings = self.model.propagate_outer(emb, self._outer)

    # -- online scoring ---------------------------------------------------
    def score_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """Logits for ``[P, 2]`` drug-id pairs."""
        pairs = torch.as_tensor(np.asarray(pairs, np.int64))
        out = []
        with torch.inference_mode():
            for s in range(0, len(pairs), self.chunk):
                p = pairs[s : s + self.chunk].to(self.device)
                out.append(self.model.score_pairs(self.embeddings, p).cpu())
        if not out:
            return np.zeros(0, np.float32)
        return torch.cat(out).numpy()

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
