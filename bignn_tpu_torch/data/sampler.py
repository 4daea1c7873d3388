"""Negative sampling and edge minibatching (counterpart of
``bignn_tpu/data/sampler.py``).

``EdgeMinibatchSampler`` is the JAX package's NumPy sampler, so its epochs
equal the JAX ones array for array. ``sample_negative_pairs`` makes the
JAX function's threefry draws for the same key (``prng.py``) on the host
and builds the pairs on the positives' device; ``make_training_pairs``
adds the positives and the labels.
"""

from __future__ import annotations

import numpy as np
import torch

from bignn_tpu_torch import prng


def sample_negative_pairs(key: prng.Key, pos_pairs: torch.Tensor,
                          num_nodes: int, ratio: int = 1) -> torch.Tensor:
    """Corrupt one endpoint of each positive pair; returns ``[P*ratio, 2]``
    on ``pos_pairs``' device.

    A fair coin (``jax.random.bernoulli(k1, 0.5)``) picks which endpoint to
    replace and a uniform drug (``randint(k2)``, which draws under the two
    halves of ``split(k2)``) replaces it: three streams from one threefry
    evaluation on the host, which go to the device in one ``[2, n]`` copy.
    Collisions with true positives are not filtered, as in the JAX
    package."""
    rep = pos_pairs.repeat(ratio, 1)
    k1, k2 = prng.split(key)
    bits = prng.random_bits_many([k1, *prng.split(k2)], rep.shape[0])
    draws = torch.from_numpy(np.stack([
        prng.uniform_from_bits(bits[0]) < 0.5,
        prng.randint_from_bits(bits[1], bits[2], 0, num_nodes),
    ]).astype(np.int32)).to(rep.device)
    corrupt_right, rand = draws[0].bool(), draws[1].to(rep.dtype)
    left = torch.where(corrupt_right, rep[:, 0], rand)
    right = torch.where(corrupt_right, rand, rep[:, 1])
    return torch.stack([left, right], dim=1)


def make_training_pairs(key: prng.Key, pos_pairs: torch.Tensor,
                        num_nodes: int, neg_ratio: int = 1
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Positives and ``sample_negative_pairs``' negatives with 1/0 labels:
    ``([P * (1 + r), 2], float32 labels [P * (1 + r)])``, on the positives'
    device."""
    neg = sample_negative_pairs(key, pos_pairs, num_nodes, neg_ratio)
    pairs = torch.cat([pos_pairs, neg])
    labels = torch.cat([torch.ones(len(pos_pairs)), torch.zeros(len(neg))])
    return pairs, labels.to(device=pos_pairs.device)


class EdgeMinibatchSampler:
    """Host-side epoch iterator over positive edges, static batch size.

    Yields ``(pairs [B, 2] int32, mask [B] f32)``; the last batch is padded
    (mask 0) so every step has the same shape."""

    def __init__(self, pos_pairs: np.ndarray, batch_size: int, seed: int = 0):
        self.pos = np.asarray(pos_pairs, np.int32)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return -(-self.pos.shape[0] // self.batch_size)

    def epoch(self, epoch_idx: int | None = None):
        """``epoch_idx`` makes the epoch's shuffle a pure function of
        (seed, epoch_idx), which exact checkpoint-resume needs (the trainer
        passes it); None keeps the stateful-rng behaviour."""
        rng = (np.random.default_rng((self.seed, epoch_idx))
               if epoch_idx is not None else self._rng)
        perm = rng.permutation(self.pos.shape[0])
        for start in range(0, len(perm), self.batch_size):
            pairs = self.pos[perm[start : start + self.batch_size]]
            n = pairs.shape[0]
            if n < self.batch_size:
                pad = np.zeros((self.batch_size - n, 2), np.int32)
                pairs = np.concatenate([pairs, pad], axis=0)
            mask = np.zeros(self.batch_size, np.float32)
            mask[:n] = 1.0
            yield pairs, mask
