"""Counter-based random numbers that equal ``jax.random``'s.

The JAX package draws every random number from Threefry-2x32 keys
(``jax.random.key``, ``split``, ``fold_in``, in the partitionable layout
that JAX uses by default). Threefry is a pure hash of (key, counter), so the
same draws come out here bit for bit: NumPy uint32 arithmetic on the host,
which wraps as the hash needs. The port draws through it where the JAX
package draws, so a seed names the same experiment in both: the initial
parameters (``models.modules.glorot``, ``jax.random.uniform``), and the
training and evaluation negatives (``data.sampler.sample_negative_pairs``,
``jax.random.bernoulli`` and ``randint``).

The bulk bits are made on the host, and a caller that needs them on a
device uploads the finished draws in one copy: the hash is ~150 elementwise
operations, each of which would be a kernel launch on the card.

A key is a pair of Python ints ``(k1, k2)``; deriving keys is scalar work,
and only the bulk bits are arrays.
"""

from __future__ import annotations

import math

import numpy as np

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under key ``(k1, k2)``; Python ints or uint32 arrays."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def key(seed: int) -> Key:
    """``jax.random.key(seed)``."""
    return (seed >> 32) & MASK, seed & MASK


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)``."""
    return [threefry2x32(*k, 0, i) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    return threefry2x32(*k, 0, data & MASK)


def random_bits_many(keys: list[Key], n: int) -> np.ndarray:
    """``random_bits(k, (n,))`` of every key in ``keys``, stacked as a
    ``[len(keys), n]`` uint32 array, from one threefry evaluation: the keys
    broadcast over the counters."""
    k1, k2 = (np.array([k[j] for k in keys], np.uint32)[:, None]
              for j in (0, 1))
    b1, b2 = threefry2x32(k1, k2, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return b1 ^ b2


def random_bits(k: Key, shape) -> np.ndarray:
    """``jax.random.bits``: 32 random bits for each element of ``shape``."""
    return random_bits_many([k], math.prod(shape)).reshape(shape)


def uniform_from_bits(bits: np.ndarray, minval: float = 0.0,
                      maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform``'s float32 from its 32 random bits: 23
    mantissa bits in [1, 2), shifted and scaled."""
    one_to_two = ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses the scale and shift into one FMA; float64 holds the f32
    # product exactly, so one rounding to float32 gives the same result
    scaled = ((one_to_two - np.float32(1)).astype(np.float64)
              * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def randint_from_bits(hi_bits: np.ndarray, lo_bits: np.ndarray,
                      minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint``'s int32 from its two 32-bit draws, reduced
    modulo the span as JAX does (biased when the span is not a power of
    two)."""
    span = max(maxval - minval, 1)
    multiplier = np.uint32(((2**16 % span) ** 2 & MASK) % span)
    span = np.uint32(span)
    offset = (hi_bits % span) * multiplier + lo_bits % span  # wraps, as JAX
    return (minval + (offset % span).astype(np.int64)).astype(np.int32)


def uniform(k: Key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32."""
    return uniform_from_bits(random_bits(k, shape), minval, maxval)
