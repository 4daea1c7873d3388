"""Host-side batch prefetch (counterpart of ``bignn_tpu/data/prefetch.py``,
``ParallelPrefetcher``).

The host sampler's draw of a step is NumPy work comparable to a device
step, so ``MinibatchTrainer.fit`` on host-drawn batches draws them ahead on
a few threads while the card runs the steps before. Only NumPy work is
prefetched; the upload to the card stays on the caller's thread.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator


class ParallelPrefetcher:
    """Draw batches ``fn(0) .. fn(n-1)`` on a small thread pool, yielding in
    index order with a bounded in-flight window.

    Requires ``fn`` to be order-independent — a pure function of its index
    (``HierarchicalSampler.sample_compact_at`` derives a per-(epoch, idx)
    generator for exactly this) — so concurrency cannot change the
    trajectory. NumPy releases the GIL in its big kernels (sorts and
    uniques dominate the sampler), so 2-3 workers overlap well.
    """

    def __init__(self, fn: Callable[[int], object], n: int,
                 workers: int = 2, depth: int = 6):
        self.fn = fn
        self.n = n
        self.workers = max(1, workers)
        self.depth = max(self.workers, depth)

    def __iter__(self) -> Iterator:
        with ThreadPoolExecutor(
            self.workers, thread_name_prefix="bignn-prefetch"
        ) as ex:
            window: deque = deque()
            for i in range(self.n):
                window.append(ex.submit(self.fn, i))
                if len(window) >= self.depth:
                    yield window.popleft().result()
            while window:
                yield window.popleft().result()
