"""Host-side batch prefetch (counterpart of ``bignn_tpu/data/prefetch.py``:
``EpochPrefetcher`` and ``ParallelPrefetcher``).

The host sampler's draw of a step is NumPy work comparable to a device
step, so ``MinibatchTrainer.fit`` on host-drawn batches draws them ahead on
a few threads while the card runs the steps before. Only NumPy work is
prefetched; the upload to the card stays on the caller's thread.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator


class EpochPrefetcher:
    """Draw exactly ``n`` batches ``draw()`` on one background thread,
    yielded in order. ``depth`` bounds how far the thread runs ahead. The
    sampler is touched by that one thread only, so the batches are the
    sequential loop's; an exception in the thread re-raises in the
    consumer."""

    _SENTINEL = object()

    def __init__(self, draw: Callable[[], object], n: int, depth: int = 3):
        self.n = n
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc: BaseException | None = None

        def work():
            try:
                for _ in range(n):
                    self._q.put(draw())
            except BaseException as e:  # re-raised by __iter__
                self._exc = e
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=work, name="bignn-prefetch",
                                        daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        for _ in range(self.n):
            item = self._q.get()
            if item is self._SENTINEL:
                raise self._exc
            yield item
        self._thread.join()


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
