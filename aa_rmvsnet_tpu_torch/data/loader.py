"""Async host-side sample prefetching (copy of ``prefetch_samples`` in
``aa_rmvsnet_tpu/data/loader.py``): image decode and PFM reads release the
GIL, so a thread pool overlaps host IO with device compute.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterable, Iterator


def prefetch_samples(
    dataset,
    indices: Iterable[int] | None = None,
    num_workers: int = 8,
    lookahead: int = 16,
) -> Iterator[dict]:
    """Yield ``dataset[i]`` in order with a sliding prefetch window.

    A loader failure is YIELDED as the Exception object, not raised, so the
    consumer can skip the sample and keep the run alive.
    """
    if indices is None:
        indices = range(len(dataset))
    indices = list(indices)
    if num_workers <= 0:
        for i in indices:
            try:
                yield dataset[i]
            except Exception as exc:
                yield exc
        return

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = []
        it = iter(indices)
        for _ in range(min(lookahead, len(indices))):
            pending.append(pool.submit(dataset.__getitem__, next(it)))
        while pending:
            fut = pending.pop(0)
            try:
                out = fut.result()
            except Exception as exc:  # surfaced to the consumer, run continues
                out = exc
            try:
                pending.append(pool.submit(dataset.__getitem__, next(it)))
            except StopIteration:
                pass
            yield out
