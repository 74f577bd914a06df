"""Async host-side sample prefetching and batching (copies of
``prefetch_samples``, ``resilient_samples``, ``batch_samples`` and
``batched`` in ``aa_rmvsnet_tpu/data/loader.py``): image decode and PFM
reads release the GIL, so a thread pool overlaps host IO with device
compute.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterable, Iterator, Sequence

import numpy as np


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


def resilient_samples(
    dataset,
    indices: Iterable[int] | None = None,
    num_workers: int = 8,
    lookahead: int = 16,
    on_skip=None,
) -> Iterator[dict]:
    """Fault-tolerant training stream: yield EXACTLY ``len(indices)`` good
    samples even when some loads fail.

    A loader failure (corrupt image, missing cam file) is replaced by the
    most recent good sample; failures before the first good sample are
    back-filled as soon as one arrives, so an epoch keeps its step count.
    ``on_skip(exc)`` is called for every replaced failure.  Raises
    RuntimeError if NO sample loads.
    """
    owed = 0
    last: dict | None = None
    for out in prefetch_samples(dataset, indices, num_workers, lookahead):
        if isinstance(out, Exception):
            if on_skip is not None:
                on_skip(out)
            if last is None:
                owed += 1
            else:
                yield last
            continue
        last = out
        for _ in range(owed):
            yield out
        owed = 0
        yield out
    if owed:
        raise RuntimeError(
            f"resilient_samples: all {owed} sample load(s) failed; no good "
            "sample available to substitute"
        )


def batch_samples(samples: Sequence[dict]) -> dict:
    """Stack a list of sample dicts into a batch (arrays gain a leading axis;
    non-array fields become lists)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def batched(iterator: Iterator[dict], batch_size: int,
            drop_last: bool = False) -> Iterator[dict]:
    buf = []
    for sample in iterator:
        buf.append(sample)
        if len(buf) == batch_size:
            yield batch_samples(buf)
            buf = []
    if buf and not drop_last:
        yield batch_samples(buf)
