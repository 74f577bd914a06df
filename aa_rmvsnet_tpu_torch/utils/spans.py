"""The port's profiler ranges, entered only while a profiler runs.

    with span("sweep.cost_block"):
        ...

While ``torch.profiler`` runs, :func:`span` enters
``torch.profiler.record_function``: the range appears on the host timeline
and, on the card, as a span over its kernels on the device timeline, on one
clock with them.  Otherwise it
returns one shared context that does nothing, so a range costs a flag read
and an empty ``with``: 0.36 µs of host time a call, against 10.9 µs for a
``record_function`` entered with no profiler running (median of 7 loops of
200,000 calls on the host of an H100 machine, PyTorch 2.11; an empty
``with nullcontext()`` alone 0.30 µs).  While a profiler runs, 11.1 µs
against ``record_function``'s 10.8.

On the device timeline Kineto gives each kernel to the innermost range open
on its launching thread alone.  A range's device span therefore runs from
its own first kernel to its own last, and holds a nested range's kernels
only where they fall between them.  So every range that a metric reads
(``benchmark/trace.py``'s ``range_s`` counts the device operations that
start inside a range's spans) starts and ends with kernels of its own, and
its nested ranges sit in between: ``sweep.warp`` and ``sweep.omega`` inside
``sweep.cost_block``, ``groupnorm`` inside ``featnet``,
``sweep.regularize`` and ``sweep.omega``, ``head.deconv`` inside
``evidential.hourglass`` and ``.hourglass_up``.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

#: The context of every range while no profiler runs (one object: entering
#: a ``nullcontext`` does nothing, and ``torch.compile`` traces through it).
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler runs, else a
    context that does nothing.  The test is PyTorch's own Python flag of a
    running profiler (set while any ``torch.profiler`` profile runs, in any
    thread of the process), a global that ``torch.compile`` reads as a
    constant where a call into the C++ profiler state would break its
    graph."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
