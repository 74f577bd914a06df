"""The readers of the program's nested ranges on a synthetic trace:
``groupnorm`` inside ``featnet`` and ``sweep.regularize``, ``sweep.warp``
and ``sweep.omega`` inside ``sweep.cost_block``, ``head.deconv`` inside
``evidential.hourglass``.  On the device timeline a kernel belongs to its
innermost range alone, so a range's span runs from its own first kernel to
its own last and holds the nested ranges' kernels between them."""

from __future__ import annotations

import pytest

from benchmark import manifest as manifests
from benchmark import trace

MS = 1_000_000


#: One map of two depth steps: each kernel (name, start ms, end ms) with the
#: calls of the ranges open at its launch, outermost first.  A call is
#: ``name#n``: one range is entered many times in a map.
KERNELS = [
    (("featnet#1",), "conv", 0, 2),
    (("featnet#1", "groupnorm#1"), "gn", 2, 4),
    (("featnet#1",), "conv", 8, 10),
    (("sweep.cost_block#1",), "xy", 10, 11),
    (("sweep.cost_block#1", "sweep.warp#1"), "gather", 11, 14),
    (("sweep.cost_block#1", "sweep.omega#1"), "omega_conv", 14, 17),
    (("sweep.cost_block#1", "sweep.omega#1", "groupnorm#2"), "gn_folded", 17, 19),
    (("sweep.cost_block#1", "sweep.omega#1"), "sigmoid", 19, 20),
    (("sweep.cost_block#1",), "mean", 29, 30),
    (("sweep.regularize#1",), "cat", 30, 31),
    (("sweep.regularize#1", "groupnorm#3"), "gn", 31, 35),
    (("sweep.regularize#1",), "lstm_gates_kernel", 35, 49),
    (("sweep.regularize#1",), "conv", 49, 50),
    (("evidential.hourglass#1",), "conv3d", 60, 65),
    (("evidential.hourglass#1", "head.deconv#1"), "dgrad", 65, 80),
    (("evidential.hourglass#1",), "bn", 80, 84),
    (("evidential.hourglass#1",), "mish", 84, 90),
]
#: The ranges nested in others, which the parent commit's program lacks.
NESTED = ("groupnorm", "sweep.warp", "sweep.omega", "head.deconv")


def synthetic(nested: bool = True, kernels=KERNELS):
    """A 100 ms window of ``kernels`` as Kineto records them: each kernel
    belongs to the innermost range open at its launch alone, and each call
    of a range spans the device from its own first kernel to its own last.
    ``nested=False`` leaves the nested ranges out (the parent commit)."""
    events = [("user_annotation", trace.WINDOW, 0, 100 * MS)]
    own: dict = {}  # call -> its own kernels' (start, end)
    for calls, name, start, end in kernels:
        kept = [c for c in calls if nested or c.split("#")[0] not in NESTED]
        own.setdefault(kept[-1], []).append((start, end))
        events.append(("kernel", name, start * MS, end * MS))
    for call, intervals in own.items():
        events.append(("gpu_user_annotation", call.split("#")[0],
                       min(s for s, _ in intervals) * MS, max(e for _, e in intervals) * MS))
    return events


def summary(nested: bool = True, kernels=KERNELS) -> dict:
    s = trace.summarize(synthetic(nested, kernels))
    s.update(maps=1, depth_steps=2)
    return s


def read(name: str, s: dict):
    return manifests.reader(name)(s)


def test_new_readers():
    s = summary()
    assert read("groupnorm.ms_per_map", s) == pytest.approx(8.0)  # 2 + 2 + 4 ms, one map
    assert read("sweep.warp_ms", s) == pytest.approx(1.5)  # 3 ms over 2 depth steps
    assert read("sweep.omega_ms", s) == pytest.approx(3.0)  # 6 ms, the nested GroupNorm in
    assert read("head.deconv_ms_per_map", s) == pytest.approx(15.0)


@pytest.mark.parametrize("name", ["sweep.cost_block_ms", "sweep.regularize_ms",
                                  "head.ms_per_map"])
def test_nested_ranges_leave_the_outer_readings(name):
    assert read(name, summary()) == pytest.approx(read(name, summary(nested=False)))


def test_an_outer_range_that_ends_in_a_nested_one_reads_less():
    """Why the program's ranges that a metric reads end with kernels of
    their own: were the last kernel of ``sweep.cost_block`` (the view mean)
    taken into ``sweep.omega``, the cost block's own kernels would be the
    coordinates alone, and its span would hold nothing else."""
    moved = [(("sweep.cost_block#1", "sweep.omega#1") if name == "mean" else calls,
              name, start, end) for calls, name, start, end in KERNELS]
    assert read("sweep.cost_block_ms", summary()) == pytest.approx(5.5)  # 11 ms, 2 steps
    assert read("sweep.cost_block_ms", summary(kernels=moved)) == pytest.approx(0.5)


def test_head_reading_counts_the_nested_deconvolution_once():
    assert read("head.ms_per_map", summary()) == pytest.approx(30.0)


@pytest.mark.parametrize("name", ["groupnorm.ms_per_map", "sweep.warp_ms", "sweep.omega_ms",
                                  "head.deconv_ms_per_map"])
def test_new_readers_are_silent_without_their_range(name):
    """A program without the range (the parent commit) reads nothing, and
    the reader does not raise."""
    assert read(name, summary(nested=False)) is None
