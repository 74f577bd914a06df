"""The traced window: ``torch.profiler`` around it, reduced to a summary
that the per-layer metric readers (``benchmark/metrics/``) read, and the
result line's ``breakdown``.

The device timeline holds the card's operations (kernels, copies, sets)
and, as spans over their kernels, the program's profiler ranges
(``featnet``, ``sweep.*``, ``evidential.*``, ``train.*``, ``quant.*``) and
the benchmark's own (``bench.window``, ``bench.map``, ``bench.step``).
The host timeline holds the same ranges as the host ran them.  Both are on
one clock.  Nothing synchronises inside the window for the trace's sake.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np
import torch

#: The device operations: what makes the card busy.
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def profile():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def window_range():
    return torch.profiler.record_function(WINDOW)


def _merge(intervals: np.ndarray) -> np.ndarray:
    """The union of ``(start, end)`` rows, sorted and disjoint."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64)


def _covered(points: np.ndarray, merged: np.ndarray) -> np.ndarray:
    """Which of ``points`` fall inside the disjoint sorted ``merged``."""
    if len(merged) == 0:
        return np.zeros(len(points), bool)
    i = np.searchsorted(merged[:, 0], points, side="right") - 1
    return (i >= 0) & (points < merged[np.maximum(i, 0), 1])


def _innermost(items, ranges) -> list[str]:
    """For each time of ``items`` (sorted), the name of the innermost range
    of ``ranges`` (``(start, end, name)``, sorted by start and, at one
    start, the longer first) that holds it, or ``""``."""
    out, active, j = [], [], 0
    for t in items:
        while j < len(ranges) and ranges[j][0] <= t:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r[1] > t]
        out.append(active[-1][2] if active else "")
    return out


def events(prof) -> list[tuple[str, str, int, int]]:
    """``(category, name, start_ns, end_ns)`` of the trace's device
    operations and ranges, from its Chrome trace (a format that holds
    across PyTorch versions; the categories are Kineto's activity types)."""
    keep = set(DEVICE_OPS) | {"gpu_user_annotation", "user_annotation"}
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as folder:
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    out = []
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") in keep:
            start = round(float(ev["ts"]) * 1000)
            out.append((ev["cat"], ev["name"], start, start + round(float(ev["dur"]) * 1000)))
    return out


def summarize(trace_events) -> dict:
    """The window's device operations and ranges (:func:`events`), reduced:

    ``window_s`` (the ``bench.window`` range on the host), ``busy_s`` (the
    union of device operations inside it), ``ops`` (name -> [count,
    seconds] of device operations), ``kernels`` (the kernel count),
    ``range_s`` (range name -> seconds of the device operations that start
    inside its device-side spans), and ``breakdown``."""
    host_ranges, dev_ranges, ops = [], [], []
    window = None
    for kind, name, start, end in trace_events:
        if kind in DEVICE_OPS:
            ops.append((start, end, name, kind))
        elif kind == "gpu_user_annotation":
            dev_ranges.append((start, end, name))
        elif kind == "user_annotation":
            if name == WINDOW:
                window = (start, end)
            host_ranges.append((start, end, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window
    ops = [o for o in ops if o[0] >= w0 and o[0] < w1]
    ops.sort()
    iv = np.array([(max(s, w0), min(e, w1)) for s, e, _, _ in ops], dtype=np.int64).reshape(-1, 2)
    busy = _merge(iv)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0

    by_name: dict = defaultdict(lambda: [0, 0.0])
    for s, e, name, _ in ops:
        by_name[name][0] += 1
        by_name[name][1] += (e - s) / 1e9
    starts = np.array([o[0] for o in ops], dtype=np.int64)
    durs = np.array([(o[1] - o[0]) / 1e9 for o in ops])
    names = sorted({r[2] for r in dev_ranges})
    range_s = {}
    for name in names:
        merged = _merge(np.array([(s, e) for s, e, n in dev_ranges if n == name],
                                 dtype=np.int64).reshape(-1, 2))
        range_s[name] = float(durs[_covered(starts, merged)].sum())

    dev_ranges.sort(key=lambda r: (r[0], -r[1]))
    where = _innermost([o[0] for o in ops], dev_ranges)
    per_op: dict = defaultdict(float)
    for (s, e, name, _), r in zip(ops, where):
        per_op[f"{r or '(no range)'}: {name[:90]}"] += (e - s) / 1e9
    device_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]

    # Idle gaps inside the window, by the host's innermost range at the gap's start.
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = [(int(s), int(e)) for s, e in edges if e > s]
    host_ranges.sort(key=lambda r: (r[0], -r[1]))
    labels = _innermost([s for s, _ in gaps], host_ranges)
    per_label: dict = defaultdict(lambda: [0, 0.0])
    for (s, e), label in zip(gaps, labels):
        per_label[label or "(no range)"][0] += 1
        per_label[label or "(no range)"][1] += (e - s) / 1e9
    idle = sorted(per_label.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "ops": {k: v for k, v in by_name.items()},
        "kernels": sum(1 for o in ops if o[3] == "kernel"),
        "range_s": range_s,
        "breakdown": {
            "device_ops": [[name, s] for name, s in device_ops],
            "idle_gaps": [[f"host in {label} ({n} gaps)", s] for label, (n, s) in idle],
        },
    }
