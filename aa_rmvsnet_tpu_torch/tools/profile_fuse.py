"""Where the time of a fused scan goes on the card.

    python -m aa_rmvsnet_tpu_torch.tools.profile_fuse [--scans 2] [--out DIR]

Runs ``pipeline/fuse.py:fuse_views``, unchanged, on ``chip_smoke.py`` phase
7b's scan (49 views of a plane at 600 + N(0, 3^2) at 864x1152, 10 sources
each, uint8 images at 1200x1600 so that the resize runs; the same seed,
``utils/synthetic.py:fusion_scan``) on one CUDA device:

1. a warm-up scan, then ``--scans`` scans by the host clock as a user
   runs them;
2. ``--scans`` scans with each line of ``fuse_views`` timed: a line tracer
   (``sys.settrace``, on that function only) synchronises the device and
   reads the host clock where each line starts, so that a statement's time
   holds its device work.  The statements fall into stages: the loop and
   the inputs to the device, the image to the prediction's geometry (the
   float conversion, the resize and crop, the intrinsics), the pair
   matrices on the host, the reproject-and-vote (the index and matrices to
   the device and the kernel; the kernel's own device time by CUDA events
   around the launch), the masks and the fused depth, the pixel grid, the
   points (``_back_project``, wrapped to split its statement into the
   boolean gathers of its arguments, the back-projection, and the copy of
   the points to the host), and the colours (gather and copy).  The
   synchronisations add time of their own: the traced scan's total is
   printed beside the untraced one's;
3. one scan under ``torch.profiler``, untraced: the device's busy share of
   the scan and device time by kernel group, the fusion kernel's among
   them.

Prints a line per stage and, last, one JSON line; ``--out DIR`` also
writes the Chrome trace there.
"""

from __future__ import annotations

import argparse
import ast
import inspect
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

from ..ops import fusion
from ..pipeline import fuse
from ..utils.synthetic import fusion_scan
from .profile_main_path import device_breakdown

# chip_smoke.py phase 7b.
VIEWS, NUM_SRC, H, W, IMG_H, IMG_W = 49, 10, 864, 1152, 1200, 1600
FOCAL, BASELINE, PLANE, NOISE, SEED = 2000.0, 2.0, 600.0, 3.0, 19
#: The stage of a statement of ``fuse_views``' loop over the reference views,
#: by the first match in the statement's source.
STAGES = (
    ("pair matrices (host)", ("pair_matrices",)),
    ("reproject-and-vote (index, matrices, kernel)", ("fuse_ref(",)),
    ("points", ("_back_project(",)),
    ("colours (gather, copy to the host)", ("rgb.append",)),
    ("pixel grid", ("ys_grid",)),
    ("image to the prediction geometry", ("_align_image_to_prediction", "_adjust_intrinsics",
                                          "pyr_down", "K_ref", "src_K", "K[:2")),
    ("masks and fused depth", ("photo", "geo", "fused_depth", "final", "on_masks",
                               "ref_depth", "for li", "i <= len(srcs)")),
    ("loop and inputs to the device", ("",)),
)
KERNEL_GROUPS = (  # first match wins; matched on the lower-cased kernel name
    ("fuse_ref_kernel (CUDA kernel of the port)", ("fuse_ref_kernel",)),
    ("copies to the host", ("dtoh", "devicetohost")),
    ("copies to the device", ("htod", "hosttodevice")),
    ("boolean gathers (nonzero, index)", ("nonzero", "index", "cub", "flag", "select")),
    ("elementwise / copy / other", ("",)),
)


def _stage(text: str) -> str:
    return next(label for label, keys in STAGES if any(k in text for k in keys))


def _statement_stages(fn) -> tuple[dict, int, int]:
    """``{line: stage}`` for the lines of ``fn``'s loop over the reference
    views (a statement's lines take the stage of its source, a compound
    statement's head that of its first line), and the loop's first and last
    line."""
    lines, first = inspect.getsourcelines(fn)
    source = "".join(lines)
    loop = next(node for node in ast.walk(ast.parse(source)) if isinstance(node, ast.For)
                and ast.unparse(node.target) == "(ref, srcs)")
    stages = {}
    for node in ast.walk(loop):
        if isinstance(node, (ast.For, ast.If, ast.While, ast.With)):
            stages[node.lineno + first - 1] = _stage(lines[node.lineno - 1])
        elif isinstance(node, ast.stmt):
            for line in range(node.lineno, node.end_lineno + 1):
                stages.setdefault(line + first - 1, _stage(ast.get_source_segment(source, node)))
    return stages, loop.lineno + first - 1, loop.end_lineno + first - 1


class _LineTimer:
    """Host seconds per stage of ``fuse_views``, the device synchronised
    where each of its lines starts."""

    def __init__(self):
        self.code = fuse.fuse_views.__code__
        self.stages, self.first, self.last = _statement_stages(fuse.fuse_views)
        self.seconds: dict[str, float] = defaultdict(float)
        self.stage, self.t = "the maps stacked (before the loop)", 0.0

    def mark(self, stage: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[self.stage] += now - self.t
        self.stage, self.t = stage, now

    def _local(self, frame, event, arg):
        if event == "line":
            line = frame.f_lineno
            self.mark(self.stages.get(line, "loop and inputs to the device")
                      if self.first <= line <= self.last else
                      "the maps stacked (before the loop)" if line < self.first else
                      "the points concatenated (after the loop)")
        elif event == "return":
            self.mark("done")
        return self._local

    def _global(self, frame, event, arg):
        return self._local if frame.f_code is self.code else None

    def run(self, *args):
        back_project = fuse._back_project

        def timed_back_project(*a):
            self.mark("points: back-projection")
            out = back_project(*a)
            self.mark("points: copy to the host")
            return out

        fuse._back_project = timed_back_project
        self.stage, self.t = "the maps stacked (before the loop)", time.perf_counter()
        sys.settrace(self._global)
        try:
            out = fuse.fuse_views(*args)
        finally:
            sys.settrace(None)
            fuse._back_project = back_project
        self.seconds.pop("done", None)
        # the statement that calls _back_project: its time before the call
        self.seconds["points: boolean gathers"] = self.seconds.pop("points", 0.0)
        return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scans", type=int, default=2)
    parser.add_argument("--out", default=None, help="directory for the Chrome trace")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fuse: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    depths, confs, images, cams, pairs = fusion_scan(VIEWS, NUM_SRC, H, W, IMG_H, IMG_W,
                                                     FOCAL, BASELINE, PLANE, NOISE, SEED)
    scan = (depths, confs, images, cams, pairs, fuse.FuseConfig(device="cuda"))
    fuse.fuse_views(*scan)  # warm-up: the build, the allocator, the first launches
    plain_s = []
    for _ in range(args.scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xyz, _ = fuse.fuse_views(*scan)
        plain_s.append(time.perf_counter() - t0)
    points = len(xyz)

    traced = []
    for _ in range(args.scans):
        timer = _LineTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fusion.launches = 0
        timer.run(*scan)
        traced.append((time.perf_counter() - t0, dict(timer.seconds), fusion.launches))

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function("scan"):
            fuse.fuse_views(*scan)
        torch.cuda.synchronize()
    spans_ms, _, groups_ms, _ = device_breakdown(prof, ("scan",), KERNEL_GROUPS)
    span_ms = spans_ms["scan"]
    busy_ms = sum(groups_ms.values())
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "fuse_views.json"))

    print(f"fuse_views on {VIEWS} views x {NUM_SRC} sources at {H}x{W}, images "
          f"{IMG_H}x{IMG_W}: {points} points; {', '.join(f'{s:.4f}' for s in plain_s)} s a "
          f"scan untraced", flush=True)
    for k, (total, seconds, launches) in enumerate(traced):
        print(f"traced scan {k}: {total:.4f} s, {launches} fusion kernel launches", flush=True)
        for stage, s in sorted(seconds.items(), key=lambda kv: -kv[1]):
            print(f"  {stage:48s} {s * 1e3:9.3f} ms  {s / total:6.1%}", flush=True)
    print(f"profiled scan: device-timeline span {span_ms:.3f} ms, kernels and copies "
          f"{busy_ms:.3f} ms ({busy_ms / span_ms:.1%} busy)", flush=True)
    for group, ms in sorted(groups_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {group:48s} {ms:9.3f} ms", flush=True)
    print(json.dumps({
        "device": smi, "points": points, "scan_s": plain_s,
        "traced": [{"total_s": t, "stages_s": s, "launches": n} for t, s, n in traced],
        "profile": {"span_ms": span_ms, "busy_ms": busy_ms, "groups_ms": dict(groups_ms)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
