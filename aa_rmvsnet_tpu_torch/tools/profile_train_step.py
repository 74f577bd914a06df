"""Where the time of one training step goes on the card.

    python -m aa_rmvsnet_tpu_torch.tools.profile_train_step [--steps 3] [--out DIR]

Runs ``pipeline/train.py:train_step`` at the ``dtu_train`` geometry
(128x160, V=5, D=128, depth_block 16, batch 1, Adam, fp32 without TF32)
on the synthetic plane sample with seeded weights (``utils/synthetic.py``),
on one CUDA device:

1. one warm-up step;
2. ``--steps`` timed steps: host clock around each, ending in
   ``torch.cuda.synchronize()``, and the peak device memory;
3. one step under ``torch.profiler``, its three phases (forward, backward,
   optimizer: what ``train_step`` runs) each ending in a synchronise, so
   that every kernel runs inside the host-side window of its phase: the
   device's busy share (kernel time over the profiled wall time, and over
   the unprofiled step time), the number of kernels and the wall time per
   kernel, and kernel time by phase, by the sweep's profiler ranges
   (``featnet``, ``sweep.*``) inside each phase, and by kernel group.
   Under the backward the sweep ranges hold the recompute of each depth
   block; the rest is the backward proper.

Prints a table and, last, one JSON line; ``--out DIR`` also writes the
Chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import record_function

from ..data.loader import batch_samples
from ..ops import gates
from ..pipeline.train import TrainConfig, batch_to_device, loss_fn, make_optimizer, train_step
from ..utils.device import disable_tf32, resolve_device
from ..utils.synthetic import plane_train_sample, seeded_model
from .profile_main_path import _group

PHASES = ("phase.forward", "phase.backward", "phase.optimizer")
SWEEP_RANGES = ("featnet", "sweep.setup", "sweep.cost_block", "sweep.regularize", "sweep.wta")


def _innermost(spans, t):
    """Name of the shortest span holding time ``t``, or None."""
    best = None
    for start, end, name in spans:
        if start <= t < end and (best is None or end - start < best[0]):
            best = (end - start, name)
    return best[1] if best else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3, help="timed steps")
    parser.add_argument("--out", help="directory for the Chrome trace")
    args = parser.parse_args(argv)

    device = resolve_device("cuda")
    disable_tf32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    H, W, V, D = 128, 160, 5, 128
    sample = plane_train_sample(H, W, V, D, seed=5, focal=361.54, baseline=20.0,
                                plane_depth=600.0, depth_min=425.0, depth_interval=2.65)
    batch = batch_to_device(batch_samples([sample]), device)
    model = seeded_model(0).to(device)
    config = TrainConfig(depth_block=16, device="cuda")
    optimizer, scheduler = make_optimizer(model.parameters(), config, total_steps=10**6)

    def step():
        metrics, _ = train_step(model, optimizer, scheduler, batch, config)
        torch.cuda.synchronize()
        return float(metrics["loss"])

    step()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()

    def phased_step():
        """``train_step``'s phases, each ending in a synchronise."""
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with record_function("phase.forward"):
            loss, _ = loss_fn(model, batch, config.sweep(remat=True))
            torch.cuda.synchronize()
        with record_function("phase.backward"):
            loss.backward()
            torch.cuda.synchronize()
        with record_function("phase.optimizer"):
            optimizer.step()
            scheduler.step()
            torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    gates.launches = gates.backward_launches = 0
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        phased_step()
        prof_wall_s = time.perf_counter() - t0
    launches = (gates.launches, gates.backward_launches)

    # Phases: the host-side windows of the phase ranges.  On the device
    # timeline each sweep range is a span over the kernels launched inside
    # it (the recompute's too); every other device event is a kernel or a
    # copy.
    events = prof.events()
    step_spans = [(ev.time_range.start, ev.time_range.end, ev.name.split(".")[1])
                  for ev in events
                  if ev.device_type == torch.autograd.DeviceType.CPU
                  and ev.name in PHASES]
    device_events = [ev for ev in events
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
    sweep_spans = [(ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in device_events if ev.name in SWEEP_RANGES]
    ranges = PHASES + SWEEP_RANGES
    cross_ms: dict[str, float] = defaultdict(float)
    groups_ms: dict[str, float] = defaultdict(float)
    n_kernels = 0
    for ev in device_events:
        if ev.name in ranges:
            continue
        n_kernels += 1
        ms = ev.time_range.elapsed_us() / 1e3
        t = ev.time_range.start
        phase = _innermost(step_spans, t) or "(outside the phases)"
        layer = _innermost(sweep_spans, t) or "-"
        cross_ms[f"{phase} / {layer}"] += ms
        groups_ms[_group(ev.name)] += ms
    busy_ms = sum(groups_ms.values())
    phase_ms: dict[str, float] = defaultdict(float)
    for key, ms in cross_ms.items():
        phase, layer = key.split(" / ")
        if phase == "backward":
            phase = "backward: recompute" if layer.startswith("sweep.") \
                else "backward: backward proper"
        phase_ms[phase] += ms

    print(f"{smi}; train_step at {H}x{W}, V={V}, D={D}, depth_block 16, batch 1, "
          "fp32 (TF32 off)")
    print(f"seconds per step {', '.join(f'{s:.3f}' for s in step_s)} (unprofiled), "
          f"{prof_wall_s:.3f} profiled; peak memory {peak / 2**30:.2f} GiB")
    mean_s = sum(step_s) / len(step_s)
    print(f"device busy {busy_ms / 1e3:.3f} s = {busy_ms / 1e3 / prof_wall_s:.1%} of the "
          f"profiled window, {busy_ms / 1e3 / mean_s:.1%} of the mean unprofiled step; "
          f"{n_kernels} kernels, {mean_s / n_kernels * 1e6:.1f} us of unprofiled wall time "
          f"per kernel; gate kernel launches forward {launches[0]}, backward {launches[1]}")
    print("kernel time by phase:")
    for name, ms in sorted(phase_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:38s} {ms:10.2f} ms  {ms / busy_ms:6.1%}")
    print("kernel time by phase and layer:")
    for name, ms in sorted(cross_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:48s} {ms:10.2f} ms  {ms / busy_ms:6.1%}")
    print("kernel time by group:")
    for name, ms in sorted(groups_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:38s} {ms:10.2f} ms  {ms / busy_ms:6.1%}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace_train_step.json"))
    print(json.dumps({"train_profile": {
        "device": smi, "height": H, "width": W, "views": V, "num_depth": D,
        "step_s": step_s, "profiled_wall_s": prof_wall_s, "peak_bytes": peak,
        "busy_share": busy_ms / 1e3 / prof_wall_s,
        "busy_share_of_step": busy_ms / 1e3 / mean_s, "kernels": n_kernels,
        "phase_ms": dict(phase_ms), "phase_layer_ms": dict(cross_ms),
        "groups_ms": dict(groups_ms), "gate_launches": list(launches),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
