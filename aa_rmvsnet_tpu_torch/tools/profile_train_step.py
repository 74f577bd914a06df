"""Where the time of one training step goes on the card.

    python -m aa_rmvsnet_tpu_torch.tools.profile_train_step [--steps 3] [--evidential]
        [--bf16] [--fold_omega {0,1,hybrid}] [--out DIR]

Runs ``pipeline/train.py:train_step`` at the ``dtu_train`` geometry
(128x160, V=5, D=128, depth_block 16, batch 1, Adam, fp32 without TF32)
on the synthetic plane sample with seeded weights (``utils/synthetic.py``),
on one CUDA device; with ``--evidential``, the step of ``cli train
--evidential`` (a fresh head from seed 1, maxdisp 32, ``loss_emvsnet``);
``--bf16`` and ``--fold_omega`` set ``TrainConfig.feature_dtype`` and
``fold_omega`` (the sweep in bf16 on fp32 master weights; folded omega):

1. one warm-up step (with ``--evidential``, hooks on the head's 3D
   convolutions count the floating-point operations their shapes need);
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
   block; the rest is the backward proper.  With ``--evidential`` the
   forward's head kernels fall in the head's ranges (``evidential.*``), and
   the backward runs in two phases, the head's (from the loss to the
   probability volume) and the core's (from there, with the recompute),
   the same gradients as one backward; kernels are grouped finer (forward,
   data-gradient and weight-gradient convolutions, BatchNorm forward and
   backward), and the head's backward by group is printed apart, with the
   achieved TFLOP/s of its weight and data gradients (each the same
   operations as the forward convolutions it differentiates).

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
from torch import nn
from torch.profiler import record_function

from ..data.loader import batch_samples
from ..ops import gates
from ..models.evidential import EvidentialHead, loss_emvsnet
from ..models.network import forward, probability_volume
from ..pipeline.train import (
    TrainConfig,
    batch_to_device,
    loss_fn,
    make_optimizer,
    train_step,
    trainable_parameters,
)
from ..utils.device import disable_tf32, resolve_device
from ..utils.synthetic import plane_train_sample, seeded_model
from .profile_head import STAGES as HEAD_RANGES
from .profile_head import _conv_flops
from .profile_main_path import KERNEL_GROUPS, _group

PHASES = ("phase.forward", "phase.backward", "phase.backward_head", "phase.backward_core",
          "phase.optimizer")
SWEEP_RANGES = ("featnet", "sweep.setup", "sweep.cost_block", "sweep.regularize", "sweep.wta")
EVIDENTIAL_GROUPS = (  # first match wins; matched on the lower-cased kernel name
    ("lstm_gates (CUDA kernel of the port)", ("lstm_gates",)),
    ("batch norm backward", ("bn_bw", "batch_norm_backward", "batchnorm_backward")),
    ("batch norm forward", ("bn_fw", "batch_norm", "batchnorm")),
    ("convolution data gradient (dgrad)", ("dgrad",)),
    ("convolution weight gradient (wgrad)", ("wgrad",)),
) + KERNEL_GROUPS[1:]


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
    parser.add_argument("--evidential", action="store_true",
                        help="train the evidential head with the core (cli train --evidential)")
    parser.add_argument("--bf16", action="store_true",
                        help="TrainConfig(feature_dtype=torch.bfloat16)")
    parser.add_argument("--fold_omega", default="0", choices=("0", "1", "hybrid"),
                        help="TrainConfig.fold_omega: False, True or 'hybrid'")
    parser.add_argument("--out", help="directory for the Chrome trace")
    args = parser.parse_args(argv)
    fold_omega = {"0": False, "1": True, "hybrid": "hybrid"}[args.fold_omega]
    dtype = torch.bfloat16 if args.bf16 else torch.float32

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
    head = None
    if args.evidential:
        head = EvidentialHead(32, generator=torch.Generator().manual_seed(1)).to(device)
    config = TrainConfig(depth_block=16, device="cuda", evidential=args.evidential,
                         feature_dtype=dtype, fold_omega=fold_omega)
    optimizer, scheduler = make_optimizer(trainable_parameters(model, head), config,
                                          total_steps=10**6)
    groups = EVIDENTIAL_GROUPS if args.evidential else KERNEL_GROUPS

    def step():
        metrics, _ = train_step(model, optimizer, scheduler, batch, config, head)
        torch.cuda.synchronize()
        return float(metrics["loss"])

    flops = {"conv": 0.0, "transposed": 0.0}  # the head's forward 3D convolutions

    def count(module, inputs, output):
        key = "transposed" if isinstance(module, nn.ConvTranspose3d) else "conv"
        flops[key] += _conv_flops(module, inputs, output)

    hooks = [] if head is None else [
        m.register_forward_hook(count) for m in head.modules()
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d))]
    step()
    for hook in hooks:
        hook.remove()
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
        if head is None:
            with record_function("phase.forward"):
                loss, _ = loss_fn(model, batch, config.sweep(remat=True))
                torch.cuda.synchronize()
            with record_function("phase.backward"):
                loss.backward()
                torch.cuda.synchronize()
        else:
            head.train()
            with record_function("phase.forward"):
                out = forward(model, batch["imgs"], batch["proj_matrices"],
                              batch["depth_values"], config.sweep(remat=True))
                prob = probability_volume(out.pop("cost_volume"))
                # The head reads a leaf copy, so that its backward ends there.
                prob_leaf = prob.detach().requires_grad_()
                ev = head(prob_leaf, batch["depth_values"])
                loss = loss_emvsnet(ev["gamma"], ev["nu"], ev["alpha"], ev["beta"],
                                    batch["depth"], batch["mask"], config.evidential_weight_reg)
                torch.cuda.synchronize()
            with record_function("phase.backward_head"):
                loss.backward()
                torch.cuda.synchronize()
            with record_function("phase.backward_core"):
                prob.backward(prob_leaf.grad)
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
    layer_names = SWEEP_RANGES + (HEAD_RANGES if args.evidential else ())
    sweep_spans = [(ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in device_events if ev.name in layer_names]
    ranges = PHASES + layer_names
    cross_ms: dict[str, float] = defaultdict(float)
    groups_ms: dict[str, float] = defaultdict(float)
    phase_groups_ms: dict[str, float] = defaultdict(float)
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
        group = _group(ev.name, groups)
        groups_ms[group] += ms
        phase_groups_ms[f"{phase} / {group}"] += ms
    busy_ms = sum(groups_ms.values())
    phase_ms: dict[str, float] = defaultdict(float)
    for key, ms in cross_ms.items():
        phase, layer = key.split(" / ")
        if phase.startswith("backward"):
            phase += ": recompute" if layer.startswith("sweep.") else ": backward proper"
        phase_ms[phase] += ms

    print(f"{smi}; train_step at {H}x{W}, V={V}, D={D}, depth_block 16, batch 1, "
          f"{'bf16 sweep on fp32 weights' if args.bf16 else 'fp32'} (TF32 off), fold_omega "
          f"{fold_omega!r}{', evidential head, maxdisp 32' if head is not None else ''}")
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
    if head is not None:
        head_ms = sum(ms for name, ms in phase_groups_ms.items()
                      if name.startswith("backward_head / "))
        print(f"the head's backward ({head_ms:.2f} ms) by group:")
        for name, ms in sorted(phase_groups_ms.items(), key=lambda kv: -kv[1]):
            if name.startswith("backward_head / "):
                print(f"  {name:60s} {ms:10.2f} ms  {ms / head_ms:6.1%}")
        total_tflop = (flops["conv"] + flops["transposed"]) / 1e12
        for label, group, tflop in (
                ("weight gradients of all", "convolution weight gradient (wgrad)", total_tflop),
                ("data gradients of the forward", "convolution data gradient (dgrad)",
                 flops["conv"] / 1e12)):
            ms = phase_groups_ms.get(f"backward_head / {group}", 0.0)
            print(f"the head's {label} 3D convolutions: {tflop:.3f} TFLOP in {ms:.2f} ms, "
                  f"{tflop / (ms / 1e3) if ms else float('nan'):.2f} TFLOP/s")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace_train_step.json"))
    print(json.dumps({"train_profile": {
        "device": smi, "height": H, "width": W, "views": V, "num_depth": D,
        "step_s": step_s, "profiled_wall_s": prof_wall_s, "peak_bytes": peak,
        "busy_share": busy_ms / 1e3 / prof_wall_s,
        "busy_share_of_step": busy_ms / 1e3 / mean_s, "kernels": n_kernels,
        "phase_ms": dict(phase_ms), "phase_layer_ms": dict(cross_ms),
        "groups_ms": dict(groups_ms), "phase_groups_ms": dict(phase_groups_ms),
        "gate_launches": list(launches), "evidential": args.evidential,
        "feature_dtype": str(dtype), "fold_omega": fold_omega,
        "head_conv_tflop": flops["conv"] / 1e12,
        "head_transposed_conv_tflop": flops["transposed"] / 1e12,
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
