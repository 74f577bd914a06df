"""Where the time of one depth map goes on the card.

    python -m aa_rmvsnet_tpu_torch.tools.profile_main_path
        [--config bf16-packed|fp32|levers] [--num-depth 64] [--out DIR]

Runs the port's ``forward`` at the ``dtu_eval`` geometry (864x1152, V=5,
depth_block 8), TF32 off, on the synthetic plane scene with seeded weights
(``utils/synthetic.py``; cameras 2 apart, so the packed gate passes), on
one CUDA device, in the configuration of ``cli eval``'s defaults
(``bf16-packed``: bf16, packed rows as ``resolve_packed_mode`` picks them,
fused residual), of ``--fp32 --packed_rows 0`` (``fp32``) or of the JAX
package's production stack ``--int8_tables --dual_residual --gather_pack
2 --table_taps 6`` (``levers``: bf16, int8 tables and the int8 blend, an
fp8 + int8 residual, omega's int8 rw0; packed mode (True, 2, 4) here):

1. a warm-up forward over one depth block;
2. a timed forward: host clock around ``forward`` and
   ``torch.cuda.synchronize()``;
3. the same forward under ``torch.profiler``: the device-timeline span of
   each layer (the profiler ranges in ``models/network.py``; a range that
   cuDNN spreads over its own streams, as it does the bf16 grouped
   convolutions of folded omega, counts once), the device's busy share of
   the profiled window (kernel time over wall time), and the kernels by
   device time; with ``levers`` also the span and kernel groups of each
   ``quant.*`` range inside the cost block (tables, the int8 blend, the
   residual's quantization, omega's int8 rw0, the variance's dequantization),
   which split the levers' passes from the rest;
4. omega's two forms on one view's residual of a depth block, by CUDA
   events: ``omega_folded`` (grouped convolutions on the folded residual
   as it lies) and the canonical module on the ``(8, 32, H, W)`` batch,
   with the transpose that batch needs.

The per-step cost does not depend on D, so a cut D (default 64) scales to
the full sweep: ``map_s_at_512`` = featnet + setup + 512 x the per-step
time (``--num-depth`` a multiple of 8, of 16 with ``levers``).  Prints a table and, last, one JSON line; ``--out DIR`` also writes
the Chrome trace there.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import time
from collections import defaultdict

import torch

from ..models.aggregation import omega_folded
from ..models.network import cast_model, forward
from ..ops import gates
from ..pipeline.infer import InferConfig, resolve_packed_mode, sweep_config
from ..utils.device import disable_tf32, resolve_device
from ..utils.synthetic import plane_scene, seeded_model

CONFIGS = {
    "bf16-packed": InferConfig(out_root=""),
    "fp32": InferConfig(out_root="", feature_dtype=torch.float32, packed_rows=False,
                        fused_residual=False),
    "levers": InferConfig(out_root="", table_dtype=torch.int8, residual_dtype="dual",
                          gather_pack=2, table_taps=6),
}
#: The packed mode each configuration must take on the profiled scene.
MODES = {"bf16-packed": (True, 1, 4), "levers": (True, 2, 4)}

LAYERS = ("featnet", "sweep.setup", "sweep.cost_block", "sweep.regularize", "sweep.wta")
#: The quantized levers' ranges, nested inside ``sweep.setup`` (tables) and
#: ``sweep.cost_block`` (the rest; the chain with ``AA_RMVSNET_OMEGA_INT8=chain``).
QUANT_RANGES = ("quant.tables", "quant.int8_blend", "quant.dequant_rows", "quant.residual",
                "quant.omega_input", "quant.omega_int8_rw0", "quant.omega_int8_chain",
                "quant.variance_dequant")
KERNEL_GROUPS = (  # first match wins; matched on the lower-cased kernel name
    ("lstm_gates (CUDA kernel of the port)", ("lstm_gates",)),
    ("convolution", ("conv", "gemm", "xmma", "winograd", "cudnn", "implicit", "fft")),
    ("gather", ("gather",)),
    ("group norm", ("norm", "moments", "welford")),
    ("reduction", ("reduce",)),
    ("elementwise / copy / other", ("",)),
)


def _group(name: str, groups=KERNEL_GROUPS) -> str:
    low = name.lower()
    return next(label for label, keys in groups if any(k in low for k in keys))


def device_breakdown(prof, layers, groups=KERNEL_GROUPS) -> tuple[dict, dict, dict, dict]:
    """``(layers_ms, kernels_ms, groups_ms, cross_ms)`` of a profile: the
    device-timeline span of each profiler range in ``layers``, and device
    time by kernel, by kernel group and by (range, group).  The other
    ranges' spans (a device event named as a host event) are neither
    layers nor kernels.

    On the device timeline a profiler range appears as a span over its
    kernels (and any idle gaps between them); everything else there is a
    kernel or a copy, and belongs to the range whose span holds its start.
    A range appears once on every stream that ran its kernels: the union of
    its intervals counts.
    """
    device_events = [ev for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
    ranges = {ev.name for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CPU}
    spans = []
    for name in layers:
        for start, end in sorted((ev.time_range.start, ev.time_range.end)
                                 for ev in device_events if ev.name == name):
            if spans and spans[-1][2] == name and start <= spans[-1][1]:
                spans[-1] = (spans[-1][0], max(end, spans[-1][1]), name)
            else:
                spans.append((start, end, name))
    spans.sort()
    starts = [start for start, _, _ in spans]
    layers_ms = {name: 0.0 for name in layers}
    for start, end, name in spans:
        layers_ms[name] += (end - start) / 1e3
    kernels_ms: dict[str, float] = defaultdict(float)
    groups_ms: dict[str, float] = defaultdict(float)
    cross_ms: dict[str, float] = defaultdict(float)
    for ev in device_events:
        if ev.name in ranges:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        i = bisect.bisect_right(starts, ev.time_range.start) - 1
        inside = i >= 0 and ev.time_range.start < spans[i][1]
        layer = spans[i][2] if inside else "(outside the ranges)"
        group = _group(ev.name, groups)
        kernels_ms[ev.name] += ms
        groups_ms[group] += ms
        cross_ms[f"{layer} / {group}"] += ms
    return layers_ms, kernels_ms, groups_ms, cross_ms


def _omega_forms_ms(model, H: int, W: int, dtype, block: int = 8) -> tuple[float, float]:
    """Device ms of omega on one view's folded residual ``(1, H, W,
    block*32)``: ``omega_folded`` on it as it lies, and the canonical
    module on the ``(block, 32, H, W)`` batch (transpose included)."""
    x = torch.rand(1, H, W, block * 32, device="cuda").to(dtype)

    def folded():
        omega_folded(model.omega, x, block)

    def canonical():
        batch = x.view(1, H, W, block, 32).permute(0, 3, 4, 1, 2).reshape(block, 32, H, W)
        model.omega(batch)

    times = []
    for fn in (folded, canonical, canonical, folded):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return min(times[0], times[3]), min(times[1], times[2])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default="bf16-packed",
                        help="cli eval's defaults (bf16-packed), its exact fp32 path, or "
                             "the production stack of quantized levers")
    parser.add_argument("--num-depth", type=int, default=64,
                        help="depth hypotheses to sweep (a multiple of 8)")
    parser.add_argument("--out", help="directory for the Chrome trace")
    args = parser.parse_args(argv)
    infer_config = CONFIGS[args.config]
    span = 8 * infer_config.gather_pack
    if args.num_depth % span:
        parser.error(f"--num-depth must be a multiple of {span} (depth block x gather_pack)")

    device = resolve_device("cuda")
    disable_tf32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    H, W, V, D = 864, 1152, 5, args.num_depth
    (sample,) = plane_scene(H, W, V, D, maps=1, seed=3, focal=2000.0, baseline=2.0,
                            plane_depth=600.0, depth_min=425.0, depth_interval=1.0)
    mode = resolve_packed_mode(sample, infer_config)
    if mode != MODES.get(args.config, mode):
        raise SystemExit(f"the packed gate picked {mode}, not {MODES[args.config]}")
    config = sweep_config(infer_config, mode)
    model = cast_model(seeded_model(0).to(device), config.feature_dtype)
    inputs = [torch.from_numpy(sample[k])[None].to(device)
              for k in ("imgs", "proj_matrices", "depth_values")]

    with torch.inference_mode():
        forward(model, inputs[0], inputs[1], inputs[2][:, :span], config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(model, *inputs, config)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            forward(model, *inputs, config)
            torch.cuda.synchronize()
            prof_wall_s = time.perf_counter() - t0
        omega_ms = _omega_forms_ms(model, H, W, config.feature_dtype)

    layers_ms, kernels_ms, groups_ms, cross_ms = device_breakdown(prof, LAYERS)
    quant_ms, _, _, quant_cross_ms = device_breakdown(prof, QUANT_RANGES)
    quant_cross_ms = {k: v for k, v in quant_cross_ms.items()
                      if not k.startswith("(outside the ranges)")}
    busy_ms = sum(kernels_ms.values())
    step_ms = sum(layers_ms[k] for k in LAYERS[2:]) / D
    map_s_at_512 = (layers_ms["featnet"] + layers_ms["sweep.setup"] + 512 * step_ms) / 1e3

    print(f"{smi}; forward at {H}x{W}, V={V}, D={D}, depth_block 8, {args.config} "
          f"(packed mode {mode}, TF32 off)")
    print(f"wall {wall_s:.3f} s unprofiled, {prof_wall_s:.3f} s profiled; device busy "
          f"{busy_ms / 1e3:.3f} s = {busy_ms / 1e3 / prof_wall_s:.1%} of the profiled window")
    print("device-timeline span by layer (profiler ranges):")
    for name in LAYERS:
        print(f"  {name:18s} {layers_ms[name]:10.2f} ms  "
              f"{layers_ms[name] / 1e3 / prof_wall_s:6.1%} of the window")
    print(f"  per depth step     {step_ms:10.3f} ms -> {map_s_at_512:.2f} s per map at D=512")
    print("device time by kernel group (share of kernel time):")
    for name, ms in sorted(groups_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:38s} {ms:10.2f} ms  {ms / busy_ms:6.1%}")
    if any(quant_ms.values()):
        print("quantized levers, device-timeline span by range (inside the layers above):")
        for name in QUANT_RANGES:
            print(f"  {name:24s} {quant_ms[name]:10.2f} ms  {quant_ms[name] / busy_ms:6.1%} "
                  "of kernel time")
        for name, ms in sorted(quant_cross_ms.items(), key=lambda kv: -kv[1]):
            print(f"  {name:56s} {ms:10.2f} ms  {ms / busy_ms:6.1%}")
    print("kernel time by layer and group:")
    for name, ms in sorted(cross_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:56s} {ms:10.2f} ms  {ms / busy_ms:6.1%}")
    top = sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:15]
    print("top kernels:")
    for name, ms in top:
        print(f"  {ms:10.2f} ms  {ms / busy_ms:6.1%}  {name[:110]}")
    print(f"omega on one view's block residual (1, {H}, {W}, 256): folded (grouped convs) "
          f"{omega_ms[0]:.3f} ms, canonical on the (8, 32, H, W) batch {omega_ms[1]:.3f} ms")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, f"trace_d{D}.json"))
    print(json.dumps({"profile": {
        "device": smi, "config": args.config, "packed_mode": mode,
        "height": H, "width": W, "views": V, "num_depth": D,
        "wall_s": wall_s, "profiled_wall_s": prof_wall_s,
        "busy_share": busy_ms / 1e3 / prof_wall_s, "layers_ms": layers_ms,
        "step_ms": step_ms, "map_s_at_512": map_s_at_512,
        "groups_ms": dict(groups_ms), "layer_groups_ms": dict(cross_ms),
        "gate_launches": gates.launches,
        "quant_ms": quant_ms, "quant_groups_ms": quant_cross_ms,
        "omega_ms": {"folded": omega_ms[0], "canonical": omega_ms[1]},
        "top_kernels_ms": dict(top),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
