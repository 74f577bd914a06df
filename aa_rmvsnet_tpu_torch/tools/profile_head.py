"""Where the time of the evidential head goes on the card.

    python -m aa_rmvsnet_tpu_torch.tools.profile_head [--num-depth 512] [--out DIR]

Runs ``evidential_apply`` (the fp32 softmax of the cost volume, then the
head, TF32 off) as ``run_inference`` runs it behind ``cli eval
--evidential_ckpt``, at the ``dtu_eval`` geometry (a ``(1, D, 864, 1152)``
cost volume of seeded N(0, 3^2) logits; seeded head weights,
``utils/synthetic.py:seeded_head``), on one CUDA device:

1. a warm-up run, in which hooks on every 3D convolution count the
   floating-point operations its shapes need;
2. two timed runs: host clock around the call and ``torch.cuda.synchronize()``,
   with the peak memory of each;
3. one run under ``torch.profiler``: the device-timeline span of each stage
   (the profiler ranges in ``models/evidential.py``), the device's busy
   share, kernel time by group and the top kernels, and the convolutions'
   achieved TFLOP/s against the card's 67 TFLOP/s fp32 peak outside the
   tensor cores;
4. the head's full-resolution transposed convolution alone (``dres3.conv6``,
   64 -> 32 channels to 32x864x1152), by CUDA events, in turns: as the head
   runs it, in the channels-last-3d layout, under ``cudnn.benchmark``, and
   as eight forward convolutions, one per output parity
   (:func:`deconv_by_phases`, the same multiply-adds), each held to the
   first.  A yardstick for a later change: the head runs only the first.

Prints a table and, last, one JSON line; ``--out DIR`` also writes the
Chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.evidential import evidential_apply
from ..utils.device import disable_tf32, resolve_device
from ..utils.synthetic import seeded_head
from .profile_main_path import device_breakdown

STAGES = ("evidential.volumes", "evidential.dres", "evidential.hourglass_up",
          "evidential.hourglass", "evidential.classify")
KERNEL_GROUPS = (  # first match wins; matched on the lower-cased kernel name
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw")),
    ("transposed convolution (cuDNN dgrad)", ("dgrad",)),
    ("convolution", ("conv", "gemm", "xmma", "winograd", "cudnn", "implicit", "fft")),
    ("softmax", ("softmax",)),
    ("resize", ("upsample", "interp")),
    ("reduction", ("reduce",)),
    ("elementwise / copy / other", ("",)),
)
FP32_PEAK_FLOPS = 67e12


def _conv_flops(module: nn.Module, inputs, output) -> float:
    """Multiply-adds x 2 of one Conv3d or ConvTranspose3d call."""
    kernel = math.prod(module.kernel_size)
    if isinstance(module, nn.ConvTranspose3d):  # every input voxel feeds k^3 outputs
        return 2.0 * inputs[0].numel() * module.out_channels * kernel
    return 2.0 * output.numel() * module.in_channels * kernel


def deconv_by_phases(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``conv_transpose3d(x, weight, stride=2, padding=1, output_padding=1)``
    as eight forward convolutions over the input grid, one per output
    parity: along an axis, output 2m takes tap 1 of input m, and output
    2m + 1 taps 2 and 0 of inputs m and m + 1 (zero past the end)."""
    B, _, D, H, W = x.shape
    out = x.new_empty(B, weight.shape[1], 2 * D, 2 * H, 2 * W)
    taps = ([1], [2, 0])
    padded = F.pad(x, (0, 1, 0, 1, 0, 1))
    w = weight.transpose(0, 1)  # (out, in, kd, kh, kw)
    for pd in (0, 1):
        for ph in (0, 1):
            for pw in (0, 1):
                k = w[:, :, taps[pd]][:, :, :, taps[ph]][:, :, :, :, taps[pw]]
                out[:, :, pd::2, ph::2, pw::2] = F.conv3d(
                    padded[:, :, :D + pd, :H + ph, :W + pw], k)
    return out


def _deconv_forms_ms(head, H: int, W: int, gen) -> dict:
    """Device ms and max_abs_err against the head's own call of the
    full-resolution transposed convolution, for each of its forms."""
    deconv = head.dres3.conv6[0]
    x = torch.randn(1, deconv.in_channels, head.maxdisp // 2, H // 2, W // 2,
                    device="cuda", generator=gen)
    x_cl = x.contiguous(memory_format=torch.channels_last_3d)
    w_cl = deconv.weight.contiguous(memory_format=torch.channels_last_3d)

    def as_head():
        return deconv(x)

    def channels_last():
        return F.conv_transpose3d(x_cl, w_cl, stride=2, padding=1, output_padding=1)

    def benchmark():
        torch.backends.cudnn.benchmark = True
        try:
            return deconv(x)
        finally:
            torch.backends.cudnn.benchmark = False

    def phases():
        return deconv_by_phases(x, deconv.weight)

    forms = {"as_head": as_head, "channels_last_3d": channels_last,
             "cudnn_benchmark": benchmark, "eight_phases": phases}
    ref = as_head()
    errs = {name: (fn() - ref).abs().max().item() for name, fn in forms.items()}
    del ref
    times = defaultdict(list)
    for name in list(forms) + list(forms)[::-1]:
        for _ in range(2):
            forms[name]()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            forms[name]()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / 3)
    return {name: {"ms": min(times[name]), "max_abs_err": errs[name]} for name in forms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-depth", type=int, default=512,
                        help="depth hypotheses of the cost volume")
    parser.add_argument("--out", help="directory for the Chrome trace")
    args = parser.parse_args(argv)

    device = resolve_device("cuda")
    disable_tf32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    H, W, D = 864, 1152, args.num_depth
    gen = torch.Generator(device=device).manual_seed(0)
    head = seeded_head(0).to(device)
    dvals = torch.from_numpy((425.0 + np.arange(D, dtype=np.float32))[None]).to(device)

    def cost_volume():
        return 3.0 * torch.randn(1, D, H, W, device=device, generator=gen)

    flops = []
    hooks = [m.register_forward_hook(lambda m, i, o: flops.append(_conv_flops(m, i, o)))
             for m in head.modules() if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d))]
    with torch.inference_mode():
        evidential_apply(head, cost_volume(), dvals)
        torch.cuda.synchronize()
        for hook in hooks:
            hook.remove()
        wall_s, peak = [], []
        for _ in range(2):
            # The head gets the volume's last reference, as in run_inference.
            volume = [cost_volume()]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = evidential_apply(head, volume.pop(), dvals)
            gamma = out["gamma"].cpu()
            del out
            torch.cuda.synchronize()
            wall_s.append(time.perf_counter() - t0)
            peak.append(torch.cuda.max_memory_allocated())
        if not torch.isfinite(gamma).all():
            raise SystemExit("profile_head: non-finite gamma")

        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        volume = [cost_volume()]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            out = evidential_apply(head, volume.pop(), dvals)
            out["gamma"].cpu()
            del out
            torch.cuda.synchronize()
            prof_wall_s = time.perf_counter() - t0
        deconv_forms = _deconv_forms_ms(head, H, W, gen)

    stages_ms, kernels_ms, groups_ms, cross_ms = device_breakdown(prof, STAGES, KERNEL_GROUPS)
    busy_ms = sum(kernels_ms.values())
    conv_tflop = sum(flops) / 1e12
    conv_ms = groups_ms.get("convolution", 0.0) + groups_ms.get(
        "transposed convolution (cuDNN dgrad)", 0.0)
    conv_rate = conv_tflop / (conv_ms / 1e3) if conv_ms else float("nan")

    print(f"{smi}; evidential head at {H}x{W}, D={D} -> maxdisp {head.maxdisp}, fp32, "
          "TF32 off")
    print(f"wall {', '.join(f'{s:.3f}' for s in wall_s)} s unprofiled (peak memory "
          f"{', '.join(f'{p / 2**30:.2f}' for p in peak)} GiB), {prof_wall_s:.3f} s profiled; "
          f"device busy {busy_ms / 1e3:.3f} s = {busy_ms / 1e3 / prof_wall_s:.1%} of the window")
    print(f"3D convolutions: {len(flops)} calls, {conv_tflop:.2f} TFLOP from their shapes, "
          f"{conv_ms:.1f} ms of kernel time: {conv_rate:.1f} TFLOP/s, "
          f"{conv_rate * 1e12 / FP32_PEAK_FLOPS:.0%} of the 67 TFLOP/s fp32 peak")
    print("device-timeline span by stage (profiler ranges):")
    for name in STAGES:
        print(f"  {name:26s} {stages_ms[name]:10.2f} ms  "
              f"{stages_ms[name] / 1e3 / prof_wall_s:6.1%} of the window")
    print("device time by kernel group (share of kernel time):")
    for name, ms in sorted(groups_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:30s} {ms:10.2f} ms  {ms / busy_ms:6.1%}")
    print("kernel time by stage and group:")
    for name, ms in sorted(cross_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:60s} {ms:10.2f} ms  {ms / busy_ms:6.1%}")
    top = sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:15]
    print("top kernels:")
    for name, ms in top:
        print(f"  {ms:10.2f} ms  {ms / busy_ms:6.1%}  {name[:110]}")
    deconv = head.dres3.conv6[0]
    deconv_tflop = 2.0 * deconv.in_channels * deconv.out_channels * 27 * (
        head.maxdisp // 2) * (H // 2) * (W // 2) / 1e12
    print(f"the full-resolution transposed convolution alone ({deconv.in_channels} -> "
          f"{deconv.out_channels} channels to {head.maxdisp}x{H}x{W}, {deconv_tflop:.3f} TFLOP):")
    for name, form in deconv_forms.items():
        print(f"  {name:18s} {form['ms']:9.2f} ms  {deconv_tflop / form['ms'] * 1e3:6.2f} TFLOP/s"
              f"  max_abs_err vs as_head {form['max_abs_err']:.2e}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, f"trace_head_d{D}.json"))
    print(json.dumps({"profile_head": {
        "device": smi, "height": H, "width": W, "num_depth": D, "maxdisp": head.maxdisp,
        "wall_s": wall_s, "peak_bytes": peak, "profiled_wall_s": prof_wall_s,
        "busy_share": busy_ms / 1e3 / prof_wall_s, "stages_ms": stages_ms,
        "groups_ms": dict(groups_ms), "stage_groups_ms": dict(cross_ms),
        "conv_calls": len(flops), "conv_tflop": conv_tflop, "conv_tflops_per_s": conv_rate,
        "top_kernels_ms": dict(top), "deconv_forms": deconv_forms,
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
