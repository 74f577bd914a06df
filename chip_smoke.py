#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aa_rmvsnet_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:

1. device: the card's name and power limit, as ``nvidia-smi`` gives them;
2. build: every CUDA source of the port, compiled with nvcc;
3. kernel vs plain: the ConvLSTM gate kernel against its plain PyTorch
   version on the card, at the five cell shapes of a depth step of the
   main path (864x1152) and at an odd shape, fp32 (atol 1e-6) and bf16
   (atol 2e-2); kernel, plain, library-call times and the kernel's bound;
4. CUDA vs CPU: the whole ``forward`` at 64x80, V=3, D=48 on both devices
   (depth equal on >= 99.9 % of pixels, confidence atol 1e-4);
5. main path: ``run_inference`` at the ``dtu_eval`` geometry (V=5, D=512,
   864x1152, depth_block 8) on an in-memory synthetic plane scene
   (``utils/synthetic.py``) for two reference views, with the gate
   kernel's launch count asserted.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Weights are random, made from a seed
(``utils/synthetic.py:seeded_model``).
TF32 is off throughout: cuDNN would otherwise run the fp32 convolutions in
TF32, which keeps about three decimal digits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
# Main path: the dtu_eval preset geometry.
MAIN_H, MAIN_W, MAIN_V, MAIN_D, MAIN_BLOCK, MAIN_MAPS = 864, 1152, 5, 512, 8, 2
# Small whole-path check, CUDA against CPU.
SMALL_H, SMALL_W, SMALL_V, SMALL_D = 64, 80, 3, 48


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def memory_bytes_per_s() -> float:
    """Peak device-memory rate from the card's own clock and bus width
    (double data rate)."""
    props = torch.cuda.get_device_properties(0)
    return props.memory_clock_rate * 1e3 * 2 * props.memory_bus_width / 8


def phase_device() -> None:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False; this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, memory rate "
          f"{memory_bytes_per_s() / 1e12:.3f} TB/s (from clock and bus width)",
          flush=True)


def phase_build() -> None:
    from aa_rmvsnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} CUDA source(s) in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(p.name for p in libs), flush=True)


def _cell_shapes(H, W):
    """(B, hidden, h, w) of the five ConvLSTM cells of one depth step."""
    return [(1, 16, H, W), (1, 16, H // 2, W // 2), (1, 16, H // 4, W // 4),
            (1, 16, H // 2, W // 2), (1, 8, H, W)]


def _library_gates(z, c):
    """The same gate math as one PyTorch call (``nn.LSTMCell``'s fused CUDA
    cell), on ``(N, 4h)`` gates in its (i, f, g, o) order plus a zero
    hidden-gate tensor.  A yardstick only: the port never calls it."""
    return torch.ops.aten._thnn_fused_lstm_cell(z, torch.zeros_like(z), c)


def _to_library_layout(z, c):
    B, h4, H, W = z.shape
    h = h4 // 4
    zr = z.view(B, 4, h, H, W)[:, [0, 1, 3, 2]]  # (i, f, o, g) -> (i, f, g, o)
    zl = zr.permute(0, 3, 4, 1, 2).reshape(B * H * W, 4 * h).contiguous()
    cl = c.permute(0, 2, 3, 1).reshape(B * H * W, h).contiguous()
    return zl, cl


def phase_kernel() -> dict:
    from aa_rmvsnet_tpu_torch.ops import gates

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cells = _cell_shapes(MAIN_H, MAIN_W)
    odd = [(2, 16, 9, 13), (2, 8, 9, 13)]
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bars = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
    fp32_inputs = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in cells + odd:
                B, h, H, W = shape
                z = torch.randn(B, 4 * h, H, W, device="cuda", generator=gen)
                if dtype == torch.float32:
                    c = torch.randn(B, h, H, W, device="cuda", generator=gen)
                else:
                    # |c'| < 2 keeps one bf16 ulp of the output (<= 2^-7)
                    # inside the 2e-2 bar; larger cells round across ulps.
                    c = torch.rand(B, h, H, W, device="cuda", generator=gen) * 2 - 1
                z, c = z.to(dtype), c.to(dtype)
                h_k, c_k = gates.lstm_gates(z, c)
                torch.cuda.synchronize()
                h_p, c_p = gates.lstm_gates_reference(z, c)
                err = max((h_k.float() - h_p.float()).abs().max().item(),
                          (c_k.float() - c_p.float()).abs().max().item())
                ok = err <= bars[dtype]
                print(f"kernel: lstm_gates {str(dtype)[6:]} {shape} max_abs_err "
                      f"{err:.3e} (bar {bars[dtype]:g}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    _fail(f"lstm_gates disagrees with its plain version at {shape} {dtype}")
                max_err[dtype] = max(max_err[dtype], err)
                if dtype == torch.float32 and shape in cells:
                    fp32_inputs.append((z, c))

        # One depth step's five launches in main-path order: 0.92 GB, far
        # beyond the 50 MB L2, so each launch finds its inputs cold.
        def kernel_step():
            for z, c in fp32_inputs:
                gates.lstm_gates(z, c)

        def plain_step():
            for z, c in fp32_inputs:
                gates.lstm_gates_reference(z, c)

        lib_inputs = [_to_library_layout(z, c) for z, c in fp32_inputs]
        lib_err = 0.0
        for (z, c), (zl, cl) in zip(fp32_inputs, lib_inputs):
            hy, cy, _ = _library_gates(zl, cl)
            h_p, c_p = gates.lstm_gates_reference(z, c)
            B, h, H, W = c.shape
            h_p = h_p.permute(0, 2, 3, 1).reshape(-1, h)
            c_p = c_p.permute(0, 2, 3, 1).reshape(-1, h)
            lib_err = max(lib_err, (hy - h_p).abs().max().item(),
                          (cy - c_p).abs().max().item())
        if lib_err > 1e-5:
            _fail(f"library yardstick computes another function (err {lib_err:.3e})")

        def library_step():
            for zl, cl in lib_inputs:
                _library_gates(zl, cl)

        ms = _cuda_time_ms(kernel_step, reps=50)
        plain_ms = _cuda_time_ms(plain_step, reps=10)
        library_ms = _cuda_time_ms(library_step, reps=20)
        ms_again = _cuda_time_ms(kernel_step, reps=50)

    elems = sum(B * h * H * W for B, h, H, W in cells)
    nbytes = elems * 4 * (4 + 1 + 2)  # read i, f, o, g, c; write h', c'
    bytes_ms = nbytes / memory_bytes_per_s() * 1e3
    # ~30 fp32 operations per element (3 sigmoids, 2 tanh, 3 FMAs) at the
    # card's 67 TFLOP/s non-tensor fp32 peak: far under the byte bound.
    ops_ms = elems * 30 / 67e12 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"kernel: one depth step = 5 launches, {elems / 1e6:.2f} M elements, "
          f"{nbytes / 1e9:.3f} GB: kernel {ms:.4f} ms (again {ms_again:.4f}), "
          f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
          f"(_thnn_fused_lstm_cell, max_abs_err vs plain {lib_err:.1e}), "
          f"bound {bound_ms:.4f} ms by bytes ({bytes_ms / ms:.0%} of it)", flush=True)
    return {
        "name": "lstm_gates",
        "route": "cuda",
        "source": "aa_rmvsnet_tpu_torch/csrc/lstm_gates.cu",
        "replaces": "aa_rmvsnet_tpu/ops/pallas/gates.py:41",
        "launches": None,
        "max_abs_err": max_err[torch.float32],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def phase_small() -> None:
    from aa_rmvsnet_tpu_torch.models import SweepConfig, forward
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_model

    (sample,) = plane_scene(SMALL_H, SMALL_W, SMALL_V, SMALL_D, maps=1, seed=SEED + 2,
                            focal=400.0, baseline=2.0, plane_depth=500.0,
                            depth_min=425.0, depth_interval=2.5)
    model = seeded_model(SEED)
    config = SweepConfig(depth_block=8, collect_volume=False)
    outs = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            model.to(dev)
            args = [torch.from_numpy(sample[k])[None].to(dev)
                    for k in ("imgs", "proj_matrices", "depth_values")]
            before = gates.launches
            t0 = time.perf_counter()
            out = forward(model, *args, config)
            outs[dev] = {k: v.cpu().numpy() for k, v in out.items()}
            dt = time.perf_counter() - t0
            launched = gates.launches - before
            print(f"small: forward on {dev} in {dt:.2f} s, gate kernel launches "
                  f"{launched}", flush=True)
            if dev == "cuda" and launched != 5 * SMALL_D:
                _fail(f"small CUDA forward launched the gate kernel {launched} times")
    same = np.mean(outs["cpu"]["depth"] == outs["cuda"]["depth"])
    conf_err = np.abs(outs["cpu"]["photometric_confidence"]
                      - outs["cuda"]["photometric_confidence"]).max()
    ok = same >= 0.999 and conf_err <= 1e-4
    print(f"small: CUDA vs CPU at {SMALL_H}x{SMALL_W}, V={SMALL_V}, D={SMALL_D}: depth "
          f"equal on {same:.4%} of pixels (bar 99.9%), confidence max_abs_err "
          f"{conf_err:.3e} (bar 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail("CUDA forward disagrees with the CPU forward")


def phase_main() -> int:
    from aa_rmvsnet_tpu_torch.core.pfm import read_pfm
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_model

    depth_min, depth_interval = 425.0, 1.0
    samples = plane_scene(MAIN_H, MAIN_W, MAIN_V, MAIN_D, maps=MAIN_MAPS, seed=SEED + 3,
                          focal=2000.0, baseline=10.0, plane_depth=600.0,
                          depth_min=depth_min, depth_interval=depth_interval)
    model = seeded_model(SEED)
    with tempfile.TemporaryDirectory() as out_root:
        torch.cuda.reset_peak_memory_stats()
        gates.launches = 0
        stats = run_inference(
            model, samples,
            InferConfig(out_root=out_root, depth_block=MAIN_BLOCK, num_workers=2,
                        device="cuda"),
        )
        launches = gates.launches
        peak = torch.cuda.max_memory_allocated()
        expect = 5 * MAIN_D * MAIN_MAPS
        if stats["count"] != MAIN_MAPS or launches != expect:
            _fail(f"main path wrote {stats['count']} maps with {launches} gate "
                  f"kernel launches; expected {MAIN_MAPS} and {expect}")
        depth_max = depth_min + depth_interval * (MAIN_D - 1)
        for ref in range(MAIN_MAPS):
            depth, _ = read_pfm(os.path.join(out_root, "scan1", "depth_est_0",
                                             f"{ref:08d}.pfm"))
            conf, _ = read_pfm(os.path.join(out_root, "scan1", "confidence_0",
                                            f"{ref:08d}.pfm"))
            if depth.shape != (MAIN_H, MAIN_W) or conf.shape != (MAIN_H, MAIN_W):
                _fail(f"map {ref}: shapes {depth.shape} / {conf.shape}")
            if not (np.isfinite(depth).all() and np.isfinite(conf).all()):
                _fail(f"map {ref}: non-finite values")
            if depth.min() < depth_min or depth.max() > depth_max:
                _fail(f"map {ref}: depth outside the sweep [{depth_min}, {depth_max}]")
            if conf.min() <= 0.0 or conf.max() > 1.0 + 1e-6:
                _fail(f"map {ref}: confidence outside (0, 1]")
    secs = ", ".join(f"{s:.3f}" for s in stats["map_seconds"])
    print(f"main: run_inference at {MAIN_H}x{MAIN_W}, V={MAIN_V}, D={MAIN_D}, "
          f"depth_block {MAIN_BLOCK}: {MAIN_MAPS} maps, seconds per map [{secs}], "
          f"peak memory {peak / 2**30:.2f} GiB, gate kernel launches {launches} "
          f"(= 5 x {MAIN_D} x {MAIN_MAPS}); PFMs finite, depth in the sweep, "
          "confidence in (0, 1]", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    try:
        import aa_rmvsnet_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run from the "
              "root of the repository", file=sys.stderr)
        return 1
    from aa_rmvsnet_tpu_torch.utils.device import disable_tf32

    disable_tf32()
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kernel = phase_kernel()
    phase_small()
    kernel["launches"] = phase_main()
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
