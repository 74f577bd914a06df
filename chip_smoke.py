#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aa_rmvsnet_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:

1. device: the card's name and power limit, as ``nvidia-smi`` gives them;
2. build: every CUDA source of the port, compiled with nvcc;
3. kernel vs plain: the ConvLSTM gate kernel against its plain PyTorch
   version on the card, at the five cell shapes of a depth step of the
   inference main path (864x1152) and at an odd shape, fp32 (atol 1e-6)
   and bf16 (atol 2e-2); kernel, plain, library-call times and the
   kernel's bound;
3b. backward kernel vs plain: the ConvLSTM gate-backward kernel against
   its plain version at the same shapes, fp32 (atol 1e-5) and bf16 (atol
   5e-2); kernel, plain and library-call times per depth step and the
   kernel's bound;
4. CUDA vs CPU: the whole ``forward`` at 64x80, V=3, D=48 on both devices
   (depth equal on >= 99.9 % of pixels, confidence atol 1e-4);
4b. CUDA vs CPU training gradients: one remat training forward and
   backward at 64x80, V=3, D=16, depth_block 8 on both devices.  Loss rtol
   1e-5.  Gradients: each tensor's max_abs_err over max(max|g|, 1e-3)
   (the normalised bar of ``tests/test_train.py:246-249``), worst tensor
   within max(1e-3, 10 x the CPU gradients' own move when every weight is
   scaled by 1 + 1e-7 noise).  The loss is piecewise smooth (ReLU,
   max-pool, the sampler's integer coordinates), and one rounding's worth
   of change in the weights already moves some gradients by more than
   1e-3 of their size: a fixed 1e-3 bar would test rounding, not the
   kernels.  The deformable convs' offset kernels start at zero, the
   reference's init, so that no deform sample sits within an ulp of an
   integer coordinate, where the sampler's gradient jumps;
5. main path, inference: ``run_inference`` at the ``dtu_eval`` geometry
   (V=5, D=512, 864x1152, depth_block 8) on an in-memory synthetic plane
   scene (``utils/synthetic.py``) for two reference views, with the gate
   kernels' launch counts asserted (5 x D forward, no backward);
6. main path, training: ``run_training`` at the ``dtu_train`` geometry
   (128x160, V=5, D=128, depth_block 16, batch 1, Adam 1e-3 on the
   cosine schedule of a 10-epoch DTU run) for 8 steps on one synthetic
   plane sample, with a falling loss, 2 x 5 x D forward and 5 x D
   backward gate-kernel launches per step (forward, recompute, backward),
   and a checkpoint that restores bit for bit and trains one more step.

The line before the last is ``{"kernels": [...]}``; each kernel's
``launches`` is its count on the training main path (phase 6), and
``launches_by_path`` gives it for both main paths.  The last line is
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
from dataclasses import replace

import numpy as np
import torch

SEED = 0
# Main path: the dtu_eval preset geometry.
MAIN_H, MAIN_W, MAIN_V, MAIN_D, MAIN_BLOCK, MAIN_MAPS = 864, 1152, 5, 512, 8, 2
# Small whole-path check, CUDA against CPU.
SMALL_H, SMALL_W, SMALL_V, SMALL_D = 64, 80, 3, 48
# Small training check, CUDA against CPU.
GRAD_D, GRAD_BLOCK = 16, 8
# Training main path: the dtu_train preset geometry, 8 steps.
TRAIN_H, TRAIN_W, TRAIN_V, TRAIN_D, TRAIN_BLOCK, TRAIN_STEPS = 128, 160, 5, 128, 16, 8
# Cosine schedule length of a 10-epoch DTU run: 79 training scans x 49
# reference views x 7 lights x 2 sweep directions per epoch.
DTU_TRAIN_TOTAL_STEPS = 10 * 79 * 49 * 7 * 2


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


def _library_gates_backward(dhl, dcl, cl, cyl, workspace):
    """The same backward as one PyTorch call (``nn.LSTMCell``'s fused CUDA
    cell backward), on the ``(N, 4h)`` layout with the forward's workspace
    of activated gates.  A yardstick only: the port never calls it."""
    return torch.ops.aten._thnn_fused_lstm_cell_backward_impl(dhl, dcl, cl, cyl,
                                                              workspace, False)


def phase_backward_kernel() -> dict:
    from aa_rmvsnet_tpu_torch.ops import gates

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cells = _cell_shapes(MAIN_H, MAIN_W)
    odd = [(2, 16, 9, 13), (2, 8, 9, 13)]
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bars = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
    fp32_inputs = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in cells + odd:
                B, h, H, W = shape
                z = torch.randn(B, 4 * h, H, W, device="cuda", generator=gen)
                if dtype == torch.float32:
                    c, dh, dcn = (torch.randn(B, h, H, W, device="cuda", generator=gen)
                                  for _ in range(3))
                else:
                    # Inputs in (-1, 1) keep every output below 2 in
                    # magnitude, where one bf16 ulp (<= 2^-7) is inside the
                    # bar; kernel and plain version may round one ulp apart.
                    c, dh, dcn = (torch.rand(B, h, H, W, device="cuda", generator=gen) * 2 - 1
                                  for _ in range(3))
                z, c, dh, dcn = (t.to(dtype) for t in (z, c, dh, dcn))
                dz_k, dc_k = gates.lstm_gates_backward(z, c, dh, dcn)
                torch.cuda.synchronize()
                dz_p, dc_p = gates.lstm_gates_backward_reference(z, c, dh, dcn)
                err = max((dz_k.float() - dz_p.float()).abs().max().item(),
                          (dc_k.float() - dc_p.float()).abs().max().item())
                ok = err <= bars[dtype]
                print(f"kernel: lstm_gates_backward {str(dtype)[6:]} {shape} max_abs_err "
                      f"{err:.3e} (bar {bars[dtype]:g}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    _fail(f"lstm_gates_backward disagrees with its plain version at "
                          f"{shape} {dtype}")
                max_err[dtype] = max(max_err[dtype], err)
                if dtype == torch.float32 and shape in cells:
                    fp32_inputs.append((z, c, dh, dcn))

        # One depth step's five backward launches, 1.58 GB: every launch
        # finds its inputs cold in the 50 MB L2.
        def kernel_step():
            for args in fp32_inputs:
                gates.lstm_gates_backward(*args)

        def plain_step():
            for args in fp32_inputs:
                gates.lstm_gates_backward_reference(*args)

        lib_inputs = []
        lib_err = 0.0
        for z, c, dh, dcn in fp32_inputs:
            zl, cl = _to_library_layout(z, c)
            _, cyl, workspace = _library_gates(zl, cl)
            h = c.shape[1]
            dhl = dh.permute(0, 2, 3, 1).reshape(-1, h).contiguous()
            dcl = dcn.permute(0, 2, 3, 1).reshape(-1, h).contiguous()
            lib_inputs.append((dhl, dcl, cl, cyl, workspace))
            dgates, dcx, _ = _library_gates_backward(*lib_inputs[-1])
            dz_p, dc_p = gates.lstm_gates_backward_reference(z, c, dh, dcn)
            dz_pl, _ = _to_library_layout(dz_p, dc_p)
            lib_err = max(lib_err, (dgates - dz_pl).abs().max().item(),
                          (dcx - dc_p.permute(0, 2, 3, 1).reshape(-1, h)).abs().max().item())
        if lib_err > 1e-5:
            _fail(f"backward library yardstick computes another function (err {lib_err:.3e})")

        def library_step():
            for args in lib_inputs:
                _library_gates_backward(*args)

        ms = _cuda_time_ms(kernel_step, reps=50)
        plain_ms = _cuda_time_ms(plain_step, reps=10)
        library_ms = _cuda_time_ms(library_step, reps=20)
        ms_again = _cuda_time_ms(kernel_step, reps=50)

    elems = sum(B * h * H * W for B, h, H, W in cells)
    nbytes = elems * 4 * (7 + 5)  # read i, f, o, g, c, dh, dc'; write di, df, do, dg, dc
    bytes_ms = nbytes / memory_bytes_per_s() * 1e3
    # ~50 fp32 operations per element (3 sigmoids, 2 tanh, ~20 products
    # and sums) at the card's 67 TFLOP/s non-tensor fp32 peak.
    ops_ms = elems * 50 / 67e12 * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"kernel: backward, one depth step = 5 launches, {elems / 1e6:.2f} M elements, "
          f"{nbytes / 1e9:.3f} GB: kernel {ms:.4f} ms (again {ms_again:.4f}), "
          f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
          f"(_thnn_fused_lstm_cell_backward_impl, max_abs_err vs plain {lib_err:.1e}), "
          f"bound {bound_ms:.4f} ms by bytes ({bytes_ms / ms:.0%} of it)", flush=True)
    return {
        "name": "lstm_gates_backward",
        "route": "cuda",
        "source": "aa_rmvsnet_tpu_torch/csrc/lstm_gates.cu",
        "replaces": "aa_rmvsnet_tpu/ops/pallas/gates.py:54",
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


def phase_train_small() -> None:
    from aa_rmvsnet_tpu_torch.data.loader import batch_samples
    from aa_rmvsnet_tpu_torch.models import SweepConfig
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.train import batch_to_device, loss_fn
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_train_sample, seeded_model

    host = batch_samples([plane_train_sample(
        SMALL_H, SMALL_W, SMALL_V, GRAD_D, seed=SEED + 4, focal=400.0, baseline=2.0,
        plane_depth=500.0, depth_min=425.0, depth_interval=7.5)])
    config = SweepConfig(depth_block=GRAD_BLOCK, remat=True)
    noise = torch.Generator().manual_seed(SEED + 6)

    def loss_and_grads(dev: str, nudge: float = 0.0):
        model = seeded_model(SEED)
        with torch.no_grad():
            for name, param in model.named_parameters():
                if ".p_conv." in name:  # zero offsets, as the reference initialises them
                    param.zero_()
                elif nudge:
                    param.mul_(1 + nudge * torch.randn(param.shape, generator=noise))
        model.to(dev)
        before = (gates.launches, gates.backward_launches)
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, batch_to_device(host, dev), config)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        launched = (gates.launches - before[0], gates.backward_launches - before[1])
        print(f"train-small: loss and gradients on {dev}{' (nudged weights)' if nudge else ''}"
              f" in {time.perf_counter() - t0:.2f} s, gate kernel launches forward "
              f"{launched[0]}, backward {launched[1]}", flush=True)
        return loss.item(), grads, launched

    loss_cpu, g_cpu, _ = loss_and_grads("cpu")
    _, g_nudged, _ = loss_and_grads("cpu", nudge=1e-7)
    loss_cuda, g_cuda, launched = loss_and_grads("cuda")
    if launched != (2 * 5 * GRAD_D, 5 * GRAD_D):
        _fail(f"small CUDA training step launched the gate kernels {launched} times")

    def worst(other):
        """(tensor, max_abs_err / max(max|g_cpu|, 1e-3)) of the worst tensor.
        The floor also covers the output conv's bias, whose gradient is
        exactly zero (softmax is shift-invariant) and so rounding noise."""
        rels = {}
        for name, g in g_cpu.items():
            err = (other[name] - g).abs().max().item()
            rels[name] = err / max(g.abs().max().item(), 1e-3) if np.isfinite(err) else np.inf
        name = max(rels, key=rels.get)
        return name, rels[name]

    loss_rel = abs(loss_cuda - loss_cpu) / abs(loss_cpu)
    dev_name, dev_err = worst(g_cuda)
    ref_name, ref_err = worst(g_nudged)
    bar = max(1e-3, 10 * ref_err)
    ok = loss_rel <= 1e-5 and dev_err <= bar
    print(f"train-small: CUDA vs CPU at {SMALL_H}x{SMALL_W}, V={SMALL_V}, D={GRAD_D}, "
          f"depth_block {GRAD_BLOCK}, remat: loss {loss_cuda:.6f} vs {loss_cpu:.6f} "
          f"(rel {loss_rel:.2e}, bar 1e-5); gradients of {len(g_cpu)} tensors, worst "
          f"max_abs_err / max(max|g|, 1e-3) {dev_err:.2e} ({dev_name}); the CPU's own "
          f"move under 1e-7 weight noise {ref_err:.2e} ({ref_name}); bar {bar:.2e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail("CUDA training gradients disagree with the CPU ones")


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
        gates.launches = gates.backward_launches = 0
        stats = run_inference(
            model, samples,
            InferConfig(out_root=out_root, depth_block=MAIN_BLOCK, num_workers=2,
                        device="cuda"),
        )
        launches = gates.launches
        backward = gates.backward_launches
        peak = torch.cuda.max_memory_allocated()
        expect = 5 * MAIN_D * MAIN_MAPS
        if stats["count"] != MAIN_MAPS or launches != expect or backward != 0:
            _fail(f"main path wrote {stats['count']} maps with {launches} gate "
                  f"kernel and {backward} backward launches; expected {MAIN_MAPS}, "
                  f"{expect} and 0")
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


def phase_train() -> tuple[int, int]:
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.checkpoint import restore_latest
    from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig, make_optimizer, run_training
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_train_sample, seeded_model

    # DTU training cameras at 160x128 have a focal length of ~361 px.
    sample = plane_train_sample(TRAIN_H, TRAIN_W, TRAIN_V, TRAIN_D, seed=SEED + 5,
                                focal=361.54, baseline=20.0, plane_depth=600.0,
                                depth_min=425.0, depth_interval=2.65)
    dataset = [sample] * TRAIN_STEPS
    model = seeded_model(SEED)
    with tempfile.TemporaryDirectory() as logdir:
        config = TrainConfig(
            learning_rate=1e-3, lr_min=2e-6, total_steps=DTU_TRAIN_TOTAL_STEPS,
            depth_block=TRAIN_BLOCK, epochs=1, batch_size=1, num_workers=2,
            summary_freq=TRAIN_STEPS, logdir=logdir, device="cuda",
        )
        torch.cuda.reset_peak_memory_stats()
        gates.launches = gates.backward_launches = 0
        stats = run_training(model, dataset, config)
        launches, backward = gates.launches, gates.backward_launches
        peak = torch.cuda.max_memory_allocated()
        losses = stats["losses"]
        expect = (2 * 5 * TRAIN_D * TRAIN_STEPS, 5 * TRAIN_D * TRAIN_STEPS)
        if stats["step"] != TRAIN_STEPS or (launches, backward) != expect:
            _fail(f"training main path ran {stats['step']} steps with {launches} forward "
                  f"and {backward} backward gate-kernel launches; expected "
                  f"{TRAIN_STEPS}, {expect[0]} and {expect[1]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            _fail(f"training losses not finite and falling: {losses}")

        # The checkpoint of step 8 restores bit for bit into a fresh model
        # and optimizer, and the resumed run trains one more finite step.
        fresh = AARMVSNetCore().cuda()
        optimizer, scheduler = make_optimizer(fresh.parameters(), config,
                                              DTU_TRAIN_TOTAL_STEPS)
        restored = restore_latest(logdir, fresh, optimizer, scheduler)
        same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                      fresh.state_dict().values()))
        if restored != TRAIN_STEPS or not same:
            _fail(f"checkpoint restored step {restored}, weights equal: {same}")
        resumed = run_training(AARMVSNetCore(), dataset,
                               replace(config, epochs=2, max_steps=1, resume=True))
        if (resumed["start_step"], resumed["step"]) != (TRAIN_STEPS, TRAIN_STEPS + 1) \
                or not np.isfinite(resumed["losses"]).all():
            _fail(f"resumed run: {resumed}")
    secs = ", ".join(f"{s:.3f}" for s in stats["step_seconds"])
    print(f"train: run_training at {TRAIN_H}x{TRAIN_W}, V={TRAIN_V}, D={TRAIN_D}, "
          f"depth_block {TRAIN_BLOCK}, batch 1, fp32, Adam 1e-3: {TRAIN_STEPS} steps, "
          f"seconds per step [{secs}], peak memory {peak / 2**30:.2f} GiB, losses "
          f"[{', '.join(f'{x:.4f}' for x in losses)}], gate kernel launches forward "
          f"{launches} (= 2 x 5 x {TRAIN_D} x {TRAIN_STEPS}), backward {backward} "
          f"(= 5 x {TRAIN_D} x {TRAIN_STEPS}); checkpoint of step {restored} restored "
          f"bit for bit, resumed step {resumed['step']} loss "
          f"{resumed['losses'][0]:.4f}", flush=True)
    return launches, backward


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
    forward = phase_kernel()
    backward = phase_backward_kernel()
    phase_small()
    phase_train_small()
    infer_launches = phase_main()
    forward["launches"], backward["launches"] = phase_train()
    forward["launches_by_path"] = {"inference": infer_launches,
                                   "training": forward["launches"]}
    backward["launches_by_path"] = {"inference": 0, "training": backward["launches"]}
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [forward, backward]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
