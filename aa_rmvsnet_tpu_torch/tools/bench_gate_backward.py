"""Time the gate-backward kernel's two paths, and another build of it, on the card.

    python -m aa_rmvsnet_tpu_torch.tools.bench_gate_backward [--reps 50] [--baseline-source PATH]

At the five ConvLSTM cell shapes of one ``dtu_eval`` depth step
(864x1152, hidden 16/16/16/16/8), on one CUDA device, in fp32 and bf16:

1. prints what ``ptxas -v`` reports for the backward kernels of
   ``csrc/lstm_gates.cu`` (registers, spills);
2. checks each candidate against the plain version
   (``ops/gates.py:lstm_gates_backward_reference``; fp32 atol 1e-5, bf16
   5e-2): ``vec16``, the wrapper ``gates.lstm_gates_backward`` on aligned
   tensors (the kernel's 16-byte path); ``scalar``, the same wrapper with
   every tensor one element into its storage (the scalar path); and, with
   ``--baseline-source``, the ``lstm_gates_backward`` of another
   ``lstm_gates.cu`` built with the same nvcc flags (an earlier commit's,
   unpacked by ``git archive``);
3. times one depth step (the five launches) of each by CUDA events, mean
   over ``--reps`` steps, in two rounds, the second in reverse order;
4. times each cell's launch alone, for the share of its own bound (the
   216x288 cell's 48 MB then partly stays in the 50 MB L2).

Prints the card's name and power limit, one line per candidate with its
share of the byte bound, and, last, one JSON line.  The design's other
steps (evict-first loads, two vectors a thread, other block sizes, a TMA
pipeline) were timed by this tool at the commit that still had them; see
PERF.md.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import _build, gates

H, W = 864, 1152
CELLS = [(1, 16, H, W), (1, 16, H // 2, W // 2), (1, 16, H // 4, W // 4),
         (1, 16, H // 2, W // 2), (1, 8, H, W)]
BARS = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _ptxas_report(source: Path) -> list[str]:
    """ptxas's lines for the backward kernels of ``source``."""
    with tempfile.TemporaryDirectory() as tmp:
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        proc = subprocess.run(
            [_build.find_nvcc(), *flags, "-Xptxas", "-v", "-cubin",
             "-o", str(Path(tmp) / "k.cubin"), str(source)],
            capture_output=True, text=True, check=True,
        )
    lines, keep = [], False
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            keep = "bwd" in line
        if keep and "Compile time" not in line:
            lines.append(line.strip())
    return lines


def _baseline(source: Path, out_dir: Path):
    """A function of (z, c, dh, dc') that launches the ``lstm_gates_backward``
    of ``source``, built into ``out_dir``, and returns (dz, dc)."""
    lib_path = out_dir / "baseline.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(source)],
                   capture_output=True, text=True, check=True)
    fn = ctypes.CDLL(str(lib_path)).lstm_gates_backward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(z, c, dh, dcn):
        dz, dc = torch.empty_like(z), torch.empty_like(c)
        rc = fn(z.data_ptr(), c.data_ptr(), dh.data_ptr(), dcn.data_ptr(), dz.data_ptr(),
                dc.data_ptr(), c.shape[0], c[0].numel(), gates._DTYPE_CODES[z.dtype],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed (cudaError {rc})")
        return dz, dc
    return run


def _at_storage_offset(t):
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def _inputs(dtype, gen):
    out = []
    for B, h, hh, ww in CELLS:
        z = torch.randn(B, 4 * h, hh, ww, device="cuda", generator=gen)
        rest = [torch.rand(B, h, hh, ww, device="cuda", generator=gen) * 2 - 1
                for _ in range(3)]
        out.append(tuple(t.to(dtype) for t in (z, *rest)))
    return out


def _time_step(run, inputs, reps: int) -> float:
    for args in inputs * 2:  # warm-up
        run(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in inputs:
            run(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--baseline-source", type=Path, default=None,
                        help="another lstm_gates.cu whose lstm_gates_backward to time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gate_backward: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for line in _ptxas_report(_build.CSRC_DIR / "lstm_gates.cu"):
        print(f"ptxas: {line}", flush=True)

    runners = {"vec16": gates.lstm_gates_backward, "scalar": gates.lstm_gates_backward}
    props = torch.cuda.get_device_properties(0)
    rate = props.memory_clock_rate * 1e3 * 2 * props.memory_bus_width / 8
    elems = sum(B * h * hh * ww for B, h, hh, ww in CELLS)
    results = {}
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        if args.baseline_source is not None:
            runners["baseline"] = _baseline(args.baseline_source, Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            aligned = _inputs(dtype, gen)
            inputs = {name: aligned for name in runners}
            inputs["scalar"] = [tuple(_at_storage_offset(t) for t in a) for a in aligned]
            for name, run in runners.items():
                err = 0.0
                for a in inputs[name]:
                    dz_k, dc_k = run(*a)
                    dz_p, dc_p = gates.lstm_gates_backward_reference(*a)
                    err = max(err, (dz_k.float() - dz_p.float()).abs().max().item(),
                              (dc_k.float() - dc_p.float()).abs().max().item())
                if err > BARS[dtype]:
                    raise SystemExit(f"bench_gate_backward: {name} {dtype} max_abs_err {err:.3e}")
                results[(name, dtype)] = {"max_abs_err": err, "ms": []}
            order = list(runners)
            for names in (order, order[::-1]):
                for name in names:
                    results[(name, dtype)]["ms"].append(
                        _time_step(runners[name], inputs[name], args.reps))
            for name in order:  # each cell's launch alone
                results[(name, dtype)]["cell_ms"] = [
                    _time_step(runners[name], [a], args.reps) for a in inputs[name]]
            bound_ms = elems * 12 * dtype.itemsize / rate * 1e3
            for name in order:
                r = results[(name, dtype)]
                cells = ", ".join(
                    f"{t:.4f} ({B * h * hh * ww * 12 * dtype.itemsize / rate * 1e3 / t:.0%})"
                    for t, (B, h, hh, ww) in zip(r["cell_ms"], CELLS))
                print(f"{str(dtype)[6:]:8s} {name:8s} ms per depth step "
                      f"{', '.join(f'{t:.4f}' for t in r['ms'])}; "
                      f"{bound_ms / min(r['ms']):.1%} of the {bound_ms:.4f} ms byte bound; "
                      f"max_abs_err {r['max_abs_err']:.3e}; each cell alone ms (share of its "
                      f"bound): {cells}", flush=True)
            del aligned, inputs
    print(json.dumps({"device": smi, "elements": elems, "results": [
        {"candidate": name, "dtype": str(dtype)[6:], **r} for (name, dtype), r in results.items()
    ]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
