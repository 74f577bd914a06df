"""Time the ConvLSTM gate kernels' paths, and other builds of them, on the card.

    python -m aa_rmvsnet_tpu_torch.tools.bench_gates [--direction forward|backward|both]
        [--reps 50] [--baseline-source PATH]

At the five ConvLSTM cell shapes of one ``dtu_eval`` depth step
(864x1152, hidden 16/16/16/16/8), on one CUDA device, in fp32 and bf16,
for the forward kernel, the backward kernel or both:

1. prints what ``ptxas -v`` reports for the direction's kernels of
   ``csrc/lstm_gates.cu`` (registers, spills), and their SASS as built
   (``cuobjdump -sass``): instructions and MUFU (special-function)
   operations per thread and per element of each instantiation, counted
   statically (every kernel runs its body once a thread at batch 1), and
   the time the card's warp schedulers need to issue them for one depth
   step at its maximum SM clock;
2. checks each candidate against the plain version
   (``ops/gates.py:lstm_gates_reference``, fp32 atol 1e-6, bf16 2e-2;
   ``lstm_gates_backward_reference``, 1e-5 and 5e-2): ``vec16``, the
   wrapper on aligned tensors (the kernel's 16-byte path); ``scalar``, the
   same wrapper with every tensor one element into its storage (the scalar
   path); and, with ``--baseline-source``, another ``lstm_gates.cu`` built
   with the same nvcc flags (an earlier commit's, unpacked by ``git
   archive``);
3. times one depth step (the five launches) of each by CUDA events, mean
   over ``--reps`` steps, in two rounds, the second in reverse order;
4. times each cell's launch alone, for the share of its own bound (the
   216x288 cell then partly stays in the 50 MB L2).

Inputs: z ~ N(0, 1), c, dh and dc' uniform in (-1, 1), which keeps every
bf16 output below 2 in magnitude, where one ulp (<= 2^-7) is inside the
bars.  Prints the card's name and power limit, one line per candidate with
its share of the byte bound and the share of outputs that differ from the
plain version's, and, last, one JSON line.  Design steps that lost were
timed by this tool at the commits that still had them (PERF.md): the
backward's evict-first loads, two vectors a thread, other block sizes and
TMA pipeline at 91c0f74, the bf16 forward on ``tanh.approx.f32`` at
38973aa.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

from ..ops import _build, gates

H, W = 864, 1152
CELLS = [(1, 16, H, W), (1, 16, H // 2, W // 2), (1, 16, H // 4, W // 4),
         (1, 16, H // 2, W // 2), (1, 8, H, W)]
SOURCE = _build.CSRC_DIR / "lstm_gates.cu"
# ~25 ms of device sleep at the H100's clock: longer than the host takes to
# queue the launches that one timing covers.
HOST_AHEAD_CYCLES = 50_000_000
# Per direction: the C entry point, its pointer count, the inputs it takes
# of (z, c, dh, dc'), bytes moved per element in units of the storage type,
# the plain version, the wrapper, and the bars.
DIRECTIONS = {
    "forward": dict(entry="lstm_gates_forward", pointers=4, inputs=2, streams=5 + 2,
                    plain=gates.lstm_gates_reference, wrapper=gates.lstm_gates,
                    bars={torch.float32: 1e-6, torch.bfloat16: 2e-2}),
    "backward": dict(entry="lstm_gates_backward", pointers=6, inputs=4, streams=7 + 5,
                     plain=gates.lstm_gates_backward_reference,
                     wrapper=gates.lstm_gates_backward,
                     bars={torch.float32: 1e-5, torch.bfloat16: 5e-2}),
}
# The kernels' instantiations; a kernel with no kVec (an earlier design's) has 1.
_KERNEL_NAME = re.compile(r"(lstm_gates(?:_bwd)?_kernel)I(f|13__nv_bfloat16)(?:Li(\d+)E)?")
_SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+([^;]+);")


def _kernel_label(mangled: str) -> tuple[str, str, int] | None:
    """(kernel, dtype, kVec) of a mangled instantiation, or None."""
    m = _KERNEL_NAME.search(mangled)
    if m is None:
        return None
    return m.group(1), "float32" if m.group(2) == "f" else "bfloat16", int(m.group(3) or 1)


def _is_direction(kernel: str, direction: str) -> bool:
    return ("bwd" in kernel) == (direction == "backward")


def _nvcc(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([_build.find_nvcc(), *args], capture_output=True, text=True,
                          check=True)


def _ptxas_report(source: Path, direction: str) -> list[str]:
    """ptxas's lines for the direction's kernels of ``source``."""
    with tempfile.TemporaryDirectory() as tmp:
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        proc = _nvcc(*flags, "-Xptxas", "-v", "-cubin", "-o",
                     str(Path(tmp) / "k.cubin"), str(source))
    lines, keep = [], False
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            label = _kernel_label(line)
            keep = label is not None and _is_direction(label[0], direction)
        if keep and "Compile time" not in line:
            lines.append(line.strip())
    return lines


def _sass_counts(library: Path) -> dict:
    """{(kernel, dtype, kVec): {"instructions": n, "mufu": n}} from the SASS
    of ``library``, NOPs left out."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, label = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            label = _kernel_label(line)
            if label is not None:
                counts[label] = defaultdict(int)
            continue
        m = _SASS_LINE.match(line)
        if label is None or m is None:
            continue
        op = m.group(1).split()
        op = op[1] if op[0].startswith("@") else op[0]
        if op.startswith("NOP"):
            continue
        counts[label]["instructions"] += 1
        counts[label]["mufu"] += op.startswith("MUFU")
    return counts


def _build_other(source: Path, lib_path: Path, direction: str):
    """A function of the direction's inputs that launches the entry point of
    ``source`` built into ``lib_path`` with the library's nvcc flags."""
    _nvcc(*_build.NVCC_FLAGS, "-o", str(lib_path), str(source))
    spec = DIRECTIONS[direction]
    fn = getattr(ctypes.CDLL(str(lib_path)), spec["entry"])
    fn.argtypes = [ctypes.c_void_p] * spec["pointers"] + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(z, c, *cotangents):
        outs = (torch.empty_like(c), torch.empty_like(c)) if direction == "forward" \
            else (torch.empty_like(z), torch.empty_like(c))
        ptrs = [t.data_ptr() for t in (z, c, *cotangents, *outs)]
        rc = fn(*ptrs, c.shape[0], c[0].numel(), gates._DTYPE_CODES[z.dtype],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{lib_path.name}: launch failed (cudaError {rc})")
        return outs
    return run


def _at_storage_offset(t):
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def _inputs(dtype, gen):
    """(z, c, dh, dc') of each cell."""
    out = []
    for B, h, hh, ww in CELLS:
        z = torch.randn(B, 4 * h, hh, ww, device="cuda", generator=gen)
        rest = [torch.rand(B, h, hh, ww, device="cuda", generator=gen) * 2 - 1
                for _ in range(3)]
        out.append(tuple(t.to(dtype) for t in (z, *rest)))
    return out


def _time_step(run, inputs, reps: int) -> float:
    """Device ms per pass over ``inputs``: the launches are queued behind a
    sleep on the device, so that the events time the device and not the
    host's cost of issuing them (which exceeds a small cell's kernel)."""
    for args in inputs * 2:  # warm-up
        run(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        for args in inputs:
            run(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _issue_ms(instructions_per_element: float, elems: int, clock_mhz: float) -> float:
    """Time for the card's warp schedulers (four an SM, one warp instruction
    a cycle each) to issue the instructions of ``elems`` elements."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warp_instructions = instructions_per_element * elems / 32
    return warp_instructions / (sms * 4 * clock_mhz * 1e6) * 1e3


def _report_build(build: str, source: Path, library: Path, direction: str, elems: int,
                  clock_mhz: float) -> dict:
    """Print ptxas's and the SASS's figures of one build's kernels."""
    for line in _ptxas_report(source, direction):
        print(f"ptxas {build}: {line}", flush=True)
    sass = {}
    for (kernel, dtype, vec), n in sorted(_sass_counts(library).items()):
        if not _is_direction(kernel, direction):
            continue
        per_elem = n["instructions"] / vec
        issue = _issue_ms(per_elem, elems, clock_mhz)
        sass[f"{kernel}<{dtype},{vec}>"] = dict(per_thread=n["instructions"], mufu=n["mufu"],
                                               per_element=per_elem, issue_ms=issue)
        print(f"sass {build}: {kernel}<{dtype}, kVec={vec}>: {n['instructions']} instructions "
              f"a thread, {per_elem:.1f} an element, {n['mufu'] / vec:.1f} MUFU an element; "
              f"issuing a depth step's {elems / 1e6:.2f} M elements takes {issue:.4f} ms at "
              f"{clock_mhz:.0f} MHz", flush=True)
    return sass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--direction", choices=("forward", "backward", "both"),
                        default="both")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--baseline-source", type=Path, default=None,
                        help="another lstm_gates.cu whose entry points to time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gates: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card, power, clock = (s.strip() for s in smi.splitlines()[0].split(","))
    print(f"{card}, {power} W, max SM clock {clock} MHz", flush=True)
    directions = ["forward", "backward"] if args.direction == "both" else [args.direction]

    props = torch.cuda.get_device_properties(0)
    rate = props.memory_clock_rate * 1e3 * 2 * props.memory_bus_width / 8
    elems = sum(B * h * hh * ww for B, h, hh, ww in CELLS)
    results, sass = {}, {}
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(0)
        for direction in directions:
            spec = DIRECTIONS[direction]
            (library,) = _build.build_all([SOURCE.name])
            sass[direction] = {"wrapper": _report_build("wrapper", SOURCE, library, direction,
                                                         elems, float(clock))}
            runners = {"vec16": spec["wrapper"], "scalar": spec["wrapper"]}
            if args.baseline_source is not None:
                lib_path = Path(tmp) / f"baseline-{direction}.so"
                runners["baseline"] = _build_other(args.baseline_source, lib_path, direction)
                sass[direction]["baseline"] = _report_build(
                    "baseline", args.baseline_source, lib_path, direction, elems, float(clock))
            for dtype in (torch.float32, torch.bfloat16):
                aligned = [a[:spec["inputs"]] for a in _inputs(dtype, gen)]
                inputs = {name: aligned for name in runners}
                inputs["scalar"] = [tuple(_at_storage_offset(t) for t in a) for a in aligned]
                for name, run in runners.items():
                    err, differ, total = 0.0, 0, 0
                    for a in inputs[name]:
                        for k, p in zip(run(*a), spec["plain"](*a)):
                            err = max(err, (k.float() - p.float()).abs().max().item())
                            differ += (k != p).sum().item()
                            total += k.numel()
                    if err > spec["bars"][dtype]:
                        raise SystemExit(f"bench_gates: {direction} {name} {dtype} "
                                         f"max_abs_err {err:.3e}")
                    results[(direction, name, dtype)] = {
                        "max_abs_err": err, "differ_share": differ / total, "ms": []}
                order = list(runners)
                for names in (order, order[::-1]):
                    for name in names:
                        results[(direction, name, dtype)]["ms"].append(
                            _time_step(runners[name], inputs[name], args.reps))
                for name in order:  # each cell's launch alone
                    results[(direction, name, dtype)]["cell_ms"] = [
                        _time_step(runners[name], [a], args.reps) for a in inputs[name]]
                per_elem = spec["streams"] * dtype.itemsize
                bound_ms = elems * per_elem / rate * 1e3
                for name in order:
                    r = results[(direction, name, dtype)]
                    r["bound_ms"] = bound_ms
                    cells = ", ".join(
                        f"{t:.4f} ({B * h * hh * ww * per_elem / rate * 1e3 / t:.0%})"
                        for t, (B, h, hh, ww) in zip(r["cell_ms"], CELLS))
                    print(f"{direction:8s} {str(dtype)[6:]:8s} {name:11s} ms per depth step "
                          f"{', '.join(f'{t:.4f}' for t in r['ms'])}; "
                          f"{bound_ms / min(r['ms']):.1%} of the {bound_ms:.4f} ms byte bound; "
                          f"max_abs_err {r['max_abs_err']:.3e}, outputs unequal to the plain "
                          f"version's {r['differ_share']:.4%}; each cell alone ms (share of "
                          f"its bound): {cells}", flush=True)
                del aligned, inputs
    print(json.dumps({"device": f"{card}, {power} W", "max_sm_clock_mhz": float(clock),
                      "elements": elems, "sass": sass, "results": [
                          {"direction": d, "candidate": n, "dtype": str(t)[6:], **r}
                          for (d, n, t), r in results.items()]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
