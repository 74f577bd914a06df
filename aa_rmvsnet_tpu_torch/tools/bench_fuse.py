"""What the fusion kernel compiles to, and its time, on the card.

    python -m aa_rmvsnet_tpu_torch.tools.bench_fuse [--reps 20] [--sass-out DIR]

At ``chip_smoke.py`` phase 7's inputs (one 864x1152 reference view of a
plane at 600 + N(0, 3^2) against its 10 nearest sources, 9 levels; from
``utils/synthetic.py:fusion_plane_views`` with phase 7's seed), on one
CUDA device:

1. what ``ptxas -v`` reports for the 9-level kernel of
   ``csrc/fusion_core.cu`` built with the wrapper's flags (registers,
   spills), and from its SASS (``cuobjdump -sass``) the instructions of the
   loop over the sources per pixel and source, counted statically: all of
   them (the path where no work is skipped), the float64 pipe's (``D*``
   arithmetic and compares, and apart from them the conversions to and
   from float64), MUFU, shared-memory and constant loads, and calls (a
   division's slow path, out of line); and the float64 pipe's issue floor,
   the time its 64 lanes an SM take for those instructions at the card's
   maximum SM clock;
2. the device time of one reference view through the wrapper
   (``ops/fusion.py:fuse_ref``) as phase 7 takes it (``utils/device.py:
   device_ms``, 1 GiB written before each run so that the depths come from
   device memory), mean over ``--reps`` runs, in two rounds; then once with
   nothing written between runs, the depths left in the L2 cache; and the
   share of the FLOP-convention bound (``ops/fusion.py:fp64_operations``).

Bit for bit against the plain version is ``chip_smoke.py`` phase 7's and
the card tests' work.  ``--sass-out`` writes the 9-level SASS there.
Prints the card's name and power limit, a line of results and, last, one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import torch

from ..ops import _build, fusion
from ..utils.device import device_ms
from ..utils.synthetic import fusion_plane_views

SOURCE = _build.CSRC_DIR / "fusion_core.cu"
# chip_smoke.py phase 7: the dtu_eval prediction geometry, its plane and seed.
H, W, NUM_SRC, LEVELS = 864, 1152, 10, 9
FOCAL, BASELINE, PLANE, NOISE, SEED = 2000.0, 2.0, 600.0, 3.0, 17
#: The H100 SXM's float64 rate outside the tensor cores, an FMA counted as
#: two operations (as ``chip_smoke.py:FP64_PER_S``).
FP64_PER_S = 34e12
FP64_ARITHMETIC = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")
_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]+);")
_BRANCH = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")
_NINE_LEVELS = f"fuse_ref_kernelILi{LEVELS}E"


def _ptxas_report(library: Path) -> list[str]:
    """Build ``SOURCE`` into ``library`` with the wrapper's flags and
    ``-Xptxas -v``; ptxas's lines for the 9-level kernel."""
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                           *_build.SOURCE_FLAGS[SOURCE.name], "-Xptxas", "-v", "-o",
                           str(library), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"bench_fuse: nvcc failed:\n{proc.stderr}")
    lines, keep = [], False
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            keep = _NINE_LEVELS in line
        if keep and "Compile time" not in line:
            lines.append(line.strip())
    return lines


def _sass(library: Path) -> list[tuple[int, str]]:
    """(address, instruction) of the 9-level kernel's SASS."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out, keep = [], False
    for line in text.splitlines():
        if "Function :" in line:
            keep = _NINE_LEVELS in line
            continue
        m = _SASS_LINE.match(line)
        if keep and m is not None:
            out.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _opcode(instruction: str) -> str:
    words = instruction.split()
    return words[1] if words[0].startswith("@") else words[0]


def _loop_counts(sass) -> dict:
    """Instruction counts of the longest loop (the one over the sources,
    one pixel a thread): the span of its backward branch."""
    spans = [(target, addr) for addr, ins in sass
             if _opcode(ins).startswith("BRA") and (m := _BRANCH.search(ins))
             and (target := int(m.group(1), 16)) < addr]
    start, end = max(spans, key=lambda s: s[1] - s[0]) if spans else (0, sass[-1][0])
    ops = Counter()
    for addr, ins in sass:
        if not start <= addr <= end:
            continue
        op = _opcode(ins)
        if op.startswith("NOP"):
            continue
        base = op.split(".")[0]
        ops["all"] += 1
        if base in FP64_ARITHMETIC:
            ops["fp64_arithmetic"] += 1
        elif base in ("F2F", "I2F", "F2I") and "F64" in op:
            ops["fp64_conversions"] += 1
        elif base in ("MUFU", "LDS", "LDC", "ULDC", "LDG", "CALL"):
            ops[base.lower()] += 1
    return dict(sorted(ops.items()))


def _fp64_floor_ms(per_pixel_source: float, pixel_sources: int, clock_mhz: float) -> float:
    """Time the float64 pipes (64 lanes an SM, one instruction a lane a
    cycle) take for ``per_pixel_source`` instructions of each pixel-source."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_pixel_source * pixel_sources / (64 * sms * clock_mhz * 1e6) * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--sass-out", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fuse: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card, power, clock = (s.strip() for s in smi.splitlines()[0].split(","))
    print(f"{card}, {power} W, max SM clock {clock} MHz", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        library = Path(tmp) / "fusion_core.so"
        report = _ptxas_report(library)
        sass = _sass(library)
    for line in report:
        print(f"ptxas: {line}", flush=True)
    if args.sass_out is not None:
        args.sass_out.mkdir(parents=True, exist_ok=True)
        (args.sass_out / "fuse_ref_kernel.sass").write_text(
            "\n".join(f"/*{a:04x}*/ {i};" for a, i in sass) + "\n")
    counts = _loop_counts(sass)
    pixel_sources = H * W * NUM_SRC
    fp64 = counts.get("fp64_arithmetic", 0) + counts.get("fp64_conversions", 0)

    depths, ref, index, mats = fusion_plane_views(H, W, NUM_SRC, FOCAL, BASELINE, PLANE, NOISE,
                                                  SEED)
    bound_ms = fusion.fp64_operations(H * W, mats.cpu().numpy()) / FP64_PER_S * 1e3

    def step():
        fusion.fuse_ref(depths, ref, index, mats, LEVELS)

    flush = torch.empty(2**28, device="cuda")
    ms = [device_ms(step, flush, args.reps) for _ in range(2)]
    del flush
    warm_ms = device_ms(step, None, args.reps)
    result = {
        "loop_per_pixel_source": counts,
        "fp64_floor_ms": _fp64_floor_ms(fp64, pixel_sources, float(clock)),
        "fp64_arithmetic_floor_ms": _fp64_floor_ms(counts.get("fp64_arithmetic", 0),
                                                   pixel_sources, float(clock)),
        "ms": ms,
        "warm_ms": warm_ms,
        "bound_ms": bound_ms,
    }
    c = counts
    print(f"fuse_ref_kernel ms {', '.join(f'{t:.4f}' for t in ms)} (the depths in L2: "
          f"{warm_ms:.4f}), {bound_ms / min(ms):.0%} of its {bound_ms:.4f} ms bound; loop per "
          f"pixel-source: {c.get('all', 0)} instructions, float64 arithmetic "
          f"{c.get('fp64_arithmetic', 0)} + conversions {c.get('fp64_conversions', 0)}, MUFU "
          f"{c.get('mufu', 0)}, LDS {c.get('lds', 0)}, LDC {c.get('ldc', 0)}, ULDC "
          f"{c.get('uldc', 0)}, LDG {c.get('ldg', 0)}, CALL {c.get('call', 0)}; float64 issue "
          f"floor {result['fp64_floor_ms']:.4f} ms ({result['fp64_arithmetic_floor_ms']:.4f} "
          f"without the conversions) at {clock} MHz", flush=True)
    print(json.dumps({"device": f"{card}, {power} W", "max_sm_clock_mhz": float(clock),
                      "pixel_sources": pixel_sources, "result": result}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
