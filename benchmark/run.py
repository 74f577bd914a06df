"""The benchmark of ``aa_rmvsnet_tpu_torch``, one cell per run.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port.  Set-up (from process
start) makes the cell's weights and inputs from ``--seed`` and warms every
shape; the window then drives the port's entry point back to back for
``--seconds`` and ends at the first map or step boundary at or after it;
the check compares what the window produced with the plain reference in
``benchmark/reference/``.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit); the checks are also the last lines of
standard error.  With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones, read from a
``torch.profiler`` trace of the window.

Without a CUDA card, with fewer cards than the cell asks for, or when the
window leaves JAX or the JAX package loaded, it prints no result and
exits 1.  Every cache goes to ``.bench_cache/`` in the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names no run may load (the port's name starts with the
#: last one, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "aa_rmvsnet_tpu")


def process_age() -> float:
    """Seconds since this process started, from ``/proc``."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def use_checkout_caches(root: Path = ROOT) -> None:
    """Point every build and kernel cache at a fixed directory in the
    checkout (the port's own nvcc builds go to its ``_build``)."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             variant: dict | None = None, from_process_start: bool = False,
             manifest: dict | None = None, work: dict | None = None):
    """One run of cell ``name``.  Returns ``(result, numbers)``: the result
    line's object and every number the check computed.  Set-up runs from
    this call, or with ``from_process_start`` from the process's start, to
    the window's start.  ``variant``: a control or a fault, for the
    calibration of the limits and for tests (``benchmark/calibrate.py``);
    ``work``: the cell's files as ``manifest.cell`` reads them, where a
    test shrinks them."""
    import torch

    from . import compare
    from . import manifest as manifests
    from . import trace as tracing

    t_setup = time.perf_counter()
    manifest = manifest or manifests.load()
    work = work or manifests.cell(manifest, name)
    cell = manifests.driver(work["driver"]).Cell(work, seed, device, variant)
    cuda = torch.device(device).type == "cuda"
    cell.setup(seconds)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age() if from_process_start else time.perf_counter() - t_setup

    prof = tracing.profile() if trace else contextlib.nullcontext()
    done = failed = 0
    with prof:
        with tracing.window_range():
            t0 = time.perf_counter()
            while True:
                failed += not cell.step(done)
                done += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"the run loaded {', '.join(loaded)}")

    values = {"setup_s": setup_s, f"{cell.unit}s_per_s": done / window_s,
              "peak_mem_gib": peak / 2**30}
    result = {"correct": False, "attempted": done, "failed": failed, "metrics": {}}
    if trace:
        summary = tracing.summarize(tracing.events(prof))
        summary.update(cell.work_done(done))
        summary["peaks"] = peaks(torch.cuda.get_device_name(0) if cuda else "cpu")
        for metric in manifests.per_layer(manifest, name):
            value = manifests.reader(metric["name"])(summary)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        for metric in manifests.end_to_end(manifest, name):
            result["metrics"][metric["name"]] = {"value": values[metric["name"]],
                                                 "unit": metric["unit"]}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": work["chips"],
        "memory_peak_bytes": max(setup_peak, peak) if cuda else 0,
    }
    if trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
        del prof, summary
    numbers = cell.check(done)
    result["correct"], result["checks"] = compare.judge(numbers, work["limits"])
    if failed:
        result["correct"] = False
    return result, numbers


def peaks(kind: str) -> dict | None:
    """The card's published peaks (``benchmark/peaks.json``), or None."""
    with open(Path(__file__).resolve().parent / "peaks.json") as f:
        table = json.load(f)
    return table.get(kind)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    use_checkout_caches()
    import torch

    from . import manifest as manifests

    manifest = manifests.load()
    work = manifests.cell(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"benchmark: the cell needs {work['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 1
    try:
        result, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                   from_process_start=True, manifest=manifest)
    except RuntimeError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 1
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 1
    print(f"numbers {json.dumps(numbers)}", file=sys.stderr)
    for check, entry in result["checks"].items():
        print(f"check {check}: {entry['value']!r} (limit {entry['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
