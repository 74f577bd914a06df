"""The readings that the limits of ``correct`` are set from.

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--variant half_batch --variant-seeds 7,8,9] [--seconds 0]

In one process, for each seed: one run of the cell as ``benchmark.run``
makes it (set-up, a window of ``--seconds``, the check), printing every
number the check computes, as one JSON line; then the cell's control
(its workload file's ``control``: the reference in the program's place,
computed in the precision below the configuration's) on
``--control-seeds``, and a :data:`VARIANTS` entry on ``--variant-seeds``.
A number's lower reading is the largest over the program's seeds, its
upper one the smallest over the control's or a fault's
(``benchmark/compare.py`` says what each number is).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import manifest as manifests
from .run import run_cell, use_checkout_caches

#: Readings beside the program's and the control's: a training cell's fault
#: that can happen on one card (the lower half of the rows left out of the
#: loss).
VARIANTS = {"half_batch": {"half_batch": True}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark.calibrate",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--variant", choices=sorted(VARIANTS))
    parser.add_argument("--variant-seeds", default="")
    parser.add_argument("--seconds", type=float, default=0.0)
    args = parser.parse_args(argv)
    use_checkout_caches()
    manifest = manifests.load()
    work = manifests.cell(manifest, args.workload)
    runs = [("program", s, None) for s in _seeds(args.seeds)]
    runs += [("control", s, work["control"]) for s in _seeds(args.control_seeds)]
    if args.variant:
        runs += [(args.variant, s, VARIANTS[args.variant]) for s in _seeds(args.variant_seeds)]
    for kind, seed, variant in runs:
        t0 = time.perf_counter()
        result, numbers = run_cell(args.workload, seed, args.seconds, False, variant=variant,
                                   manifest=manifest)
        print(json.dumps({"kind": kind, "seed": seed, "seconds": time.perf_counter() - t0,
                          "attempted": result["attempted"], "failed": result["failed"],
                          "correct": result["correct"], "metrics": result["metrics"],
                          "numbers": numbers}), flush=True)
    return 0


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


if __name__ == "__main__":
    sys.exit(main())
