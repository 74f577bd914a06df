"""Depth maps per second on the card, at the root ``bench.py``'s geometry.

    python -m aa_rmvsnet_tpu_torch.tools.bench [--maps 3] [--warmup 1]

One ``dtu_eval`` map is 864x1152, 5 views, 512 hypotheses, depth block 8.
The tool runs ``run_inference`` (the path of ``cli eval``) on an in-memory
synthetic plane scene (``utils/synthetic.py:plane_scene``, cameras 2
apart, so the 4x4 packed gate passes as on DTU's fine sweep) with seeded
He-normal weights (``seeded_model``), twice:

- ``defaults``: ``cli eval``'s defaults (bf16, packed rows where the gate
  passes, fused residual);
- ``production``: the JAX package's production stack, ``--int8_tables
  --dual_residual --gather_pack 2 --table_taps 6``.

Each run takes ``warmup + maps`` maps; the first ``warmup`` (cuDNN's
algorithm search, the allocator's first growth) are left out of the rate.
A map's seconds are ``run_inference``'s: from the forward call to depth
and confidence on the host.  It prints one JSON line: maps per second and
the seconds of every map per configuration, the packed mode, the peak
device memory, and the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit`` gives them.

It checks what it measures: every map written and finite, the packed mode
asked for, and 5 x D gate-kernel launches a map.  It needs a CUDA card,
and exits non-zero on any failure, printing no result (the root
``bench.py``'s supervisor, which prints a stale or zero record and exits 0
when its worker fails, is not carried over).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..core.pfm import read_pfm
from ..ops import gates
from ..pipeline.infer import InferConfig, run_inference
from ..utils.synthetic import plane_scene, seeded_model

#: The root bench.py's geometry (dtu_eval): H, W, V, D, depth block.
HEIGHT, WIDTH, VIEWS, NUM_DEPTH, DEPTH_BLOCK = 864, 1152, 5, 512, 8
DEPTH_MIN, DEPTH_INTERVAL = 425.0, 1.0
SEED = 0

#: Name -> (InferConfig levers, the packed mode the gate must pick).
CONFIGS = {
    "defaults": ({}, (True, 1, 4)),
    "production": (dict(table_dtype=torch.int8, residual_dtype="dual", gather_pack=2,
                        table_taps=6), (True, 2, 4)),
}


def scene(maps: int, height: int = HEIGHT, width: int = WIDTH, views: int = VIEWS,
          num_depth: int = NUM_DEPTH) -> list[dict]:
    """``maps`` samples of the plane scene, cameras 2 apart (the worst depth
    step moves a sample < 0.1 px, so the packed gates pass)."""
    return plane_scene(height, width, views, num_depth, maps=maps, seed=SEED + 3,
                       focal=2000.0, baseline=2.0, plane_depth=600.0,
                       depth_min=DEPTH_MIN, depth_interval=DEPTH_INTERVAL)


def measure(model, samples: list[dict], name: str, warmup: int, device: str = "cuda") -> dict:
    """``run_inference`` of ``samples`` with configuration ``name``; the
    rate over the maps after the first ``warmup``.  Raises ``RuntimeError``
    where a map is missing or not finite, the packed mode is not the
    configuration's, or (on the card) the gate kernel did not run 5 x D
    times a map."""
    levers, mode = CONFIGS[name]
    num_depth = samples[0]["depth_values"].shape[-1]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gates.launches = 0
    with tempfile.TemporaryDirectory() as out_root:
        stats = run_inference(model, samples, InferConfig(
            out_root=out_root, depth_block=DEPTH_BLOCK, num_workers=2, device=device,
            **levers), progress=False)
        launches = gates.launches
        for s in samples:
            for family in ("depth_est_0", "confidence_0"):
                path = os.path.join(out_root, s["scan"], family, f"{s['ref_view']:08d}.pfm")
                if not np.isfinite(read_pfm(path)[0]).all():
                    raise RuntimeError(f"{name}: {path} is not finite")
    if stats["count"] != len(samples) or stats["failures"]:
        raise RuntimeError(f"{name}: {stats['count']} of {len(samples)} maps written "
                           f"({stats['failures']})")
    if stats["modes"] != [mode] * len(samples):
        raise RuntimeError(f"{name}: packed modes {stats['modes']}, not {mode}")
    if dev.type == "cuda" and launches != 5 * num_depth * len(samples):
        raise RuntimeError(f"{name}: {launches} gate kernel launches, not "
                           f"5 x {num_depth} x {len(samples)}")
    timed = stats["map_seconds"][warmup:]
    return {
        "maps_per_s": len(timed) / sum(timed),
        "map_seconds": stats["map_seconds"],
        "warmup_maps": warmup,
        "mode": list(mode),
        "gate_launches": launches,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
        else None,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="aa_rmvsnet_tpu_torch.tools.bench",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--maps", type=int, default=3, help="timed maps per configuration")
    parser.add_argument("--warmup", type=int, default=1,
                        help="maps per configuration left out of the rate")
    args = parser.parse_args(argv)
    if args.maps < 1 or args.warmup < 0:
        parser.error("--maps must be at least 1 and --warmup at least 0")
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; this tool measures the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    samples = scene(args.warmup + args.maps)
    model = seeded_model(SEED)
    results = {name: measure(model, samples, name, args.warmup) for name in CONFIGS}
    print(json.dumps({
        "metric": "depth_maps_per_s",
        "geometry": {"height": HEIGHT, "width": WIDTH, "views": VIEWS,
                     "num_depth": NUM_DEPTH, "depth_block": DEPTH_BLOCK},
        "weights": f"seeded_model({SEED})",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "results": results,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
