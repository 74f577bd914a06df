"""Inference driver: depth and confidence maps for every sample of an eval
dataset, written in the reference's on-disk layout so the existing fusion
stage reads them unchanged (port of ``aa_rmvsnet_tpu/pipeline/infer.py``,
exact fp32 path, one map at a time)::

    <out_root>/<scan>/depth_est_0/<ref_view:08d>.pfm
    <out_root>/<scan>/confidence_0/<ref_view:08d>.pfm

The depth map is the winner-take-all depth of the core network and the
sweep runs with ``collect_volume=False``, so device memory stays
O(depth_block) in the number of hypotheses.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.pfm import save_pfm
from ..data.loader import prefetch_samples
from ..models.network import AARMVSNetCore, SweepConfig, forward
from ..utils.device import disable_tf32, resolve_device


@dataclass
class InferConfig:
    out_root: str
    depth_block: int = 8
    num_workers: int = 8
    device: str = "cuda"


def save_outputs(out_dir: str, ref_view: int, depth: np.ndarray,
                 confidence: np.ndarray) -> None:
    name = f"{ref_view:08d}"
    os.makedirs(os.path.join(out_dir, "depth_est_0"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "confidence_0"), exist_ok=True)
    save_pfm(os.path.join(out_dir, "depth_est_0", name + ".pfm"), depth.astype(np.float32))
    save_pfm(os.path.join(out_dir, "confidence_0", name + ".pfm"),
             confidence.astype(np.float32))


def run_inference(
    model: AARMVSNetCore,
    dataset,
    config: InferConfig,
    progress: bool = True,
) -> dict:
    """Generate depth maps for every sample of ``dataset`` (anything with
    ``len`` and ``__getitem__`` returning the ``EvalDataset`` sample dict).

    Moves ``model`` to ``config.device`` and sets it to eval mode.  Turns
    TF32 off (see :func:`..utils.device.disable_tf32`).  A map's time runs
    from the forward call to its depth and confidence on the host, after
    ``torch.cuda.synchronize()``.

    Returns ``{count, total_s, maps_per_s, map_seconds, failures}``.
    """
    device = resolve_device(config.device)
    disable_tf32()
    model.to(device).eval()
    sweep_config = SweepConfig(depth_block=config.depth_block, collect_volume=False)

    map_seconds: list[float] = []
    failures: list[str] = []
    with torch.inference_mode():
        for sample in prefetch_samples(dataset, num_workers=config.num_workers):
            if isinstance(sample, Exception):
                # Loader-side failure (corrupt image, missing cam): skip the
                # view, keep the run alive, report at the end.
                failures.append(str(sample))
                print(f"SKIP (load failure): {sample}", flush=True)
                continue
            imgs = torch.from_numpy(np.ascontiguousarray(sample["imgs"][None])).to(device)
            proj = torch.from_numpy(
                np.ascontiguousarray(sample["proj_matrices"][None])).to(device)
            depths = torch.from_numpy(
                np.asarray(sample["depth_values"], np.float32)[None]).to(device)

            t0 = time.perf_counter()
            out = forward(model, imgs, proj, depths, sweep_config)
            depth = out["depth"][0].cpu().numpy()
            conf = out["photometric_confidence"][0].cpu().numpy()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0

            save_outputs(os.path.join(config.out_root, sample["scan"]),
                         sample["ref_view"], depth, conf)
            map_seconds.append(dt)
            if progress:
                print(f"[{len(map_seconds)}/{len(dataset)}] {sample['scan']}/"
                      f"{sample['ref_view']:08d}  {dt:.3f}s", flush=True)

    if failures:
        print(f"run_inference: {len(failures)} sample(s) skipped due to load failures")
    total = sum(map_seconds)
    return {
        "count": len(map_seconds),
        "total_s": total,
        "maps_per_s": len(map_seconds) / max(total, 1e-9),
        "map_seconds": map_seconds,
        "failures": failures,
    }
