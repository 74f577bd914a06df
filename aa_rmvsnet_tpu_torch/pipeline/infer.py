"""Inference driver: depth and confidence maps for every sample of an eval
dataset, written in the reference's on-disk layout so the existing fusion
stage reads them unchanged (port of ``aa_rmvsnet_tpu/pipeline/infer.py``,
one map at a time)::

    <out_root>/<scan>/depth_est_0/<ref_view:08d>.pfm
    <out_root>/<scan>/confidence_0/<ref_view:08d>.pfm
    [<out_root>/<scan>/{aleatoric_0,epistemic_0}/<ref_view:08d>.pfm]
    [<out_root>/<scan>/<family>_png_0/<ref_view:08d>.png]  (save_png_previews)

By default the depth map is the winner-take-all depth of the core network
and the sweep runs with ``collect_volume=False``, so device memory stays
O(depth_block) in the number of hypotheses.  As in the JAX package, the
sweep runs by default in bf16 with the packed-row warp wherever its
exactness gate passes (:func:`resolve_packed_mode`, per sample, outside
the timed window) and the fused squared residual.  The quantized tables
and residuals (``InferConfig.table_dtype``, ``residual_dtype``) are
opt-in; a residual lever applies to packed samples (or with
``fold_omega=True``) and is dropped, with a printed warning, on the
others, as in the JAX package.

With an evidential head attached (``InferConfig.evidential``) the sweep
collects the ``(B, D, H, W)`` cost volume, the head reads its softmax in
fp32, and the aleatoric and epistemic maps are written beside depth and
confidence; ``depth_source="evidential"`` writes the head's gamma as the
depth map.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.pfm import save_pfm
from ..data.loader import prefetch_samples
from ..models.evidential import evidential_apply
from ..models.network import (
    AARMVSNetCore,
    SweepConfig,
    cast_model,
    forward,
    pick_depth_block,
    pick_packed_rows,
)
from ..utils.device import disable_tf32, resolve_device


@dataclass
class InferConfig:
    """``feature_dtype``, ``fold_omega``, ``gather_pack``, ``table_taps``,
    ``fused_residual``, ``table_dtype`` and ``residual_dtype`` as in
    :class:`..models.network.SweepConfig`.
    ``packed_rows``: ``"auto"`` takes the packed warp per sample where its
    exactness gate passes at ``pack_margin``, ``True`` forces it (the
    super-pack and 6x6 levers stay gated), ``False`` never takes it.
    ``gather_pack`` and ``table_taps`` are the most the gate may pick, and
    ``fused_residual`` applies to packed samples only; ``residual_dtype``
    to packed samples, or to every sample with ``fold_omega=True``, and it
    is dropped with a warning on the others.
    ``evidential``: an :class:`..models.evidential.EvidentialHead` or
    ``None``; it runs in fp32 whatever ``feature_dtype`` is.
    ``depth_source``: ``"wta"`` writes the core's winner-take-all depth,
    ``"evidential"`` the head's gamma (it needs a head).
    ``feature_view_chunk``: FeatNet views per batch, 0 for all at once
    (:class:`..models.network.SweepConfig`).
    ``save_png_previews``: a colour-mapped PNG beside every PFM
    (:func:`save_outputs`; matplotlib on the host)."""

    out_root: str
    depth_block: int = 8
    feature_dtype: torch.dtype = torch.bfloat16
    num_workers: int = 8
    fold_omega: Any = False  # False | "hybrid" | True
    packed_rows: Any = "auto"  # "auto" | True | False
    gather_pack: int = 1
    table_taps: int = 4
    fused_residual: bool = True
    table_dtype: Any = None  # None | torch.float8_e4m3fn | torch.int8
    residual_dtype: Any = None  # None | torch.float8_e4m3fn | torch.int8 | "dual"
    pack_margin: float = 0.95
    device: str = "cuda"
    evidential: Any = None  # EvidentialHead | None
    depth_source: str = "wta"  # "wta" | "evidential"
    feature_view_chunk: int = 0
    save_png_previews: bool = False


def save_outputs(out_dir: str, ref_view: int, depth: np.ndarray,
                 confidence: np.ndarray, uncertainty: dict | None = None,
                 save_png: bool = False) -> None:
    """Write the depth and confidence PFMs of one map, and one PFM per
    entry of ``uncertainty`` (family name -> map, e.g. ``aleatoric_0``).
    With ``save_png``, also a preview of each family in
    ``<family>_png_0`` (``depth_est_0``'s in ``depth_png_0``), as the JAX
    package writes them (reference eval.py:158-160): depth in the inverted
    jet colour map, the others normalised to their range."""
    name = f"{ref_view:08d}"
    maps = {"depth_est_0": depth, "confidence_0": confidence, **(uncertainty or {})}
    for family, arr in maps.items():
        os.makedirs(os.path.join(out_dir, family), exist_ok=True)
        save_pfm(os.path.join(out_dir, family, name + ".pfm"), arr.astype(np.float32))
    if save_png:
        from ..utils.visualize import save_depth_png

        for family, arr in maps.items():
            png_dir = os.path.join(out_dir, "depth_png_0" if family == "depth_est_0"
                                   else family.replace("_0", "_png_0"))
            os.makedirs(png_dir, exist_ok=True)
            save_depth_png(os.path.join(png_dir, name + ".png"), arr,
                           mode="depth" if family == "depth_est_0" else "relative")


def sweep_config(config: InferConfig, mode: tuple[bool, int, int]) -> SweepConfig:
    """The sweep settings of one map in packed ``mode`` (from
    :func:`resolve_packed_mode`).  The residual lever needs a folded cost
    layout: kept on packed samples or with ``fold_omega=True``, else
    dropped with the JAX package's warning (a sample whose gate fails
    under ``packed_rows="auto"`` still runs)."""
    packed, gather_pack, table_taps = mode
    residual_dtype = config.residual_dtype if (packed or config.fold_omega is True) else None
    if config.residual_dtype is not None and residual_dtype is None:
        print("WARNING: fp8 residual storage dropped for an unpacked sample "
              "(requires packed rows or --fold_omega=1)", flush=True)
    return SweepConfig(
        depth_block=config.depth_block,
        collect_volume=config.evidential is not None,
        feature_dtype=config.feature_dtype,
        fold_omega=config.fold_omega,
        packed_rows=packed,
        gather_pack=gather_pack if packed else 1,
        table_taps=table_taps if packed else 4,
        fused_residual=config.fused_residual and packed,
        table_dtype=config.table_dtype,
        residual_dtype=residual_dtype,
        feature_view_chunk=config.feature_view_chunk,
    )


def resolve_packed_mode(sample: dict, config: InferConfig) -> tuple[bool, int, int]:
    """The packed mode ``(packed, gather_pack, taps)`` of one sample: the
    first of ``(gather_pack, 4)``, ``(gather_pack, table_taps)``, ``(1,
    4)``, ``(1, table_taps)`` whose exactness gate (and the divisibility
    the sweep needs) passes, else the exact per-depth path.  At one row
    count the 4x4 window goes first: its table takes 2.25x less memory.
    ``packed_rows=True`` forces the packed path, but the super-pack and
    6x6 levers stay gated: ungated, they silently lose taps."""
    H, W = sample["imgs"].shape[1:3]
    D = sample["depth_values"].shape[-1]
    block = pick_depth_block(D, config.depth_block)

    def gate(gp, taps):
        return D % (block * gp) == 0 and pick_packed_rows(
            sample["proj_matrices"], sample["depth_values"], H, W, block * gp,
            margin=config.pack_margin, taps=taps,
        )

    modes = []
    for gp in (config.gather_pack, 1):
        for taps in (4, config.table_taps):
            if (gp, taps) not in modes:
                modes.append((gp, taps))
    if config.packed_rows != "auto":
        if not config.packed_rows:
            return (False, 1, 4)
        for gp, taps in modes:
            if (gp, taps) == (1, 4) or gate(gp, taps):
                return (True, gp, taps)
    for gp, taps in modes:
        if gate(gp, taps):
            return (True, gp, taps)
    return (False, 1, 4)


def run_inference(
    model: AARMVSNetCore,
    dataset,
    config: InferConfig,
    progress: bool = True,
) -> dict:
    """Generate depth maps for every sample of ``dataset`` (anything with
    ``len`` and ``__getitem__`` returning the ``EvalDataset`` sample dict).

    Moves ``model`` (and the evidential head) to ``config.device`` and sets
    it to eval mode; a bf16 run uses a bf16 copy of the core, and the head
    stays fp32.  Turns TF32 off (see :func:`..utils.device.disable_tf32`).
    A map's time runs from the forward call to its depth and confidence on
    the host, after ``torch.cuda.synchronize()``; the packed gate runs
    before it and the head after it, as in the JAX package.

    Returns ``{count, total_s, maps_per_s, map_seconds, modes,
    gate_seconds, head_seconds, failures}``: per map its seconds, its
    packed mode ``(packed, gather_pack, taps)``, the host seconds of its
    gate and, with a head, the head's seconds (from the cost volume to its
    maps on the host, synchronised).
    """
    head = config.evidential
    if config.depth_source not in ("wta", "evidential"):
        raise ValueError(f"depth_source must be 'wta' or 'evidential', "
                         f"not {config.depth_source!r}")
    if config.depth_source == "evidential" and head is None:
        raise ValueError("depth_source='evidential' requires an evidential head")
    device = resolve_device(config.device)
    disable_tf32()
    model = cast_model(model.to(device).eval(), config.feature_dtype)
    if head is not None:
        head = head.to(device=device, dtype=torch.float32).eval()

    map_seconds: list[float] = []
    modes: list[tuple[bool, int, int]] = []
    gate_seconds: list[float] = []
    head_seconds: list[float] = []
    failures: list[str] = []
    sweep_configs: dict[tuple[bool, int, int], SweepConfig] = {}  # one per packed mode
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
            mode = resolve_packed_mode(sample, config)
            gate_seconds.append(time.perf_counter() - t0)
            if mode not in sweep_configs:
                sweep_configs[mode] = sweep_config(config, mode)

            t0 = time.perf_counter()
            out = forward(model, imgs, proj, depths, sweep_configs[mode])
            depth = out["depth"][0].cpu().numpy()
            conf = out["photometric_confidence"][0].cpu().numpy()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0

            uncertainty = None
            if head is not None:
                t0 = time.perf_counter()
                # The volume's last reference goes to the head, which drops
                # it once the probability volume exists.
                ev = evidential_apply(head, out.pop("cost_volume"), depths)
                del out
                gamma, nu, alpha, beta = (ev[k][0].cpu().numpy()
                                          for k in ("gamma", "nu", "alpha", "beta"))
                del ev
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                head_seconds.append(time.perf_counter() - t0)
                uncertainty = {
                    "aleatoric_0": np.sqrt(beta * (nu + 1) / nu / alpha),
                    "epistemic_0": 1.0 / np.sqrt(nu),
                }
                if config.depth_source == "evidential":
                    depth = gamma

            save_outputs(os.path.join(config.out_root, sample["scan"]),
                         sample["ref_view"], depth, conf, uncertainty,
                         config.save_png_previews)
            map_seconds.append(dt)
            modes.append(mode)
            if progress:
                print(f"[{len(map_seconds)}/{len(dataset)}] {sample['scan']}/"
                      f"{sample['ref_view']:08d}  {dt:.3f}s  packed mode {mode}"
                      + (f"  head {head_seconds[-1]:.3f}s" if head is not None else ""),
                      flush=True)

    if failures:
        print(f"run_inference: {len(failures)} sample(s) skipped due to load failures")
    total = sum(map_seconds)
    return {
        "count": len(map_seconds),
        "total_s": total,
        "maps_per_s": len(map_seconds) / max(total, 1e-9),
        "map_seconds": map_seconds,
        "modes": modes,
        "gate_seconds": gate_seconds,
        "head_seconds": head_seconds,
        "failures": failures,
    }
