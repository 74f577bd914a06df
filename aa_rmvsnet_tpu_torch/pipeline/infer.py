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

Across ranks (``InferConfig.mesh``, ``parallel/mesh.py``), as the JAX
package's ``--fanout`` and ``--depth_stages``:

- a data axis above 1 fans the samples out: data rank ``r`` of ``N`` takes
  the samples whose index is ``r`` modulo ``N`` and runs them one at a time
  on its card, writing their PFMs.  The JAX package instead stacks N
  same-shape samples into one batch sharded over its devices and pads a
  ragged tail with repeats; its batch per device is 1 as well, so the PFMs
  are the same files with the same bytes per map;
- a spatial axis above 1 splits each map's rows over the spatial ranks
  (``parallel/spatial.py``, the JAX package's row sharding of ``imgs``):
  every rank resolves the packed mode on the whole sample, sweeps its slab
  of rows, and the depth and confidence rows are gathered for spatial rank
  0 of each data rank to write; with a head, each spatial rank runs it on
  its slab of the cost volume, and only the head's four maps are gathered;
- a depth axis above 1 streams groups of M same-shape maps through the
  depth-block pipeline (``parallel/depth_pipeline.py``), exclusive with
  data, view and spatial axes above 1 and with an evidential head.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

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
    spatial_mesh,
)
from ..parallel.depth_pipeline import pipeline_forward
from ..parallel.mesh import shard_dataset, spatial_rows, views_as_replicas
from ..parallel.spatial import gather_rows_to_first
from ..utils.device import disable_tf32, resolve_device
from ..utils.spans import span


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
    (:func:`save_outputs`; matplotlib on the host).
    ``mesh``: a :class:`..parallel.mesh.Mesh` (``make_mesh``) or ``None``;
    every rank calls :func:`run_inference` with it and the whole dataset,
    and the mesh's device replaces ``device``.  A data axis above 1 fans
    the samples out over the data ranks; a depth axis above 1 runs the
    depth-block pipeline on groups of ``pipeline_maps`` maps (``2 *
    depth`` by default); a spatial axis above 1 splits every map's rows
    over the spatial ranks."""

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
    mesh: Any = None
    pipeline_maps: int | None = None


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


def sweep_config(config: InferConfig, mode: tuple[bool, int, int], mesh=None) -> SweepConfig:
    """The sweep settings of one map in packed ``mode`` (from
    :func:`resolve_packed_mode`), on a spatial ``mesh``'s slab where one is
    given.  The residual lever needs a folded cost
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
        mesh=mesh,
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
    before it and the head after it, as in the JAX package.  A map's host
    phases run in the profiler ranges ``infer.upload`` (the inputs, the
    images to the device only in the next range), ``infer.gate`` (the
    images' copy, then the gate) and ``infer.output`` (the maps, and the
    head's, to the host).  A trace's idle gap bears the host's range at its
    start, so the card's idle after the images' copy reads as the gate's,
    and its idle after the last read-back, through :func:`save_outputs`
    until the next map's inputs, as ``infer.output``'s.

    Returns ``{count, total_s, maps_per_s, map_seconds, modes,
    gate_seconds, head_seconds, failures}``: per map its seconds, its
    packed mode ``(packed, gather_pack, taps)``, the host seconds of its
    gate and, with a head, the head's seconds (from the cost volume to its
    maps on the host, synchronised).

    Under ``config.mesh`` every rank calls this with the whole dataset.
    With a data axis above 1 each data rank runs its shard
    (:func:`..parallel.mesh.shard_dataset`) and every rank returns the
    stats gathered over the data group: ``count`` summed, ``total_s`` the
    largest of the ranks' summed map seconds, ``map_seconds``, ``modes``,
    ``gate_seconds`` and ``head_seconds`` one list per data rank, and the
    failures of all.  View ranks above 0 compute as replicas and write
    nothing (the JAX package replicates over its view axis in inference:
    the sweep sees :func:`..parallel.mesh.views_as_replicas` of the mesh).
    With a spatial axis above 1 each rank sweeps its slab of rows of every
    map (:func:`..parallel.mesh.spatial_rows`; a height that the axis does
    not split into slabs of a multiple of 4 rows raises), and so does each
    view rank where the view axis is above 1 too; with a head each spatial
    rank of view rank 0 runs it on its slab of the cost volume; spatial
    rank 0 of view rank 0 of each data rank gathers the maps (with a head,
    its four maps too, never the volume) and writes, and the stats are
    gathered over every rank: ``count`` summed over the writing ranks, the lists one per
    rank in rank order.  A map's time then includes the gather of its
    rows.  With a depth axis above 1:
    :func:`_run_inference_depth_pipeline`.
    """
    head = config.evidential
    if config.depth_source not in ("wta", "evidential"):
        raise ValueError(f"depth_source must be 'wta' or 'evidential', "
                         f"not {config.depth_source!r}")
    if config.depth_source == "evidential" and head is None:
        raise ValueError("depth_source='evidential' requires an evidential head")
    mesh = config.mesh
    if mesh is not None and mesh.shape["depth"] > 1:
        if head is not None:
            raise ValueError(
                "the depth-block pipeline cannot collect the cost volume; "
                "run evidential inference on a data/spatial mesh"
            )
        if any(mesh.shape[axis] > 1 for axis in ("data", "view", "spatial")):
            raise ValueError(
                "depth-pipelined inference uses the depth axis exclusively; "
                "build the mesh with data=1, spatial=1"
            )
        return _run_inference_depth_pipeline(model, dataset, config, progress)
    rows_mesh = spatial_mesh(views_as_replicas(mesh))
    device = resolve_device(config.device) if mesh is None else mesh.device
    rank, ranks = (0, 1) if mesh is None else (mesh.coord("data"), mesh.shape["data"])
    dataset = shard_dataset(dataset, rank, ranks)
    writes = mesh is None or (mesh.coord("view") == 0 and mesh.coord("spatial") == 0)
    who = f"rank {rank}: " if ranks > 1 else ""
    if rows_mesh is not None:
        who = f"rank {mesh.rank}: "
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
            row0, rows = spatial_rows(rows_mesh, sample["imgs"].shape[1])
            with span("infer.upload"):
                proj = torch.from_numpy(
                    np.ascontiguousarray(sample["proj_matrices"][None])).to(device)
                depths = torch.from_numpy(
                    np.asarray(sample["depth_values"], np.float32)[None]).to(device)
                imgs = torch.from_numpy(np.ascontiguousarray(
                    sample["imgs"][None, :, row0:row0 + rows]))

            with span("infer.gate"):
                # The card runs dry when the images' copy ends, inside this
                # range, so the gate's idle gap bears its name.
                imgs = imgs.to(device)
                t0 = time.perf_counter()
                mode = resolve_packed_mode(sample, config)
                gate_seconds.append(time.perf_counter() - t0)
            if mode not in sweep_configs:
                sweep_configs[mode] = sweep_config(config, mode, rows_mesh)

            t0 = time.perf_counter()
            out = forward(model, imgs, proj, depths, sweep_configs[mode])
            maps = torch.stack([out["depth"][0], out["photometric_confidence"][0]])
            with span("infer.output"):
                if rows_mesh is not None:  # whole on spatial rank 0, which writes
                    maps = gather_rows_to_first(maps, rows_mesh)
                depth, conf = (None, None) if maps is None else maps.cpu().numpy()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0

            uncertainty = None
            if head is not None:
                t0 = time.perf_counter()
                # The volume's last reference goes to the head, which drops
                # it once the probability volume exists (the list holds it
                # until then).  Under a spatial mesh every spatial rank of
                # view rank 0 runs the head on its slab, and spatial rank 0
                # gathers the four maps.
                volume = [out.pop("cost_volume")]
                del out
                if mesh is None or mesh.coord("view") == 0:
                    ev = evidential_apply(head, volume.pop(), depths, rows_mesh)
                    nig = torch.stack([ev[k][0] for k in ("gamma", "nu", "alpha", "beta")])
                    del ev
                    if rows_mesh is not None:
                        nig = gather_rows_to_first(nig, rows_mesh)
                if writes:
                    with span("infer.output"):
                        gamma, nu, alpha, beta = nig.cpu().numpy()
                    del nig
                    uncertainty = {
                        "aleatoric_0": np.sqrt(beta * (nu + 1) / nu / alpha),
                        "epistemic_0": 1.0 / np.sqrt(nu),
                    }
                    if config.depth_source == "evidential":
                        depth = gamma
                del volume
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                head_seconds.append(time.perf_counter() - t0)

            if writes:
                save_outputs(os.path.join(config.out_root, sample["scan"]),
                             sample["ref_view"], depth, conf, uncertainty,
                             config.save_png_previews)
            map_seconds.append(dt)
            modes.append(mode)
            if progress:
                print(f"{who}[{len(map_seconds)}/{len(dataset)}] {sample['scan']}/"
                      f"{sample['ref_view']:08d}  {dt:.3f}s  packed mode {mode}"
                      + (f"  head {head_seconds[-1]:.3f}s" if head is not None else ""),
                      flush=True)

    if failures:
        print(f"{who}run_inference: {len(failures)} sample(s) skipped due to load failures")
    stats = {"count": len(map_seconds), "total_s": sum(map_seconds),
             "map_seconds": map_seconds, "modes": modes, "gate_seconds": gate_seconds,
             "head_seconds": head_seconds, "failures": failures}
    if rows_mesh is not None:
        every = [None] * mesh.world_size
        if not writes:  # a map counts where it is written
            stats["count"] = 0
        dist.all_gather_object(every, stats, group=mesh.group)
    elif ranks > 1:
        every = [None] * ranks
        dist.all_gather_object(every, stats, group=mesh.data_group)
    if rows_mesh is not None or ranks > 1:
        stats = {"count": sum(s["count"] for s in every),
                 "total_s": max(s["total_s"] for s in every),
                 **{k: [s[k] for s in every]
                    for k in ("map_seconds", "modes", "gate_seconds", "head_seconds")},
                 "failures": [f for s in every for f in s["failures"]]}
    stats["maps_per_s"] = stats["count"] / max(stats["total_s"], 1e-9)
    return stats


def _run_inference_depth_pipeline(model: AARMVSNetCore, dataset, config: InferConfig,
                                  progress: bool) -> dict:
    """Depth-pipelined inference (the JAX package's
    ``_run_inference_depth_pipeline``): every stage reads every sample;
    samples of one shape and one packed gate go in groups of ``M =
    pipeline_maps or 2 * P`` maps through
    :func:`..parallel.depth_pipeline.pipeline_forward`, a ragged group
    padded with repeats of its last sample, and rank 0 writes the PFMs.
    The packed gate runs at ``depth_block`` with ``table_taps`` (the
    pipeline does not super-pack); ``gather_pack`` and ``residual_dtype``
    are dropped with the JAX package's warning.  A group's time runs from
    the launch to its maps on the host, synchronised.

    Returns ``{count, total_s, maps_per_s, group_seconds, modes,
    failures}``: per group its seconds and per map its packed mode."""
    mesh = config.mesh
    stages = mesh.shape["depth"]
    maps = config.pipeline_maps or 2 * stages
    if config.gather_pack > 1 or config.residual_dtype is not None:
        print("WARNING: --depth_stages pipelining ignores gather_pack / "
              "fp8-residual (single-mesh sweep levers); running without them", flush=True)
    device = mesh.device
    disable_tf32()
    model = cast_model(model.to(device).eval(), config.feature_dtype)

    def sweep_settings(packed: bool) -> SweepConfig:
        return SweepConfig(
            depth_block=config.depth_block, collect_volume=False,
            feature_dtype=config.feature_dtype, fold_omega=config.fold_omega,
            packed_rows=packed, table_taps=config.table_taps if packed else 4,
            fused_residual=config.fused_residual and packed, table_dtype=config.table_dtype,
            feature_view_chunk=config.feature_view_chunk)

    def resolve_packed(sample) -> bool:
        if config.packed_rows != "auto":
            return bool(config.packed_rows)
        H, W = sample["imgs"].shape[1:3]
        return pick_packed_rows(sample["proj_matrices"], sample["depth_values"], H, W,
                                config.depth_block, margin=config.pack_margin,
                                taps=config.table_taps)

    group_seconds: list[float] = []
    modes: list[tuple[bool, int, int]] = []
    failures: list[str] = []

    def stack(group, key):
        arr = np.stack([np.asarray(s[key], np.float32) for s in group])[:, None]
        return torch.from_numpy(arr).to(device)

    def flush(group: list, packed: bool) -> None:
        padded = group + [group[-1]] * (maps - len(group))
        imgs, proj, depths = (stack(padded, k)
                              for k in ("imgs", "proj_matrices", "depth_values"))
        t0 = time.perf_counter()
        out = pipeline_forward(model, imgs, proj, depths, mesh, sweep_settings(packed))
        depth_b = out["depth"].cpu().numpy()
        conf_b = out["photometric_confidence"].cpu().numpy()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        group_seconds.append(dt)
        for i, sample in enumerate(group):
            modes.append((packed, 1, config.table_taps if packed else 4))
            if mesh.is_main:
                save_outputs(os.path.join(config.out_root, sample["scan"]),
                             sample["ref_view"], depth_b[i, 0], conf_b[i, 0], None,
                             config.save_png_previews)
                if progress:
                    print(f"[{len(modes)}/{len(dataset)}] {sample['scan']}/"
                          f"{sample['ref_view']:08d}  {dt / len(group):.3f}s "
                          f"(pipeline x{stages})", flush=True)

    buckets: dict = {}
    with torch.inference_mode():
        for sample in prefetch_samples(dataset, num_workers=config.num_workers):
            if isinstance(sample, Exception):
                failures.append(str(sample))
                print(f"SKIP (load failure): {sample}", flush=True)
                continue
            key = (sample["imgs"].shape, np.shape(sample["depth_values"]),
                   resolve_packed(sample))
            bucket = buckets.setdefault(key, [])
            bucket.append(sample)
            if len(bucket) == maps:
                flush(bucket, key[2])
                buckets[key] = []
        for key, bucket in buckets.items():  # ragged groups
            if bucket:
                flush(bucket, key[2])

    if failures:
        print(f"run_inference: {len(failures)} sample(s) skipped due to load failures")
    total = sum(group_seconds)
    return {"count": len(modes), "total_s": total,
            "maps_per_s": len(modes) / max(total, 1e-9), "group_seconds": group_seconds,
            "modes": modes, "failures": failures}
