"""Point-cloud quality metrics: accuracy / completeness (DTU convention);
copy of ``aa_rmvsnet_tpu/utils/quality.py``, numpy and scipy only.

The reference never computes these in-repo (its DTU numbers come from the
official MATLAB evaluation); this module makes the north-star quality
metric (BASELINE.md: DTU acc/comp mm) one command away whenever a fused
PLY and a ground-truth cloud exist:

- **accuracy**: mean distance from each predicted point to its nearest
  ground-truth point (how correct the reconstruction is),
- **completeness**: mean distance from each ground-truth point to its
  nearest predicted point (how much of the surface is covered),

both with distances clamped at ``max_dist`` (DTU uses 20 mm) so isolated
outliers cannot dominate, plus median variants and inlier fractions.
"""

from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Keep one point per occupied voxel (first hit), preserving order.

    Bounds the KD-tree size for dense clouds; ``voxel <= 0`` is a no-op.
    """
    if voxel <= 0 or len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def _nearest_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Distance from each ``src`` point to its nearest ``dst`` point."""
    from scipy.spatial import cKDTree

    tree = cKDTree(dst)
    dist, _ = tree.query(src, k=1, workers=-1)
    return dist


def accuracy_completeness(
    pred: np.ndarray,
    gt: np.ndarray,
    max_dist: float = 20.0,
    downsample: float = 0.0,
) -> dict:
    """Accuracy / completeness between two ``(N, 3)`` point sets.

    Returns mean and median of the clamped nearest-neighbor distances in
    both directions, the combined ``overall`` mean, and the fraction of
    points within ``max_dist``.
    """
    pred = voxel_downsample(np.asarray(pred, np.float64), downsample)
    gt = voxel_downsample(np.asarray(gt, np.float64), downsample)
    if len(pred) == 0 or len(gt) == 0:
        raise ValueError("empty point cloud")

    d_acc = _nearest_distances(pred, gt)
    d_comp = _nearest_distances(gt, pred)
    acc = np.minimum(d_acc, max_dist)
    comp = np.minimum(d_comp, max_dist)
    return {
        "accuracy_mean": float(acc.mean()),
        "accuracy_median": float(np.median(acc)),
        "completeness_mean": float(comp.mean()),
        "completeness_median": float(np.median(comp)),
        "overall": float((acc.mean() + comp.mean()) / 2.0),
        "inlier_fraction_pred": float((d_acc < max_dist).mean()),
        "inlier_fraction_gt": float((d_comp < max_dist).mean()),
        "n_pred": int(len(pred)),
        "n_gt": int(len(gt)),
    }


def depth_map_quality(depth_est, depth_gt, mask, thresholds=(2.0, 4.0, 8.0)) -> dict:
    """Masked depth-map error summary (MAE + threshold rates), the per-view
    analog of the reference's fulltest metrics (reference utils.py:150-175)."""
    m = np.asarray(mask) > 0.5
    err = np.abs(np.asarray(depth_est) - np.asarray(depth_gt))[m]
    if err.size == 0:
        return {"mae": float("nan")}
    out = {"mae": float(err.mean()), "valid_pixels": int(err.size)}
    for tau in thresholds:
        out[f"frac_err_gt_{tau:g}mm"] = float((err > tau).mean())
    return out
