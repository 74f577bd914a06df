"""Plane-sweep homography: project reference pixels into a source view at a
fronto-parallel depth plane (port of ``aa_rmvsnet_tpu/ops/homography.py``).

For reference pixel ``(x, y)`` at depth ``d``, with ``P = P_src @ P_ref^-1``,
the source-view pixel is the perspective division of
``R @ [x, y, 1]^T * d + t``.  The rotation term does not depend on depth,
so :func:`homography_terms` computes it once per view and each hypothesis
then costs one multiply-add and a divide (:func:`plane_sweep_xy`).
Coordinates stay fp32; exactly-zero denominators get ``+1e-4``, as in the
reference.  :func:`max_depth_step_displacement` is the host-side (numpy,
float64) bound that gates the packed-row warp.
"""

from __future__ import annotations

import numpy as np
import torch

#: Pixels of each run of rows that :func:`max_depth_step_displacement`
#: takes at a time.
_GATE_PIXELS = 16384


def homography_terms(
    src_proj: torch.Tensor, ref_proj: torch.Tensor, height: int, width: int, row0: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth-independent warp terms.

    Args:
      src_proj, ref_proj: ``(B, 4, 4)`` full projection matrices.
      height, width: reference feature-map size, or the rows of a spatial
        rank's slab and the width.
      row0: the map row of the first of the ``height`` rows.

    Returns:
      ``rot_grid``: ``(B, 3, H*W)``, ``R @ [x, y, 1]`` per reference pixel.
      ``trans``: ``(B, 3, 1)`` translation column.
    """
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3:4]
    dev = src_proj.device
    y, x = torch.meshgrid(
        torch.arange(row0, row0 + height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pix = torch.stack([x.reshape(-1), y.reshape(-1), torch.ones_like(x).reshape(-1)])
    return rot @ pix, trans


def plane_sweep_xy(
    rot_grid: torch.Tensor, trans: torch.Tensor, depth_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-view pixel coordinates for a block of depths.

    Args:
      rot_grid: ``(B, 3, H*W)`` from :func:`homography_terms`.
      trans: ``(B, 3, 1)``; depth_values: ``(B, D)``.

    Returns:
      ``x``, ``y``: ``(B, D, H*W)`` each.
    """
    proj_xyz = rot_grid[:, None] * depth_values[:, :, None, None] + trans[:, None]
    z = proj_xyz[:, :, 2]
    z = torch.where(z == 0.0, z + 1e-4, z)
    return proj_xyz[:, :, 0] / z, proj_xyz[:, :, 1] / z


def max_depth_step_displacement(src_projs, ref_proj, depth_values, height: int,
                                width: int) -> float:
    """Upper bound, in pixels, on how far one depth step moves a warp sample.

    The packed-row warp is exact only when each group of K consecutive
    hypotheses spans at most ``taps - 2`` px; callers check
    ``(K - 1) * bound <= taps - 2``.  Per pixel the warp is a Moebius map of
    depth, so its per-step displacement is monotone wherever the
    denominator keeps its sign, and the two endpoint steps bound every
    step.  That needs every probed point in front of every source camera
    and a monotone spacing of the depths; where either fails this returns
    ``inf``, so the gate fails closed to the exact per-depth path.

    Args:
      src_projs: ``(S, 4, 4)`` source projection matrices (numpy).
      ref_proj: ``(4, 4)``.
      depth_values: ``(D,)`` sweep depths in order.
      height, width: feature-map size.

    Returns:
      The largest ``|p(d_{i+1}) - p(d_i)|`` over views, pixels and both
      axes at the sweep's two endpoint steps, or ``inf``.
    """
    src_projs = np.asarray(src_projs, np.float64)
    ref_proj = np.asarray(ref_proj, np.float64)
    d = np.asarray(depth_values, np.float64)
    if d.size < 2:
        return 0.0
    steps = np.diff(d)
    if not (np.all(steps > 0) or np.all(steps < 0)):
        return float("inf")  # not monotone: the endpoint bound does not hold
    # The step sizes must be monotone too (linspace in d or in 1/d), or the
    # largest step can hide inside the sweep.  The tolerance covers the
    # ~2^-23 * range jitter of a float32 linspace.
    mag = np.abs(steps)
    tol = 1e-3 * float(mag.max())
    if not (np.all(np.diff(mag) >= -tol) or np.all(np.diff(mag) <= tol)):
        return float("inf")
    probe = np.array([d[0], d[1], d[-2], d[-1]])
    projs = [sp @ np.linalg.inv(ref_proj) for sp in src_projs]

    # Runs of rows of ~16K pixels, so that each run's temporaries stay in
    # the cache: whole-map ones (~190 MB a view at 1056x1920) took ~3x as
    # long.  Every pixel's arithmetic is the whole-map one, so the bound is
    # the same to the bit.
    rows = max(1, _GATE_PIXELS // width)
    worst = 0.0
    for r0 in range(0, height, rows):
        h = min(rows, height - r0)
        y, x = np.mgrid[r0:r0 + h, 0:width].astype(np.float64)
        pix = np.stack([x.ravel(), y.ravel(), np.ones(h * width)])  # (3, N)
        for proj in projs:
            rot_grid = proj[:3, :3] @ pix
            trans = proj[:3, 3:4]
            xyz = rot_grid[None] * probe[:, None, None] + trans[None]  # (4, 3, N)
            z = xyz[:, 2]
            if np.min(z) <= 0.0:
                # A probed point on or behind a source camera: the pole of
                # the map lies inside the sweep and the endpoints bound
                # nothing.
                return float("inf")
            px = xyz[:, 0] / z
            py = xyz[:, 1] / z
            for a, b in ((0, 1), (2, 3)):
                worst = max(worst, float(np.abs(px[b] - px[a]).max()),
                            float(np.abs(py[b] - py[a]).max()))
    return worst
