"""Plane-sweep homography: project reference pixels into a source view at a
fronto-parallel depth plane (port of ``aa_rmvsnet_tpu/ops/homography.py``).

For reference pixel ``(x, y)`` at depth ``d``, with ``P = P_src @ P_ref^-1``,
the source-view pixel is the perspective division of
``R @ [x, y, 1]^T * d + t``.  The rotation term does not depend on depth,
so :func:`homography_terms` computes it once per view and each hypothesis
then costs one multiply-add and a divide (:func:`plane_sweep_xy`).
Coordinates stay fp32; exactly-zero denominators get ``+1e-4``, as in the
reference.
"""

from __future__ import annotations

import torch


def homography_terms(
    src_proj: torch.Tensor, ref_proj: torch.Tensor, height: int, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth-independent warp terms.

    Args:
      src_proj, ref_proj: ``(B, 4, 4)`` full projection matrices.
      height, width: reference feature-map size.

    Returns:
      ``rot_grid``: ``(B, 3, H*W)``, ``R @ [x, y, 1]`` per reference pixel.
      ``trans``: ``(B, 3, 1)`` translation column.
    """
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3:4]
    dev = src_proj.device
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
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
