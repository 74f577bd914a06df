"""Patch-table bilinear sampling, the exact warp gather (port of
``build_patch_table`` / ``patch_bilinear_sample`` in
``aa_rmvsnet_tpu/ops/patch_sample.py``).

Once per source view a **patch table** is built: row ``p = y*W + x`` holds
the 2x2 neighbourhood ``[f(y,x), f(y,x+1), f(y+1,x), f(y+1,x+1)]`` of a
zero-padded feature map, flattened to ``4C`` values.  Each sample is then
one gathered row plus a tent-weight blend.  The tent weights
``max(0, 1 - |coord - corner|)`` give zero-padding, align-corners bilinear
semantics for every case (inside, straddling the border, fully outside).

The gather is ``torch.gather`` on the JAX package's own math rather than
``F.grid_sample``: grid_sample round-trips through normalised coordinates,
which costs ~1e-4 px at W=1152 and can flip winner-take-all near-ties.
Tables are channels-last ``(B, H*W, 4C)``, like the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def build_patch_table(feat: torch.Tensor) -> torch.Tensor:
    """2x2-neighbourhood table of an NHWC feature map.

    Args:
      feat: ``(B, H, W, C)``.

    Returns:
      ``(B, H*W, 4*C)``; out-of-image texels are zero.
    """
    B, H, W, C = feat.shape
    padded = F.pad(feat, (0, 0, 0, 1, 0, 1))
    table = torch.cat(
        [
            padded[:, :H, :W],
            padded[:, :H, 1 : W + 1],
            padded[:, 1 : H + 1, :W],
            padded[:, 1 : H + 1, 1 : W + 1],
        ],
        dim=-1,
    )
    return table.reshape(B, H * W, 4 * C)


def patch_bilinear_sample(
    table: torch.Tensor, x: torch.Tensor, y: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Bilinear samples from a patch table.

    Args:
      table: ``(B, H*W, 4C)`` from :func:`build_patch_table`.
      x, y: ``(B, N)`` fractional pixel coordinates (computed in fp32).
      height, width: table geometry.

    Returns:
      ``(B, N, C)`` samples in the table's dtype; zero out of bounds.
    """
    B, _, C4 = table.shape
    C = C4 // 4
    N = x.shape[1]
    x = x.float()
    y = y.float()
    xb = torch.clamp(torch.floor(x), 0, width - 1)
    yb = torch.clamp(torch.floor(y), 0, height - 1)
    idx = (yb * width + xb).long()
    rows = torch.gather(table, 1, idx[..., None].expand(B, N, C4))

    def tent(d):
        return torch.clamp(1.0 - torch.abs(d), min=0.0)

    tx0, tx1 = tent(x - xb), tent(x - (xb + 1.0))
    ty0, ty1 = tent(y - yb), tent(y - (yb + 1.0))
    w4 = torch.stack([ty0 * tx0, ty0 * tx1, ty1 * tx0, ty1 * tx1], dim=-1)
    return (rows.view(B, N, 4, C) * w4.to(table.dtype)[..., None]).sum(dim=2)
