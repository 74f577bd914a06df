"""Modulated deformable 3x3 convolution (v2), port of
``aa_rmvsnet_tpu/ops/deform.py:deform_conv``.

For every output pixel the 9 kernel taps are sampled at learned fractional
offsets from the zero-padded input, scaled by a learned modulation, and
contracted with the conv weights.  The sampling grid is in padded
coordinates: output pixel ``(i, j)`` has base position ``(i+1, j+1)``, plus
the tap ``(dr, dc)`` in row-major order over {-1, 0, 1}^2, plus the offset
(channels 0..8 shift rows, 9..17 columns).  Each tap is one patch-table
gather (the reference's clamp-into-the-pad-ring semantics coincide with the
tent/zero semantics of the table), modulated, and contracted with that
tap's ``(C, O)`` weight slice; the taps accumulate one by one, so the
``(B, H, W, 9, C)`` sample tensor never materialises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .patch_sample import build_patch_table, patch_bilinear_sample


def deform_conv(
    x: torch.Tensor,
    offset: torch.Tensor,
    modulation: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    row0: int = 0,
) -> torch.Tensor:
    """Modulated deformable 3x3 conv, of every output row or of the ``Ho``
    rows from ``row0`` (a spatial rank's slab, ``offset`` and
    ``modulation`` giving its rows), sampled from the whole input either way.

    Args:
      x: ``(B, C, H, W)`` input features (unpadded).
      offset: ``(B, 18, Ho, W)``; channels ``[:9]`` shift rows, ``[9:]``
        columns, tap order row-major.
      modulation: ``(B, 9, Ho, W)`` modulation scalars (already sigmoided).
      weight: ``(O, C, 3, 3)`` conv weights (tap ``n`` = ``(n//3, n%3)``).
      bias: optional ``(O,)``.
      row0: the input row of the first output row.

    Returns:
      ``(B, O, Ho, W)``.
    """
    B, C, H, W = x.shape
    Ho = offset.shape[2]
    O = weight.shape[0]
    Hp, Wp = H + 2, W + 2
    x_pad = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))  # NHWC
    table = build_patch_table(x_pad)

    # Tap geometry in fp32 whatever the compute dtype.
    offset = offset.float()
    rows = torch.arange(row0 + 1, row0 + Ho + 1, dtype=torch.float32, device=x.device)
    cols = torch.arange(1, W + 1, dtype=torch.float32, device=x.device)
    taps = weight.permute(2, 3, 1, 0).reshape(9, C, O)

    out = torch.zeros(B, Ho, W, O, dtype=x.dtype, device=x.device)
    for n in range(9):
        dr, dc = n // 3 - 1, n % 3 - 1
        p_r = rows[None, :, None] + (dr + offset[:, n])  # (B, H, W)
        p_c = cols[None, None, :] + (dc + offset[:, 9 + n])
        tap = patch_bilinear_sample(
            table, p_c.reshape(B, -1), p_r.reshape(B, -1), Hp, Wp
        ).reshape(B, Ho, W, C)
        tap = tap * modulation[:, n, :, :, None]
        out = out + tap @ taps[n]
    if bias is not None:
        out = out + bias
    return out.permute(0, 3, 1, 2).contiguous()
