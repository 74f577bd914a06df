"""Align-corners bilinear resize (port of
``aa_rmvsnet_tpu/ops/resize.py:resize_bilinear_align_corners``).

The reference upsamples the IntraViewAA pyramid with
``F.interpolate(..., align_corners=True)``; the JAX package rebuilds that as
interpolation-matrix contractions because ``jax.image.resize`` lacks it.
PyTorch has it natively.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Align-corners bilinear resize of an NCHW tensor to ``(out_h, out_w)``."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)
