"""Align-corners linear resizes (port of ``aa_rmvsnet_tpu/ops/resize.py``).

The reference up/downsamples with ``F.interpolate(..., align_corners=True)``
(bilinear in the IntraViewAA pyramid, trilinear in the evidential head); the
JAX package rebuilds that as interpolation-matrix contractions because
``jax.image.resize`` lacks it.  PyTorch has it natively.  The interpolation
matrix itself is kept (:func:`interp_matrix`): the evidential head resamples
its depth hypotheses with it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense ``(out, in)`` align-corners linear interpolation weights (the
    JAX package's ``_interp_matrix``).  A size-1 axis on either side maps
    every output to input index 0.  Cached: do not write to the result."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 or in_size == 1:
        m[:, 0] = 1.0
        return m
    pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.minimum(np.floor(pos).astype(np.int64), in_size - 2)
    frac = (pos - i0).astype(np.float32)
    rows = np.arange(out_size)
    m[rows, i0] = 1.0 - frac
    m[rows, i0 + 1] = frac
    return m


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Align-corners bilinear resize of an NCHW tensor to ``(out_h, out_w)``."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def resize_trilinear_align_corners(x: torch.Tensor, out_d: int, out_h: int,
                                   out_w: int) -> torch.Tensor:
    """Align-corners trilinear resize of an NCDHW tensor to ``(out_d, out_h,
    out_w)``.  As in the JAX package, a size-1 output axis takes input
    index 0."""
    return F.interpolate(x, size=(out_d, out_h, out_w), mode="trilinear",
                         align_corners=True)
