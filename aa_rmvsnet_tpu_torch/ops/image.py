"""The image operations of depth-map fusion that the JAX package takes from
``cv2``, in torch, so that fusion runs where there is no ``cv2`` (the
card's machine) and on the tensors' own device.

- :func:`resize_linear`: ``cv2.resize`` with ``INTER_LINEAR`` on a float
  image (``aa_rmvsnet_tpu/pipeline/fuse.py:_align_image_to_prediction``);
- :func:`pyr_down`: ``cv2.pyrDown`` (``fuse.py:fuse_scan_padded``).

Both are plain torch ops on ``(H, W, C)`` tensors; ``tests/test_torch_fuse.py``
holds them to ``cv2``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """cv2's source indices and weights of one axis: the half-pixel centre
    ``(d + 0.5) * src / dst - 0.5``, its floor, and its fraction, taken in
    float64 and then rounded to float32.  Along x cv2 also zeroes the
    fraction where the floor falls outside ``[0, src - 1)``
    (``clamp_weights``); along y it only clamps the row index."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_weights:
        frac[(s < 0) | (s >= src - 1)] = 0.0
    i0 = np.clip(s, 0, src - 1)
    i1 = np.clip(s + 1, 0, src - 1)
    return i0, i1, np.float32(1.0) - frac, frac


def resize_linear(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """``cv2.resize(img, (width, height))`` (``INTER_LINEAR``, no
    antialias) of a float32 ``(H, W, C)`` image: a horizontal pass over
    the source rows, then a vertical one, each ``a * w0 + b * w1`` in
    float32, as cv2 computes them."""
    if img.dtype != torch.float32 or img.dim() != 3:
        raise ValueError(f"resize_linear takes a float32 (H, W, C) image, not "
                         f"{img.dtype} {tuple(img.shape)}")
    H, W, _ = img.shape
    dev = img.device

    def t(a):
        return torch.from_numpy(a).to(dev)

    x0, x1, wx0, wx1 = map(t, _linear_taps(W, width, clamp_weights=True))
    y0, y1, wy0, wy1 = map(t, _linear_taps(H, height, clamp_weights=False))
    rows = img[:, x0] * wx0[None, :, None] + img[:, x1] * wx1[None, :, None]
    return rows[y0] * wy0[:, None, None] + rows[y1] * wy1[:, None, None]


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """``cv2.pyrDown(img)`` of an ``(H, W, C)`` uint8 or float32 image:
    the separable ``[1 4 6 4 1] / 16`` filter with ``BORDER_REFLECT_101``,
    then the even rows and columns, ``((H + 1) // 2, (W + 1) // 2)`` out.
    uint8 sums are integers, rounded as cv2 rounds them, ``(sum + 128) >>
    8``; float sums are scaled by 1/256."""
    if img.dim() != 3 or img.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"pyr_down takes a uint8 or float32 (H, W, C) image, not "
                         f"{img.dtype} {tuple(img.shape)}")
    x = img.float().permute(2, 0, 1)[None]  # (1, C, H, W); uint8 sums stay exact
    x = F.pad(x, (2, 2, 2, 2), mode="reflect")  # reflect 101

    def taps(t, dim):
        n = t.shape[dim] - 4
        s = [t.narrow(dim, k, n) for k in range(5)]
        return (s[0] + s[4]) + 4.0 * (s[1] + s[3]) + 6.0 * s[2]

    s = taps(taps(x, 3)[..., ::2], 2)[..., ::2, :]
    if img.dtype == torch.uint8:
        out = torch.floor((s + 128.0) / 256.0).to(torch.uint8)
    else:
        out = s * (1.0 / 256.0)
    return out[0].permute(1, 2, 0).contiguous()
