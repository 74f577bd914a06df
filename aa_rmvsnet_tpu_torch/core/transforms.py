"""Host-side image transforms: standardization, resize, crop, pad (copy of
``aa_rmvsnet_tpu/core/transforms.py``; cv2 is imported where it is used).

Numerics mirror the reference loaders:
- per-image channel-wise standardization (mean/var over H,W) — the only
  normalization the pipeline has (reference: datasets/dtu_yao.py:97-101,
  data_eval_transform.py:79-83).  The train loader adds 1e-8 to the std;
  the eval loaders do not.
- bilinear resize via cv2 (reference: datasets/preprocess.py:19-24),
- center crop to a multiple of ``base`` with cap at ``(max_h, max_w)``
  (preprocess.py:41-73),
- vertical zero-pad of +8 rows for the TnT padding pipeline
  (data_eval_transform_padding.py:86-90).
"""

from __future__ import annotations

import math

import numpy as np


def standardize_image(img: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Per-image channel-wise standardization over the spatial axes.

    ``eps`` is added to the standard deviation (1e-8 in the train loader,
    0.0 in the eval loaders).
    """
    img = img.astype(np.float32)
    mean = img.mean(axis=(0, 1), keepdims=True)
    var = img.var(axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + eps)


def scale_image(image: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize by ``scale`` with cv2."""
    import cv2

    return cv2.resize(image, None, fx=scale, fy=scale, interpolation=cv2.INTER_LINEAR)


def adaptive_scale_factor(shapes, max_h: int, max_w: int) -> float:
    """Single down-scale factor bringing every view within ``max_h x max_w``.

    The reference computes max over views of (max_h/H, max_w/W) and requires
    all views be at least the target size (data_eval_transform.py:134-150).
    """
    h_scale = max(float(max_h) / h for h, w in shapes)
    w_scale = max(float(max_w) / w for h, w in shapes)
    if h_scale > 1 or w_scale > 1:
        raise ValueError(
            f"requested max size ({max_h},{max_w}) exceeds an input view; shapes={shapes}"
        )
    return max(h_scale, w_scale)


def center_crop_to_multiple(
    image: np.ndarray, max_h: int, max_w: int, base: int = 8
) -> tuple[np.ndarray, int, int]:
    """Center-crop so H,W are capped at (max_h, max_w) and divisible by ``base``.

    Returns ``(cropped, start_h, start_w)`` so intrinsics can be adjusted via
    :func:`.cameras.crop_intrinsics`.
    """
    h, w = image.shape[:2]
    new_h = max_h if h > max_h else int(math.ceil(h / base) * base)
    new_w = max_w if w > max_w else int(math.ceil(w / base) * base)
    # Rounding up past the image would silently produce a short, non-aligned
    # crop (a reference edge quirk, preprocess.py:50-63); round down instead.
    if new_h > h:
        new_h = h // base * base
    if new_w > w:
        new_w = w // base * base
    start_h = int(math.ceil((h - new_h) / 2))
    start_w = int(math.ceil((w - new_w) / 2))
    return image[start_h : start_h + new_h, start_w : start_w + new_w], start_h, start_w


def pad_rows(image: np.ndarray, top: int = 4, bottom: int = 4) -> np.ndarray:
    """Zero-pad rows above/below (TnT padding pipeline: +4/+4, cy += 4)."""
    pad = [(top, bottom)] + [(0, 0)] * (image.ndim - 1)
    return np.pad(image.astype(np.float32), pad)
