"""Depth-hypothesis samplers (copy of
``aa_rmvsnet_tpu/core/samplers.py``).

The evaluation families of the reference pipeline (the training ones are
not ported yet):

- eval linear:      ``arange(dmin, dmin + D*interval, interval)``
  (reference: datasets/data_eval_transform.py:126-129)
- open inverse:     ``1 / linspace(1/dmin, 0, D, endpoint=False)``
  for unbounded scenes (data_eval_transform.py:119-124)
- bounded inverse:  ``1 / linspace(1/dmin, 1/dend, D, endpoint=False)``
  (data_eval_transform_padding.py:136-139)

All return float32 arrays of shape ``(D,)``.
"""

from __future__ import annotations

import numpy as np


def linear_depth_eval(depth_min: float, depth_interval: float, num_depth: int) -> np.ndarray:
    """Eval-time linear hypotheses ``dmin + i*interval`` for i in [0, D)."""
    return np.arange(
        depth_min, depth_interval * num_depth + depth_min, depth_interval, dtype=np.float32
    )[:num_depth]


def inverse_depth_open(depth_min: float, num_depth: int) -> np.ndarray:
    """Inverse-depth hypotheses reaching toward infinity (endpoint excluded)."""
    inv = np.linspace(1.0 / depth_min, 0.0, num_depth, endpoint=False)
    return (1.0 / inv).astype(np.float32)


def inverse_depth_bounded(depth_min: float, depth_end: float, num_depth: int) -> np.ndarray:
    """Inverse-depth hypotheses over ``[dmin, dend)`` (endpoint excluded)."""
    inv = np.linspace(1.0 / depth_min, 1.0 / depth_end, num_depth, endpoint=False)
    return (1.0 / inv).astype(np.float32)
