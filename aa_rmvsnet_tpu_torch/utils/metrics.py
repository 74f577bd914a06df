"""Depth-map quality metrics on tensors (port of
``threshold_error_rate``, ``abs_depth_error`` and ``MeterDict`` in
``aa_rmvsnet_tpu/utils/metrics.py``; reference utils.py:102-175).

Both metrics are masked means over the batch: the share of valid pixels
whose error exceeds ``threshold`` (evaluated at 2/4/8/16/32 mm during
validation), and the masked mean absolute error.
"""

from __future__ import annotations

import torch


def threshold_error_rate(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                         mask: torch.Tensor, threshold: float) -> torch.Tensor:
    valid = mask > 0.5
    bad = (torch.abs(depth_est - depth_gt) > threshold) & valid
    return bad.sum() / valid.sum().clamp(min=1)


def abs_depth_error(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    valid = mask > 0.5
    return (torch.abs(depth_est - depth_gt) * valid).sum() / valid.sum().clamp(min=1)


class MeterDict:
    """Running mean of scalar metric dicts (values: 0-d tensors or numbers)."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._count = 0

    def update(self, scalars: dict) -> None:
        self._count += 1
        for k, v in scalars.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)

    def mean(self) -> dict:
        return {k: v / max(self._count, 1) for k, v in self._sums.items()}
