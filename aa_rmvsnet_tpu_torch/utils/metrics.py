"""Depth-map quality metrics on tensors (port of
``aa_rmvsnet_tpu/utils/metrics.py``; reference utils.py:102-175 and
statistics.py:11-16).

The error metrics are masked means over the batch: the share of valid
pixels whose error exceeds ``threshold`` (evaluated at 2/4/8/16/32 mm
during validation) or ``k`` depth intervals, and the masked mean absolute
error.  ``std_prob`` is the probability volume's spread over depth.

In data-parallel training (``parallel/mesh.py``) a process ``group`` makes
the masked means those of the global batch: the numerators and the valid
counts are summed over the ranks before the one division, and
:meth:`MeterDict.mean` weights each rank's running mean by its count.  The
error metrics also take a sequence of groups, summed over in turn (the
spatial group, whose ranks hold the rows of one batch, then the data
group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _groups(group) -> tuple:
    """A group or a sequence of them, without the Nones."""
    return tuple(g for g in (group if isinstance(group, (tuple, list)) else (group,))
                 if g is not None)


def _global_ratio(num: torch.Tensor, den: torch.Tensor, group) -> torch.Tensor:
    """``num / max(den, 1)``, both summed over each group's ranks first."""
    both = torch.stack([num.float(), den.float()])
    for g in _groups(group):
        dist.all_reduce(both, group=g)
    return both[0] / both[1].clamp(min=1)


def threshold_error_rate(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                         mask: torch.Tensor, threshold: float, group=None) -> torch.Tensor:
    valid = mask > 0.5
    bad = (torch.abs(depth_est - depth_gt) > threshold) & valid
    if _groups(group):
        return _global_ratio(bad.sum(), valid.sum(), group)
    return bad.sum() / valid.sum().clamp(min=1)


def abs_depth_error(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                    mask: torch.Tensor, group=None) -> torch.Tensor:
    valid = mask > 0.5
    total = (torch.abs(depth_est - depth_gt) * valid).sum()
    if _groups(group):
        return _global_ratio(total, valid.sum(), group)
    return total / valid.sum().clamp(min=1)


def std_prob(prob_volume: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Standard deviation of the probability volume over the depth axis, a
    cheap confidence proxy (reference statistics.py:11-16); the population
    deviation, as ``jnp.std``."""
    return torch.std(prob_volume, dim=dim, correction=0)


def interval_threshold_error_rate(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                                  mask: torch.Tensor, depth_interval: torch.Tensor,
                                  threshold_in_intervals: float) -> torch.Tensor:
    """Share of valid pixels with ``|err| > k * depth_interval``, one
    interval per sample (``(B,)``), the reference's interval-relative
    variant (utils.py ``Thres_metrics_tfversion``)."""
    tau = depth_interval * threshold_in_intervals
    valid = mask > 0.5
    bad = (torch.abs(depth_est - depth_gt) > tau[..., None, None]) & valid
    return bad.sum() / valid.sum().clamp(min=1)


class MeterDict:
    """Running mean of scalar metric dicts (values: 0-d tensors or numbers)."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._count = 0

    def update(self, scalars: dict) -> None:
        self._count += 1
        for k, v in scalars.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)

    def mean(self, group=None) -> dict:
        """The running means; with a process ``group`` the count-weighted
        means over its ranks (every rank must hold the same keys)."""
        if group is None:
            return {k: v / max(self._count, 1) for k, v in self._sums.items()}
        keys = list(self._sums)
        totals = torch.tensor([self._sums[k] for k in keys] + [self._count],
                              dtype=torch.float64, device=_collective_device(group))
        dist.all_reduce(totals, group=group)
        count = max(totals[-1].item(), 1)
        return {k: totals[i].item() / count for i, k in enumerate(keys)}

    @property
    def count(self) -> int:
        return self._count


def _collective_device(group) -> torch.device:
    """Where a host value goes for a collective: the current card under
    NCCL, which takes CUDA tensors only, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
