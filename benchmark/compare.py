"""The numbers that decide ``correct``, and their limits.

Eval cells: the maps ``run_inference`` wrote for a map of the window drawn
from the seed, against the reference's maps of the same inputs.
- ``depth_gap_*``: per pixel, how far the reference's regularized cost at
  the program's depth lies below the reference's best cost (0 where the
  program picked the reference's winner or a tie).  A near-tie costs
  little, so rounding that swaps two nearly equal hypotheses reads near 0,
  while a wrong sweep reads the spread of the costs.  ``depth_gap_std_*``:
  the same gap in units of the pixel's standard deviation of the costs
  over the hypotheses, which does not scale with the weights or the
  number of hypotheses.
- ``conf_err_*``: the winner's softmax probability, absolute error.
- with the head: ``gamma_err_*`` (mm), ``aleatoric_rel_*`` and
  ``epistemic_rel_*`` (relative), on the maps ``cli eval`` writes.

Training cells: the first three steps, against the reference's three
steps from the same weights on the same batches.
- ``loss_rel``: the largest relative error of a step's loss, and
  ``loss1_rel`` the first step's;
- ``grad_gap``: the first gradient, as Adam holds it after one step: per
  parameter tensor (leaf) the gap between the two norms over the larger of
  the reference's norm of that leaf and of the median leaf; the worst leaf,
  and ``grad_gap_median`` the median leaf's (steadier: the worst leaf is
  one whose gradient is a small sum of large terms);
- ``change_gap``: the same of each leaf's change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by Adam's round-off alone);
- with the head: ``stats_gap``, the same of the BatchNorm running
  statistics' change.

and the window's last step, against the reference's step from the state
that step started from, on the same batch: ``last_loss_rel``, and
``last_change_gap`` (worst leaf) and ``last_change_gap_median`` of each
leaf's change in that step, leaving out the leaves as above by that
step's reference gradient; with the head ``last_stats_gap``.
"""

from __future__ import annotations

import math

import torch


def _stats(prefix: str, t: torch.Tensor) -> dict:
    t = t.flatten().float()
    return {f"{prefix}_max": float(t.max()), f"{prefix}_p999": float(torch.quantile(t, 0.999)),
            f"{prefix}_mean": float(t.mean())}


def eval_numbers(got: dict, want: dict, volume: torch.Tensor | None,
                 depth_values: torch.Tensor) -> dict:
    """``got`` and ``want``: the maps ``(H, W)`` by family (``depth``,
    ``confidence``, and ``gamma``, ``aleatoric``, ``epistemic`` with a head);
    ``volume``: the reference's ``(D, H, W)`` regularized costs where the
    depth map is the winner-take-all one, else ``None``."""
    out = {}
    if volume is not None:
        dmin = float(depth_values[0])
        step = float(depth_values[1] - depth_values[0])
        k = torch.round((got["depth"] - dmin) / step).long().clamp(0, volume.shape[0] - 1)
        best = volume.max(dim=0).values
        gap = best - torch.gather(volume, 0, k[None])[0]
        out.update(_stats("depth_gap", gap))
        out.update(_stats("depth_gap_std", gap / volume.std(dim=0)))
    out.update(_stats("conf_err", (got["confidence"] - want["confidence"]).abs()))
    if "gamma" in want:
        out.update(_stats("gamma_err", (got["gamma"] - want["gamma"]).abs()))
        for key in ("aleatoric", "epistemic"):
            out.update(_stats(f"{key}_rel", ((got[key] - want[key]) / want[key]).abs()))
    return out


def _leaf_gaps(got: dict, want: dict, keys) -> dict:
    """Per leaf, the gap of the two norms over the larger of the reference's
    norm of the leaf and of the median leaf."""
    norms_g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keys}
    norms_w = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keys}
    median = sorted(norms_w.values())[len(norms_w) // 2]
    return {k: abs(norms_g[k] - norms_w[k]) / max(norms_w[k], median, 1e-30) for k in keys}


def _worst_leaf(got: dict, want: dict, keys) -> tuple[float, str]:
    gaps = _leaf_gaps(got, want, keys)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def _median_leaf(got: dict, want: dict, keys) -> float:
    gaps = sorted(_leaf_gaps(got, want, keys).values())
    return gaps[len(gaps) // 2]


def train_numbers(got: dict, want: dict) -> dict:
    """``got`` and ``want``: ``losses`` (3 floats), ``grad`` (leaf -> first
    gradient), ``change`` (leaf -> parameter change over 3 steps), and
    ``stats_change`` (BatchNorm statistic -> change) with a head."""
    loss_rel = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    if not all(math.isfinite(g) for g in got["losses"]):
        loss_rel = math.inf
    leaves = list(want["grad"])
    out = {"loss_rel": loss_rel,
           "loss1_rel": abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])}
    out["grad_gap"], out["grad_leaf"] = _worst_leaf(got["grad"], want["grad"], leaves)
    out["grad_gap_median"] = _median_leaf(got["grad"], want["grad"], leaves)
    norms = {k: float(torch.linalg.vector_norm(want["grad"][k].double())) for k in leaves}
    median = sorted(norms.values())[len(norms) // 2]
    moving = [k for k in leaves if norms[k] >= 1e-3 * median]
    out["change_gap"], out["change_leaf"] = _worst_leaf(got["change"], want["change"], moving)
    out["change_gap_median"] = _median_leaf(got["change"], want["change"], moving)
    out["leaves_left_out"] = len(leaves) - len(moving)
    if want.get("stats_change"):
        out["stats_gap"], out["stats_leaf"] = _worst_leaf(
            got["stats_change"], want["stats_change"], list(want["stats_change"]))
    return out


def last_step_numbers(got: dict, want: dict) -> dict:
    """``got``: the step's ``loss`` and ``change`` (key -> the change of a
    parameter or running statistic); ``want`` the same and ``grad`` (leaf
    -> the reference's gradient)."""
    leaves = list(want["grad"])
    norms = {k: float(torch.linalg.vector_norm(want["grad"][k].double())) for k in leaves}
    median = sorted(norms.values())[len(norms) // 2]
    moving = [k for k in leaves if norms[k] >= 1e-3 * median]
    out = {"last_loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"])
           if math.isfinite(got["loss"]) else math.inf}
    out["last_change_gap"], out["last_change_leaf"] = _worst_leaf(
        got["change"], want["change"], moving)
    out["last_change_gap_median"] = _median_leaf(got["change"], want["change"], moving)
    stats = [k for k in want["change"] if k not in want["grad"]]
    if stats:
        out["last_stats_gap"], out["last_stats_leaf"] = _worst_leaf(
            got["change"], want["change"], stats)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{name: {"value", "limit"}}`` of each limited number;
    a number that is missing or not finite reads ``None`` and fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        if not isinstance(value, (int, float)) or not math.isfinite(value):
            value = None  # missing or not finite: no number, and a failure
        checks[name] = {"value": value, "limit": limit}
        if value is None or value > limit:
            correct = False
    return correct, checks
