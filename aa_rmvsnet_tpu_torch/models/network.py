"""The core MVS network and its depth sweep, exact fp32 path (port of
``aa_rmvsnet_tpu/models/network.py`` with ``SweepConfig()`` defaults:
unpacked 2x2 patch-table warp, canonical omega, online WTA + logsumexp,
and ``remat`` for training).

``forward`` runs FeatNet on every view, then sweeps the depth hypotheses
block by block: per block it warps each source view through its patch
table, squares the residual against the reference features, reweights it
by omega and averages over views into the variance cost; each hypothesis
then takes one step of the ConvLSTM U-Net, and an online winner-take-all +
logsumexp carry yields depth and confidence.  The JAX ``lax.scan`` over
blocks and slices is a Python loop here, and the view axis is a loop so
that one view's gathered patch rows are live at a time.  With
``SweepConfig.remat`` each depth block runs under one
``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint(block_step)``),
so backpropagation through time keeps only each block's input states
between the forward and the backward, and one block's activations at a
time while it runs.

Public functions keep the JAX package's NHWC shapes; the modules run NCHW.
Profiler ranges (``featnet``, ``sweep.setup``, ``sweep.cost_block``,
``sweep.regularize``, ``sweep.wta``) name the layers for
``tools/profile_main_path.py`` and ``tools/profile_train_step.py``;
outside a profiler they cost a few microseconds each, a few hundred times
per map.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .aggregation import InterViewAA
from .feature import FeatNet
from .regularizer import UNetConvLSTM, init_states
from ..ops.homography import homography_terms, plane_sweep_xy
from ..ops.patch_sample import build_patch_table, patch_bilinear_sample


class AARMVSNetCore(nn.Module):
    """The 187,203-parameter core: ``feature``, ``omega`` and
    ``cost_regularization``, with the reference torch ``state_dict`` keys."""

    def __init__(self):
        super().__init__()
        self.feature = FeatNet()
        self.omega = InterViewAA()
        self.cost_regularization = UNetConvLSTM()


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """depth_block: hypotheses per block (the largest divisor of D that is
    at most this); remat: recompute each block in the backward pass
    (training); collect_volume: also return the ``(B, D, H, W)``
    regularized cost volume (the training loss needs it)."""

    depth_block: int = 16
    remat: bool = False
    collect_volume: bool = True


def pick_depth_block(num_depth: int, target: int) -> int:
    """Largest divisor of ``num_depth`` that is <= ``target``."""
    for block in range(min(target, num_depth), 0, -1):
        if num_depth % block == 0:
            return block
    return 1


def extract_features(model: AARMVSNetCore, imgs: torch.Tensor) -> torch.Tensor:
    """FeatNet on every view, one view at a time.

    Args:
      imgs: ``(B, V, H, W, 3)`` standardized images.

    Returns:
      ``(V, B, H, W, 32)`` features (view-major for the sweep).
    """
    with record_function("featnet"):
        feats = [
            model.feature(imgs[:, v].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            for v in range(imgs.shape[1])
        ]
        return torch.stack(feats)


def _build_cost_block(
    model: AARMVSNetCore,
    ref_feat: torch.Tensor,
    src_tables: list[torch.Tensor],
    rot_grids: list[torch.Tensor],
    transes: list[torch.Tensor],
    depth_block: torch.Tensor,
) -> torch.Tensor:
    """Warp + squared residual + omega reweight + view mean for one block.

    Args:
      ref_feat: ``(B, C, H, W)``.
      src_tables: per source view, a ``(B, H*W, 4C)`` patch table.
      rot_grids: per source view ``(B, 3, H*W)``; transes: ``(B, 3, 1)``.
      depth_block: ``(B, Db)``.

    Returns:
      ``(Db, B, C, H, W)`` negated variance cost slices.
    """
    B, C, H, W = ref_feat.shape
    Db = depth_block.shape[1]
    variance = None
    for table, rot_grid, trans in zip(src_tables, rot_grids, transes):
        x, y = plane_sweep_xy(rot_grid, trans, depth_block)  # (B, Db, H*W)
        warped = patch_bilinear_sample(table, x.reshape(B, -1), y.reshape(B, -1), H, W)
        warped = warped.view(B, Db, H, W, C).permute(0, 1, 4, 2, 3)
        residual_sq = (warped - ref_feat[:, None]) ** 2  # (B, Db, C, H, W)
        weights = model.omega(residual_sq.reshape(B * Db, C, H, W))
        term = (weights.view(B, Db, 1, H, W) + 1.0) * residual_sq
        variance = term if variance is None else variance + term
    variance = variance / len(src_tables)
    return -variance.transpose(0, 1)


def sweep(
    model: AARMVSNetCore,
    features: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_values: torch.Tensor,
    config: SweepConfig = SweepConfig(),
) -> dict:
    """Plane sweep + recurrent regularization.

    Args:
      features: ``(V, B, H, W, C)`` per-view features (view 0 = reference).
      proj_matrices: ``(B, V, 4, 4)``.
      depth_values: ``(B, D)`` hypothesis depths in sweep order.

    Returns dict with ``depth`` ``(B, H, W)`` winner-take-all depth,
    ``photometric_confidence`` ``(B, H, W)`` softmax probability of the
    winner, and, if ``config.collect_volume``, ``cost_volume``
    ``(B, D, H, W)`` (its softmax over D is the probability volume).
    """
    V, B, H, W, C = features.shape
    D = depth_values.shape[1]
    block = pick_depth_block(D, config.depth_block)
    dev = features.device

    with record_function("sweep.setup"):
        ref_feat = features[0].permute(0, 3, 1, 2).contiguous()
        src_tables = [build_patch_table(features[v]) for v in range(1, V)]
        ref_proj = proj_matrices[:, 0]
        terms = [homography_terms(proj_matrices[:, v], ref_proj, H, W)
                 for v in range(1, V)]
        rot_grids = [t[0] for t in terms]
        transes = [t[1] for t in terms]

        states = init_states(B, H, W, dtype=features.dtype, device=dev)
        depth_img = torch.zeros(B, H, W, dtype=torch.float32, device=dev)
        max_cost = torch.full((B, H, W), -torch.inf, dtype=torch.float32, device=dev)
        lse = torch.full((B, H, W), -torch.inf, dtype=torch.float32, device=dev)

    def block_step(states, dblock):
        """Cost block + one ConvLSTM step per hypothesis of ``dblock``.
        The model, reference features, tables and homography terms come in
        by closure; under checkpoint their gradients still flow."""
        with record_function("sweep.cost_block"):
            cost_block = _build_cost_block(
                model, ref_feat, src_tables, rot_grids, transes, dblock
            )
        with record_function("sweep.regularize"):
            costs = []
            for cost_slice in cost_block:
                cost, states = model.cost_regularization(cost_slice, states)
                costs.append(cost[:, 0])
        return states, torch.stack(costs).float()  # (Db, B, H, W)

    volume = []
    for start in range(0, D, block):
        dblock = depth_values[:, start : start + block]  # (B, Db)
        if config.remat:
            states, costs = checkpoint(block_step, states, dblock,
                                       use_reentrant=False)
        else:
            states, costs = block_step(states, dblock)

        # Online WTA: argmax keeps the first maximum in the block and the
        # strict > the earlier block on ties, as the reference's running
        # argmax does.  No gradient flows through depth or confidence.
        with record_function("sweep.wta"), torch.no_grad():
            block_best = torch.argmax(costs, dim=0)
            block_max = costs.max(dim=0).values
            block_depth = torch.gather(
                dblock.T[:, :, None, None].expand_as(costs), 0, block_best[None]
            )[0]
            depth_img = torch.where(block_max > max_cost, block_depth, depth_img)
            max_cost = torch.maximum(max_cost, block_max)
            lse = torch.logaddexp(lse, torch.logsumexp(costs, dim=0))
        if config.collect_volume:
            volume.append(costs)

    out = {"depth": depth_img, "photometric_confidence": torch.exp(max_cost - lse)}
    if config.collect_volume:
        out["cost_volume"] = torch.cat(volume).permute(1, 0, 2, 3)
    return out


def forward(
    model: AARMVSNetCore,
    imgs: torch.Tensor,
    proj_matrices: torch.Tensor,
    depth_values: torch.Tensor,
    config: SweepConfig = SweepConfig(),
) -> dict:
    """Full forward: features + sweep.  ``imgs``: ``(B, V, H, W, 3)``.

    Differentiable in the model's parameters through ``cost_volume``
    (``depth`` and ``photometric_confidence`` carry no gradient).  On CUDA
    every ConvLSTM cell launches the gate kernel once per hypothesis:
    5 x D forward launches, and under ``remat`` 5 x D more when the
    backward recomputes each block, plus 5 x D backward-kernel launches.
    """
    return sweep(model, extract_features(model, imgs), proj_matrices,
                 depth_values, config)


def probability_volume(cost_volume: torch.Tensor) -> torch.Tensor:
    """Softmax over the depth axis."""
    return torch.softmax(cost_volume, dim=1)
