"""Training loss of the core network (port of
``aa_rmvsnet_tpu/models/losses.py:depth_classification_loss``): the masked
one-hot cross-entropy over the depth probability volume, the loss that
produced the shipped checkpoints (reference ``mvsnet_cls_loss``).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce_sum_


def depth_classification_loss(
    prob_volume: torch.Tensor,
    depth_gt: torch.Tensor,
    mask: torch.Tensor,
    depth_values: torch.Tensor,
    eps: float = 1e-12,
    group=None,
):
    """Masked cross-entropy against the nearest-hypothesis one-hot bin.

    Args:
      prob_volume: ``(B, D, H, W)`` softmax probability volume.
      depth_gt: ``(B, H, W)`` ground-truth depth.
      mask: ``(B, H, W)`` float validity mask (1 = supervised).
      depth_values: ``(B, D)`` hypothesis depths (sweep order).
      group: the spatial process group whose ranks hold the rows of the
        maps (``parallel/spatial.py``), or None.  The valid count is then
        summed over its ranks, and the loss returned is this rank's share:
        the ranks' shares sum to the loss of the whole maps, and so do the
        gradients they give.

    Returns:
      ``(loss, wta_depth)``: the scalar mean masked CE and the ``(B, H, W)``
      winner-take-all depth.  The GT bin is ``argmin |d_k - gt|`` (first
      on ties); masked-out pixels are forced to bin 0 and contribute
      nothing; per-image sums are normalised by the valid count plus 1e-6,
      then averaged over the batch.
    """
    dvals = depth_values[:, :, None, None]  # (B, D, 1, 1)
    gt_index = torch.argmin(torch.abs(dvals - depth_gt[:, None]), dim=1)
    gt_index = torch.round(mask * gt_index).long()

    gt_prob = torch.gather(prob_volume, 1, gt_index[:, None])[:, 0]
    ce = -torch.log(gt_prob + eps)
    valid = mask.sum(dim=(1, 2))
    if group is not None:
        all_reduce_sum_([valid], group)
    valid = valid + 1e-6
    loss = ((mask * ce).sum(dim=(1, 2)) / valid).mean()

    wta_index = torch.argmax(prob_volume, dim=1)
    wta_depth = torch.gather(dvals.expand_as(prob_volume), 1, wta_index[:, None])[:, 0]
    return loss, wta_depth
