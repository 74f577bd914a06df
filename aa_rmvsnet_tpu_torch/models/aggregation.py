"""Inter-view adaptive aggregation ("omega"), port of
``aa_rmvsnet_tpu/models/aggregation.py``, NCHW.

A pixel-wise reweighting network applied to each warped squared-residual
volume; its sigmoid output ``w`` enters the cost as ``(w + 1) * residual``.
Two forms of the same network:

- :class:`InterViewAA`, the canonical module on an ``(N, 32, H, W)`` batch;
- :func:`omega_folded`, the same parameters with ``G`` volumes folded into
  the channel axis (``(N, H, W, G*32)``): G-grouped convolutions with the
  weights tiled G times and a group norm per volume.  The depth-folded cost
  layouts (packed rows, ``fold_omega``) hand it their residual as it lies,
  channels last, with no transpose.  The JAX package runs the grouped
  convolutions as dense ones with block-diagonal kernels, a workaround for
  the TPU's lane padding that spends G times the operations; the port does
  not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ConvGNReLU, ResnetBlockGN


class InterViewAA(nn.Module):
    """``(N, 32, H, W)`` squared residual -> ``(N, 1, H, W)`` weight."""

    def __init__(self):
        super().__init__()
        self.reweight_network = nn.Sequential(
            ConvGNReLU(32, 4),
            ResnetBlockGN(4, kernel=1),
            nn.Conv2d(4, 1, 1),
            nn.Sigmoid(),
        )

    def forward(self, x):
        return self.reweight_network(x)


def _group_norm_folded(x: torch.Tensor, gn: nn.GroupNorm, groups: int) -> torch.Tensor:
    """One-group GroupNorm per folded volume of an ``(N, G*c, H, W)``
    tensor, with ``gn``'s affine tiled over the G volumes.

    The moments follow the JAX package's ``_group_norm_folded``: exact
    two-pass fp32 moments for fp32 input; for bf16 input one pass of fp32
    E[x] and E[x^2] (var = E[x^2] - E[x]^2, floored at 0).  Either way the
    normalised value is cast to x's dtype before the affine, which then
    runs in x's dtype (so a bf16 result rounds twice, as JAX's does).
    """
    N, GC = x.shape[:2]
    c = GC // groups
    x32 = x.float()
    mu_c = x32.mean(dim=(2, 3))  # (N, G*c)
    mu_g = mu_c.view(N, groups, c).mean(dim=2)  # (N, G): equal counts, exact
    d = x32 - mu_g.repeat_interleave(c, dim=1)[:, :, None, None]
    if x.dtype == torch.float32:
        var_g = d.square().mean(dim=(2, 3)).view(N, groups, c).mean(dim=2)
    else:
        m2_g = x32.square().mean(dim=(2, 3)).view(N, groups, c).mean(dim=2)
        var_g = torch.clamp_min(m2_g - mu_g.square(), 0.0)
    inv = torch.rsqrt(var_g + gn.eps).repeat_interleave(c, dim=1)[:, :, None, None]
    norm = (d * inv).to(x.dtype)
    weight = gn.weight.to(x.dtype).repeat(groups)[:, None, None]
    bias = gn.bias.to(x.dtype).repeat(groups)[:, None, None]
    return norm * weight + bias


def _conv_folded(x: torch.Tensor, conv: nn.Conv2d, groups: int) -> torch.Tensor:
    """``conv`` applied to each of the G folded volumes: a G-grouped
    convolution with the weights and bias tiled G times."""
    return F.conv2d(x, conv.weight.to(x.dtype).repeat(groups, 1, 1, 1),
                    conv.bias.to(x.dtype).repeat(groups), padding=conv.padding,
                    groups=groups)


def omega_folded(omega: InterViewAA, x: torch.Tensor, groups: int) -> torch.Tensor:
    """The omega network with ``groups`` volumes folded into channels.

    Computes what :class:`InterViewAA` computes on each of the G volumes
    (``tests/test_torch_packed.py`` holds it to the module and to the JAX
    package's ``omega_folded``).

    Args:
      omega: the model's :class:`InterViewAA` (its parameters are used).
      x: ``(N, H, W, groups*32)`` folded residual volumes, any strides; a
        channels-last residual is read in place.
      groups: number of folded volumes G.

    Returns:
      ``(N, H, W, groups)`` sigmoid weights, one channel per volume.
    """
    rw0, rw1, rw2 = omega.reweight_network[:3]
    stem0, stem1, stem_gn = rw1.stem
    y = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC volumes
    y = torch.relu(_group_norm_folded(_conv_folded(y, rw0[0], groups), rw0[1], groups))
    z = torch.relu(_group_norm_folded(_conv_folded(y, stem0[0], groups), stem0[1], groups))
    z = _group_norm_folded(_conv_folded(z, stem1, groups), stem_gn, groups)
    y = torch.relu(z + y)
    return torch.sigmoid(_conv_folded(y, rw2, groups)).permute(0, 2, 3, 1)
