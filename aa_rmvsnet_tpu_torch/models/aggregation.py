"""Inter-view adaptive aggregation ("omega"), canonical form (port of
``aa_rmvsnet_tpu/models/aggregation.py:InterViewAA``), NCHW.

A pixel-wise reweighting network applied to each warped squared-residual
volume; its sigmoid output ``w`` enters the cost as ``(w + 1) * residual``.
"""

from __future__ import annotations

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
