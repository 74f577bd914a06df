"""Recurrent cost regularization: a 5-cell ConvLSTM U-Net applied once per
depth hypothesis (port of ``aa_rmvsnet_tpu/models/regularizer.py``), NCHW.

    cell0 @ full res (32 -> 16) -- pool -- cell1 @ 1/2 (16 -> 16) -- pool --
    cell2 @ 1/4 (16 -> 16) -- deconv -- cat(h1) -- cell3 @ 1/2 (32 -> 16) --
    deconv -- cat(h0) -- cell4 @ full (32 -> 8) -- 3x3 conv -- 1-ch cost
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ConvLSTMCell, DeconvGNReLU
from ..parallel.spatial import conv2d_rows

HIDDEN_DIMS = (16, 16, 16, 16, 8)


class UNetConvLSTM(nn.Module):
    """One depth step: ``forward(x, states) -> (cost, new_states)``.

    ``x`` is the negated variance cost slice ``(B, 32, H, W)`` (H, W
    divisible by 4); ``states`` is a 5-tuple of ``(h, c)`` pairs at
    resolutions (1, 1/2, 1/4, 1/2, 1).
    """

    def __init__(self):
        super().__init__()
        self.cell_list = nn.ModuleList([
            ConvLSTMCell(32, 16),
            ConvLSTMCell(16, 16),
            ConvLSTMCell(16, 16),
            ConvLSTMCell(32, 16),
            ConvLSTMCell(32, 8),
        ])
        self.deconv_0 = DeconvGNReLU(16, 16)
        self.deconv_1 = DeconvGNReLU(16, 16)
        self.conv_0 = nn.Conv2d(8, 1, 3, padding=1)

    def forward(self, x, states, mesh=None):
        """One depth step; on a spatial ``mesh`` (``parallel/spatial.py``)
        of the rank's slab, ``states`` the slab's: the cells' and the
        output's 3x3 convolutions with their halos, the gate kernel and the
        max-pools on the slab as it is, the transposed convolutions with the
        row below and their GroupNorm over every rank's rows."""
        cells = self.cell_list
        s0 = cells[0](x, states[0], mesh)
        s1 = cells[1](F.max_pool2d(s0[0], 2, 2), states[1], mesh)
        s2 = cells[2](F.max_pool2d(s1[0], 2, 2), states[2], mesh)
        s3 = cells[3](torch.cat([self.deconv_0(s2[0], mesh), s1[0]], dim=1), states[3], mesh)
        s4 = cells[4](torch.cat([self.deconv_1(s3[0], mesh), s0[0]], dim=1), states[4], mesh)
        return conv2d_rows(self.conv_0, s4[0], mesh), (s0, s1, s2, s3, s4)


def init_states(batch: int, height: int, width: int, dtype=torch.float32, *, device):
    """Zero hidden state for the 5-cell U-Net on ``device`` (a keyword the
    caller always gives), at ``height x width``: the whole map's, or a
    spatial rank's slab's."""
    if height % 4 or width % 4:
        raise ValueError(f"feature size ({height},{width}) must be divisible by 4")
    sizes = [
        (height, width), (height // 2, width // 2), (height // 4, width // 4),
        (height // 2, width // 2), (height, width),
    ]
    return tuple(
        (torch.zeros(batch, hid, h, w, dtype=dtype, device=device),
         torch.zeros(batch, hid, h, w, dtype=dtype, device=device))
        for hid, (h, w) in zip(HIDDEN_DIMS, sizes)
    )
