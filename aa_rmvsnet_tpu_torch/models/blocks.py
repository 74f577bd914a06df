"""Building blocks (port of ``aa_rmvsnet_tpu/models/blocks.py``), NCHW.

Numerics follow the reference primitives: GroupNorm with ``max(1, C//8)``
groups and eps 1e-5; convs with bias and symmetric explicit padding; the
2x upsampling ``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``; the
ConvLSTM gate conv over ``cat(x, h)`` producing channels (i, f, o, g).

Submodule names are the reference torch names, so ``state_dict`` keys match
the shipped checkpoints (``ConvGNReLU`` is a ``Sequential`` whose ``0`` is
the conv and ``1`` the GroupNorm, and so on).

Each block's ``forward(x, ..., mesh=None)`` takes a spatial mesh for a
slab of rows of the map (``parallel/spatial.py``), with the same
parameters: the convolutions with their halos, GroupNorm with statistics
over every rank's rows.  Without one it is the plain module call.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.deform import deform_conv
from ..ops.gates import lstm_gates
from ..parallel.spatial import (
    conv2d_rows,
    conv_transpose_rows,
    gather_rows,
    group_norm_rows,
    slab_row0,
)


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(max(1, channels // 8), channels, eps=1e-5)


class ConvGNReLU(nn.Sequential):
    """conv + GroupNorm(C/8) + ReLU."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1):
        pad = ((kernel - 1) // 2) * dilation
        super().__init__(
            nn.Conv2d(in_c, out_c, kernel, stride=stride, padding=pad,
                      dilation=dilation),
            group_norm(out_c),
            nn.ReLU(),
        )

    def forward(self, x, mesh=None):
        return torch.relu(group_norm_rows(conv2d_rows(self[0], x, mesh), self[1], mesh))


class ResnetBlockGN(nn.Module):
    """conv-gn-relu -> conv-gn, plus the input, then relu."""

    def __init__(self, channels: int, kernel: int = 3):
        super().__init__()
        pad = (kernel - 1) // 2
        self.stem = nn.Sequential(
            ConvGNReLU(channels, channels, kernel),
            nn.Conv2d(channels, channels, kernel, padding=pad),
            group_norm(channels),
        )

    def forward(self, x, mesh=None):
        block, conv, gn = self.stem
        y = conv2d_rows(conv, block(x, mesh), mesh)
        return torch.relu(group_norm_rows(y, gn, mesh) + x)


class DeconvGNReLU(nn.Module):
    """2x-upsampling transposed conv + GroupNorm + ReLU."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_c, out_c, 3, stride=2, padding=1,
                                       output_padding=1)
        self.gn = group_norm(out_c)

    def forward(self, x, mesh=None):
        return torch.relu(group_norm_rows(conv_transpose_rows(self.conv, x, mesh), self.gn,
                                          mesh))


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell: one 3x3 conv over ``cat(x, h)`` producing
    the four gates, then the gate math in :func:`..ops.gates.lstm_gates`
    (the CUDA kernel on the card)."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.conv = nn.Conv2d(input_dim + hidden, 4 * hidden, 3, padding=1)

    def forward(self, x, state, mesh=None):
        h, c = state
        return lstm_gates(conv2d_rows(self.conv, torch.cat([x, h], dim=1), mesh), c)


class DeformConv(nn.Module):
    """Modulated deformable conv v2 (3x3): offset (18 ch) and sigmoid
    modulation (9 ch) branches.  :func:`.init.init_like_jax`, which
    :class:`.network.AARMVSNetCore` applies, zeroes both branches' weights
    and biases as the JAX package does, so every offset starts at 0 and
    every modulation at 0.5.

    ``conv`` holds the tap weights (the reference applies it as a stride-3
    conv over re-tiled taps); :func:`..ops.deform.deform_conv` contracts
    them tap by tap.
    """

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, 3, stride=3)
        self.p_conv = nn.Conv2d(in_c, 18, 3, padding=1)
        self.m_conv = nn.Conv2d(in_c, 9, 3, padding=1)

    def forward(self, x, mesh=None):
        """On a spatial ``mesh``, the slab's output rows: the offsets and
        modulations from the slab with its halo, the taps sampled from the
        whole map, since an offset may reach any row."""
        offset = conv2d_rows(self.p_conv, x, mesh)
        modulation = torch.sigmoid(conv2d_rows(self.m_conv, x, mesh))
        return deform_conv(gather_rows(x, mesh), offset, modulation, self.conv.weight,
                           self.conv.bias, row0=slab_row0(x, mesh))


class DeformConvGNReLU(nn.Sequential):
    """DeformConv + GroupNorm(C/8) + ReLU."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__(DeformConv(in_c, out_c), group_norm(out_c), nn.ReLU())

    def forward(self, x, mesh=None):
        return torch.relu(group_norm_rows(self[0](x, mesh), self[1], mesh))
