"""Per-view 2D feature extraction with intra-view adaptive aggregation
(port of ``aa_rmvsnet_tpu/models/feature.py``), NCHW.

A three-scale pyramid (stride 1 / 2 / 4), each scale refined by a
modulated deformable conv and channel-compressed (16 / 8 / 8), upsampled
back to full resolution with align-corners bilinear and concatenated into
a 32-channel full-resolution feature map.

Given a spatial ``mesh``, ``forward`` computes the same on the rank's slab
of rows (``parallel/spatial.py``): the 3x3 convolutions with their halos, the
stride-2 ones with the row above, every GroupNorm with statistics over
every rank's rows, the deformable convolutions' taps sampled from the
gathered map, and the coarse scales gathered, upsampled whole and sliced
to the slab, so that the arithmetic is the unsharded one.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import ConvGNReLU, DeformConvGNReLU
from ..ops.resize import resize_bilinear_align_corners
from ..parallel.spatial import gather_rows, map_rows, slab_row0


class IntraViewAA(nn.Module):
    """Deformable refinement + multi-scale fuse."""

    def __init__(self):
        super().__init__()
        self.deformconv0 = DeformConvGNReLU(32, 32)
        self.conv0 = ConvGNReLU(32, 16, kernel=1)
        self.deformconv1 = DeformConvGNReLU(32, 32)
        self.conv1 = ConvGNReLU(32, 8, kernel=1)
        self.deformconv2 = DeformConvGNReLU(32, 32)
        self.conv2 = ConvGNReLU(32, 8, kernel=1)

    def forward(self, x0, x1, x2, mesh=None):
        m0 = self.conv0(self.deformconv0(x0, mesh), mesh)
        m1 = self.conv1(self.deformconv1(x1, mesh), mesh)
        m2 = self.conv2(self.deformconv2(x2, mesh), mesh)
        h, w = x0.shape[2:]
        # The coarse scales whole, upsampled, then the slab's rows.
        m1, m2 = (resize_bilinear_align_corners(m, m.shape[2] * k, m.shape[3] * k)
                  for m, k in ((gather_rows(m1, mesh), 2), (gather_rows(m2, mesh), 4)))
        if any(m.shape[2:] != (map_rows(x0, mesh), w) for m in (m1, m2)):
            raise ValueError("input H, W must be divisible by 4 so the pyramid re-aligns")
        row0 = slab_row0(x0, mesh)
        return torch.cat([m0, m1[:, :, row0:row0 + h], m2[:, :, row0:row0 + h]], dim=1)


class FeatNet(nn.Module):
    """Feature extractor: 2-conv stem, 3-scale pyramid, intra-view AA fuse.
    In: ``(N, 3, H, W)`` standardized images; out: ``(N, 32, H, W)``."""

    def __init__(self):
        super().__init__()
        self.init_conv = nn.Sequential(ConvGNReLU(3, 8), ConvGNReLU(8, 16))
        self.conv0 = ConvGNReLU(16, 32)
        self.conv1 = ConvGNReLU(32, 32, stride=2)
        self.conv2 = ConvGNReLU(32, 32, stride=2)
        self.intraAA = IntraViewAA()

    def forward(self, x, mesh=None):
        """The features of ``x``, or on a spatial ``mesh`` of the rank's slab
        ``x`` its rows of them."""
        if x.is_cpu and x.shape[0] > 1:
            # The CPU's kernels (oneDNN's convolutions, MKL's small GEMMs, the
            # channels-last GroupNorm) pick their algorithm by batch size, so
            # a view's features would depend on the views batched with it.
            return torch.cat([self._features(s, mesh) for s in x.split(1)])
        return self._features(x, mesh)

    def _features(self, x, mesh):
        for block in (*self.init_conv, self.conv0):
            x = block(x, mesh)
        x1 = self.conv1(x, mesh)
        x2 = self.conv2(x1, mesh)
        return self.intraAA(x, x1, x2, mesh)
