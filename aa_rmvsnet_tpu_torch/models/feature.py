"""Per-view 2D feature extraction with intra-view adaptive aggregation
(port of ``aa_rmvsnet_tpu/models/feature.py``), NCHW.

A three-scale pyramid (stride 1 / 2 / 4), each scale refined by a
modulated deformable conv and channel-compressed (16 / 8 / 8), upsampled
back to full resolution with align-corners bilinear and concatenated into
a 32-channel full-resolution feature map.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import ConvGNReLU, DeformConvGNReLU
from ..ops.resize import resize_bilinear_align_corners


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

    def forward(self, x0, x1, x2):
        m0 = self.conv0(self.deformconv0(x0))
        m1 = self.conv1(self.deformconv1(x1))
        m2 = self.conv2(self.deformconv2(x2))
        h, w = x0.shape[2:]
        m1 = resize_bilinear_align_corners(m1, m1.shape[2] * 2, m1.shape[3] * 2)
        m2 = resize_bilinear_align_corners(m2, m2.shape[2] * 4, m2.shape[3] * 4)
        if m1.shape[2:] != (h, w) or m2.shape[2:] != (h, w):
            raise ValueError("input H, W must be divisible by 4 so the pyramid re-aligns")
        return torch.cat([m0, m1, m2], dim=1)


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

    def forward(self, x):
        if x.is_cpu and x.shape[0] > 1:
            # The CPU's kernels (oneDNN's convolutions, MKL's small GEMMs, the
            # channels-last GroupNorm) pick their algorithm by batch size, so
            # a view's features would depend on the views batched with it.
            return torch.cat([self._features(s) for s in x.split(1)])
        return self._features(x)

    def _features(self, x):
        x0 = self.conv0(self.init_conv(x))
        x1 = self.conv1(x0)
        x2 = self.conv2(x1)
        return self.intraAA(x0, x1, x2)
