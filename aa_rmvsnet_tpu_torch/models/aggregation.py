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

Both take a spatial ``mesh`` (``parallel/spatial.py``) on a rank's slab of
rows: rw0's 3x3 convolution with its halo, every GroupNorm's statistics
over every rank's rows, the 1x1 convolutions on the slab as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..ops.patch_sample import true_div
from ..parallel.spatial import conv2d_rows, conv_halo, halo_rows, spatial_mean
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

    def forward(self, x, mesh=None):
        rw0, rw1, rw2, sigmoid = self.reweight_network
        return sigmoid(rw2(rw1(rw0(x, mesh), mesh)))


def _group_norm_folded(x: torch.Tensor, gn: nn.GroupNorm, groups: int,
                       mesh=None) -> torch.Tensor:
    """One-group GroupNorm per folded volume of an ``(N, G*c, H, W)``
    tensor, with ``gn``'s affine tiled over the G volumes; on a spatial
    ``mesh`` every mean over (H, W) is over every rank's rows.

    The moments follow the JAX package's ``_group_norm_folded``: exact
    two-pass fp32 moments for fp32 input; for bf16 input one pass of fp32
    E[x] and E[x^2] (var = E[x^2] - E[x]^2, floored at 0).  Either way the
    normalised value is cast to x's dtype before the affine, which then
    runs in x's dtype (so a bf16 result rounds twice, as JAX's does).
    """
    N, GC = x.shape[:2]
    c = GC // groups
    x32 = x.float()

    def mean_hw(t):
        return spatial_mean(t, (2, 3), mesh)

    mu_c = mean_hw(x32)  # (N, G*c)
    mu_g = mu_c.view(N, groups, c).mean(dim=2)  # (N, G): equal counts, exact
    d = x32 - mu_g.repeat_interleave(c, dim=1)[:, :, None, None]
    if x.dtype == torch.float32:
        var_g = mean_hw(d.square()).view(N, groups, c).mean(dim=2)
    else:
        m2_g = mean_hw(x32.square()).view(N, groups, c).mean(dim=2)
        var_g = torch.clamp_min(m2_g - mu_g.square(), 0.0)
    inv = torch.rsqrt(var_g + gn.eps).repeat_interleave(c, dim=1)[:, :, None, None]
    norm = (d * inv).to(x.dtype)
    weight = gn.weight.to(x.dtype).repeat(groups)[:, None, None]
    bias = gn.bias.to(x.dtype).repeat(groups)[:, None, None]
    return norm * weight + bias


def _conv_folded(x: torch.Tensor, conv: nn.Conv2d, groups: int,
                 weight: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """``conv`` applied to each of the G folded volumes: a G-grouped
    convolution with the weights (``conv``'s, or ``weight`` in their
    place) and bias tiled G times; on a spatial ``mesh``'s slab with the
    halo it reads."""
    weight = (conv.weight if weight is None else weight).to(x.dtype).repeat(groups, 1, 1, 1)
    bias = conv.bias.to(x.dtype).repeat(groups)
    return conv2d_rows(conv, x, mesh, weight=weight, bias=bias, groups=groups)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, padding: int, groups: int) -> torch.Tensor:
    """Grouped convolution of an int8 input with an integer-valued kernel
    (in [-127, 127]) as the JAX int8 convolution's int32 result cast to
    bf16: the exact integer sum, rounded once.

    Every operand is an integer of at most 8 bits, exact in bf16, and a 3x3
    sum over 32 input channels is at most 9 * 32 * 127 * 127 = 4,645,152 <
    2^24, exact in the fp32 accumulator of a bf16 convolution, which then
    rounds once.  bf16 operands, because an fp32 3x3 convolution may take
    cuDNN's Winograd or FFT algorithms, whose transforms do not keep
    integers exact.  Torch has no int8 convolution on CUDA.
    """
    return F.conv2d(x.to(torch.bfloat16), weight.to(torch.bfloat16), padding=padding,
                    groups=groups)


def omega_folded(omega: InterViewAA, x: torch.Tensor, groups: int,
                 input_scale: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """The omega network with ``groups`` volumes folded into channels.

    Computes what :class:`InterViewAA` computes on each of the G volumes
    (``tests/test_torch_packed.py`` holds it to the module and to the JAX
    package's ``omega_folded``).

    Args:
      omega: the model's :class:`InterViewAA` (its parameters are used).
      x: ``(N, H, W, groups*32)`` folded residual volumes, any strides; a
        channels-last residual is read in place.
      groups: number of folded volumes G.
      input_scale: optional ``(32,)`` dequantization factors of a quantized
        ``x`` (the residual levers): folded into rw0's kernel input
        channels, in the kernel's dtype, so that ``omega_folded(o, q, G, s)
        == omega_folded(o, q * tile(s), G)`` without the dequantized
        residual ever existing.  On an int8 ``x`` rw0 is the JAX package's
        int8 convolution: the folded kernel quantized per output channel
        onto +-127 (``kmax`` over its (cin, kh, kw)), the exact integer
        convolution (:func:`int8_conv`), then ``kmax / 127`` and the bias
        in bf16; the rest of the chain then runs in bf16 whatever the
        model's dtype, as in the JAX package.
      mesh: a spatial mesh when ``x`` is a rank's slab of rows, else None.

    Returns:
      ``(N, H, W, groups)`` sigmoid weights, one channel per volume, in
      x's dtype (bf16 for an int8 ``x``).
    """
    rw0, rw1, rw2 = omega.reweight_network[:3]
    stem0, stem1, stem_gn = rw1.stem
    conv0 = rw0[0]
    kernel = conv0.weight
    if input_scale is not None:
        kernel = kernel * input_scale.to(kernel.dtype)[None, :, None, None]
    y = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC volumes
    if x.dtype == torch.int8:
        with record_function("quant.omega_int8_rw0"):
            k = kernel.float()
            kmax = torch.clamp_min(k.abs().amax(dim=(1, 2, 3)), 1e-12)  # per output channel
            kq = torch.clamp(torch.round(k / kmax[:, None, None, None] * 127.0), -127, 127)
            padding = conv0.padding
            if mesh is not None:
                y = halo_rows(y, *conv_halo(3, 1, padding[0]), mesh)
                padding = (0, padding[1])
            y = int8_conv(y, kq.repeat(groups, 1, 1, 1), padding, groups)
            y = y * true_div(kmax, 127.0).to(torch.bfloat16).repeat(groups)[:, None, None]
            y = y + conv0.bias.to(torch.bfloat16).repeat(groups)[:, None, None]
    else:
        y = _conv_folded(y, conv0, groups, kernel, mesh)
    y = torch.relu(_group_norm_folded(y, rw0[1], groups, mesh))
    z = torch.relu(_group_norm_folded(_conv_folded(y, stem0[0], groups), stem0[1], groups, mesh))
    z = _group_norm_folded(_conv_folded(z, stem1, groups), stem_gn, groups, mesh)
    y = torch.relu(z + y)
    return torch.sigmoid(_conv_folded(y, rw2, groups)).permute(0, 2, 3, 1)
