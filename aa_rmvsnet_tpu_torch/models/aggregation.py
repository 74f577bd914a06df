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

On an int8 input (the int8 and dual residual levers) ``omega_folded`` runs
rw0 as an int8 convolution and the rest in bf16; with the environment
variable ``AA_RMVSNET_OMEGA_INT8=chain``, read where the JAX package reads
it (on an int8 input, at each call), the stems and rw2 take int8
activations too (:func:`_omega_chain`).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.patch_sample import true_div
from ..parallel.spatial import conv2d_rows, conv_halo, halo_rows, spatial_mean
from ..utils.spans import span
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
        with span("sweep.omega"):
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
    Inside the profiler range ``groupnorm``.
    """
    N, GC = x.shape[:2]
    c = GC // groups

    def mean_hw(t):
        return spatial_mean(t, (2, 3), mesh)

    with span("groupnorm"):
        x32 = x.float()
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


def _quant_kernel(kernel: torch.Tensor,
                  act_scale: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_quant_kernel``: ``kernel`` ``(cout, cin, kh,
    kw)`` in fp32, times the per-input-channel activation scale
    ``act_scale`` where one is given, quantized per output channel onto
    +-127 (``kmax`` over its (cin, kh, kw)).  Returns the integer-valued
    kernel and the fp32 dequantization scale ``kmax / 127``."""
    k = kernel.float()
    if act_scale is not None:
        k = k * act_scale[None, :, None, None]
    kmax = torch.clamp_min(k.abs().amax(dim=(1, 2, 3)), 1e-12)
    kq = torch.clamp(torch.round(k / kmax[:, None, None, None] * 127.0), -127, 127)
    return kq, true_div(kmax, 127.0)


def _tile(v: torch.Tensor, groups: int) -> torch.Tensor:
    """A per-channel vector tiled over the G folded volumes, shaped to
    broadcast over NCHW."""
    return v.repeat(groups)[:, None, None]


def _conv8(x: torch.Tensor, conv: nn.Conv2d, kq: torch.Tensor, co_scale: torch.Tensor,
           groups: int, mesh=None) -> torch.Tensor:
    """``conv``'s G-grouped int8 convolution of the int8 NCHW ``x`` with
    the quantized kernel ``kq`` (the JAX package's ``_conv8``): the exact
    integer sum rounded once to bf16 (:func:`int8_conv`), times the
    dequantization scale in bf16, plus the bias in bf16.  On a spatial
    ``mesh``'s slab with the halo the kernel reads."""
    padding = conv.padding
    if mesh is not None:
        above, below = conv_halo(conv.kernel_size[0], 1, padding[0])
        if above or below:
            x = halo_rows(x, above, below, mesh)
        padding = (0, padding[1])
    y = int8_conv(x, kq.repeat(groups, 1, 1, 1), padding, groups)
    return y * _tile(co_scale.to(torch.bfloat16), groups) + _tile(
        conv.bias.to(torch.bfloat16), groups)


#: The int8 chain's clip of a GroupNorm output, in standard deviations (the
#: JAX package's ``sb``).
CHAIN_SIGMAS = 8.0


def _gn_bound(gn: nn.GroupNorm) -> torch.Tensor:
    """The int8 chain's static bound of ``|gn|``'s output per channel,
    ``|weight| * 8 + |bias|`` in fp32.  As in the JAX package it has no
    floor: a channel whose weight and bias are 0 gets the scale 0."""
    return gn.weight.float().abs() * CHAIN_SIGMAS + gn.bias.float().abs()


def _quant_act(x: torch.Tensor, bound: torch.Tensor, groups: int) -> torch.Tensor:
    """A non-negative bf16 activation onto int8 with the per-channel scale
    ``bound / 127`` rounded to bf16: ``round(x / a)`` in bf16, clipped to
    [0, 127] (the JAX package's ``quant_act``)."""
    a = _tile(true_div(bound, 127.0).to(torch.bfloat16), groups)
    return torch.clamp(torch.round(x / a), 0, 127).to(torch.int8)


def _omega_chain(omega: InterViewAA, y: torch.Tensor, groups: int, mesh=None) -> torch.Tensor:
    """The rest of omega after its int8 rw0 (``y``, bf16 NCHW) with int8
    activations, the JAX package's ``AA_RMVSNET_OMEGA_INT8=chain``
    (``aggregation.py:164-236``): each GroupNorm output is clipped to its
    static bound (:func:`_gn_bound`) and quantized onto int8
    (:func:`_quant_act`), and its scale folded into the next kernel before
    that kernel's own per-output-channel quantization (:func:`_quant_kernel`);
    the stems and rw2 are int8 convolutions (:func:`_conv8`: 1x1 sums over
    4 channels, at most 4 x 127 x 127).  The residual add dequantizes the
    block's input; the bound of ``relu(z + y)`` is rw1's GroupNorm bound
    plus rw0's.  As in the JAX package, the int32 sums are cast to bf16
    before the dequantization scale multiplies them.  Returns rw2's bf16
    output before the sigmoid, NCHW."""
    rw0, rw1, rw2 = omega.reweight_network[:3]
    stem0, stem1, stem_gn = rw1.stem
    b1 = _gn_bound(rw0[1])
    yq = _quant_act(torch.relu(_group_norm_folded(y, rw0[1], groups, mesh)), b1, groups)
    b2 = _gn_bound(stem0[1])
    z = _conv8(yq, stem0[0], *_quant_kernel(stem0[0].weight, true_div(b1, 127.0)), groups)
    zq = _quant_act(torch.relu(_group_norm_folded(z, stem0[1], groups, mesh)), b2, groups)
    z = _conv8(zq, stem1, *_quant_kernel(stem1.weight, true_div(b2, 127.0)), groups)
    z = _group_norm_folded(z, stem_gn, groups, mesh)
    y_deq = yq.to(torch.bfloat16) * _tile(true_div(b1, 127.0).to(torch.bfloat16), groups)
    b3 = _gn_bound(stem_gn) + b1
    sq = _quant_act(torch.relu(z + y_deq), b3, groups)
    return _conv8(sq, rw2, *_quant_kernel(rw2.weight, true_div(b3, 127.0)), groups)


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
        model's dtype, as in the JAX package, or on int8 activations with
        ``AA_RMVSNET_OMEGA_INT8=chain`` (:func:`_omega_chain`).
      mesh: a spatial mesh when ``x`` is a rank's slab of rows, else None.

    Returns:
      ``(N, H, W, groups)`` sigmoid weights, one channel per volume, in
      x's dtype (bf16 for an int8 ``x``).
    """
    with span("sweep.omega"):
        return torch.sigmoid(_omega_folded_logits(omega, x, groups, input_scale, mesh)
                             ).permute(0, 2, 3, 1)


def _omega_folded_logits(omega: InterViewAA, x: torch.Tensor, groups: int,
                         input_scale: torch.Tensor | None, mesh) -> torch.Tensor:
    """:func:`omega_folded` before its sigmoid, NCHW.  The sigmoid stays
    outside the ``quant.*`` ranges, so that ``sweep.omega`` ends with a
    kernel of its own (``utils/spans.py``)."""
    rw0, rw1, rw2 = omega.reweight_network[:3]
    stem0, stem1, stem_gn = rw1.stem
    conv0 = rw0[0]
    kernel = conv0.weight
    if input_scale is not None:
        kernel = kernel * input_scale.to(kernel.dtype)[None, :, None, None]
    y = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC volumes
    if x.dtype == torch.int8:
        with span("quant.omega_int8_rw0"):
            y = _conv8(y, conv0, *_quant_kernel(kernel), groups, mesh)
        if os.environ.get("AA_RMVSNET_OMEGA_INT8") == "chain":
            with span("quant.omega_int8_chain"):
                return _omega_chain(omega, y, groups, mesh)
    else:
        y = _conv_folded(y, conv0, groups, kernel, mesh)
    y = torch.relu(_group_norm_folded(y, rw0[1], groups, mesh))
    z = torch.relu(_group_norm_folded(_conv_folded(y, stem0[0], groups), stem0[1], groups, mesh))
    z = _group_norm_folded(_conv_folded(z, stem1, groups), stem_gn, groups, mesh)
    y = torch.relu(z + y)
    return _conv_folded(y, rw2, groups)
