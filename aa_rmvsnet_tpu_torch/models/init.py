"""The JAX package's initial weights, drawn by PyTorch.

flax initialises every ``nn.Conv`` kernel, and the kernels the JAX package
declares itself (the 2D and 3D deconvolutions, the deformable conv's taps),
lecun-normal: a unit normal truncated at +-2, scaled by
``sqrt(1 / fan_in) / 0.87962566103423978`` so that the standard deviation is
``sqrt(1 / fan_in)``, with ``fan_in = prod(kernel size) * C_in``.  A
deconvolution's kernel is that of the equivalent forward convolution, so its
``C_in`` is the deconvolution's input channels.  Biases start at 0,
GroupNorm and BatchNorm at scale 1 and bias 0, BatchNorm's statistics at
mean 0 and variance 1, and the deformable convs' offset and modulation
branches (``p_conv``, ``m_conv``) at 0, weights and biases, so that every
offset starts at 0 and every modulation at 0.5
(``aa_rmvsnet_tpu/models/blocks.py:157-166``).

The draws come from PyTorch's generator, so they are not JAX's numbers: the
distributions are the same.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .blocks import DeformConv

#: The standard deviation of a unit normal truncated at +-2.
TRUNCATED_STD = 0.87962566103423978

_CONV = (nn.Conv2d, nn.Conv3d)
_DECONV = (nn.ConvTranspose2d, nn.ConvTranspose3d)


def kernel_fan_in(module: nn.Module) -> int:
    """flax's fan_in of a conv or deconv module's kernel: kernel volume
    times input channels (a deconvolution's input channels are dim 0 of its
    ``(C_in, C_out, *k)`` weight)."""
    w = module.weight
    channels = w.shape[0] if isinstance(module, _DECONV) else w.shape[1]
    return channels * math.prod(w.shape[2:])


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Fill ``weight`` in place as flax's ``lecun_normal`` does."""
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return weight.mul_(math.sqrt(1.0 / fan_in) / TRUNCATED_STD)


@torch.no_grad()
def init_like_jax(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Re-initialise every conv, deconv and norm layer under ``module`` as
    the JAX package initialises its counterpart, drawing from ``generator``
    (torch's global generator when ``None``).  Returns ``module``."""
    zeroed = set()
    for mod in module.modules():
        if isinstance(mod, DeformConv):
            zeroed |= {mod.p_conv, mod.m_conv}
    for mod in module.modules():
        if isinstance(mod, _CONV + _DECONV):
            if mod in zeroed:
                mod.weight.zero_()
            else:
                lecun_normal_(mod.weight, kernel_fan_in(mod), generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.GroupNorm, nn.BatchNorm3d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm3d):
                mod.reset_running_stats()
    return module
