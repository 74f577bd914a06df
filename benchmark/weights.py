"""Seeded weights of the core and the head, made on the device.

He-normal convolution kernels (std ``sqrt(2 / fan_in)``, a transposed
kernel's fan-in taken over its input channels); the deformable
convolutions' offset and modulation kernels at std 0.1, so that the
deformable taps move.  Every normalisation's scale is N(1, 0.1^2), and
every normalisation's shift and every convolution's bias N(0, 0.1^2); the
head's BatchNorm running means N(0, 0.1^2) and running variances U(0.5,
1.5): so that every term does work, and a path that drops one reads
otherwise than the reference.
PyTorch's default init leaves a pixel's regularized costs nearly equal
across depth; He init spreads them as a trained network's are spread.

All values come from one generator on ``device`` seeded with the run's
seed, in two large draws (a normal and a uniform), in the order of the
reference's parameter list.  Both sides get the same tensors: the
reference reads the dict, the program loads it as its ``state_dict``.
"""

from __future__ import annotations

import math

import torch

from .reference import aa_rmvsnet, evidential


#: Key parts of the transposed convolutions, whose kernels are (in, out, ...).
TRANSPOSED = (".deconv_", ".conv5.", ".conv6.", ".conv8.", ".conv9.")


def _fan_in(name: str, shape: tuple) -> int:
    transposed = any(part in name for part in TRANSPOSED)
    return (shape[0] if transposed else shape[1]) * math.prod(shape[2:])


def _draw(shapes: list, gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    total = sum(math.prod(s) for _, s in shapes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    return normal, uniform


def core_weights(seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = aa_rmvsnet.parameter_shapes()
    normal, _ = _draw(shapes, gen, device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        z = normal[at:at + n].view(shape)
        at += n
        if len(shape) == 4:
            std = 0.1 if name.endswith(("p_conv.weight", "m_conv.weight")) \
                else math.sqrt(2.0 / _fan_in(name, shape))
            out[name] = (std * z).contiguous()
        elif name.endswith(".weight"):  # a GroupNorm scale
            out[name] = 1.0 + 0.1 * z
        else:  # a GroupNorm shift or a convolution bias
            out[name] = 0.1 * z
    return out


def head_weights(seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    shapes = evidential.parameter_shapes()
    normal, uniform = _draw(shapes, gen, device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        z = normal[at:at + n].view(shape)
        u = uniform[at:at + n].view(shape)
        at += n
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        elif len(shape) == 5:
            out[name] = (math.sqrt(2.0 / _fan_in(name, shape)) * z).contiguous()
        elif name.endswith(".weight"):
            out[name] = 1.0 + 0.1 * z
        elif name.endswith((".bias", ".running_mean")):
            out[name] = 0.1 * z
        else:  # running_var
            out[name] = 0.5 + u
    return out
