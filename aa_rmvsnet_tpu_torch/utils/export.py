"""Model export with ``torch.export`` (port of
``aa_rmvsnet_tpu/utils/export.py``, which serialises the jitted forward to
StableHLO; reference statistics.py:26-55 exports the two sub-models to
ONNX).

:func:`export_forward` traces the depth-map forward and
:func:`export_evidential` the evidential head into an ``ExportedProgram``;
:func:`save_exported` and :func:`save_exported_evidential` write one with
``torch.export.save``, and :func:`load_and_call` loads it, puts the given
weights in, and calls it.  The defaults are the JAX package's: the
forward at ``(1, 3, 64, 80, 3)``, D=16, depth block 8, fp32, unpacked,
without the cost volume; the head at ``(1, 32, 64, 80)``, maxdisp 32.

The ConvLSTM gate kernel appears in the forward's graph as the custom op
``aa_rmvsnet_torch::lstm_gates`` (``ops/gates.py``), 5 x D times: the
exported program launches the CUDA kernel on the card and runs the plain
version on the CPU.  The sweep's Python loops unroll, so the graph grows
with D and the view count; it is meant for the small defaults, not for
``dtu_eval``'s D=512.  A program keeps the device it was traced on.
"""

from __future__ import annotations

import io

import torch
from torch import nn

from ..models.evidential import EvidentialHead, evidential_apply
from ..models.network import AARMVSNetCore, SweepConfig, forward
from ..ops import gates  # noqa: F401  (registers the gate ops a program calls)
from .device import disable_tf32, resolve_device


class _Forward(nn.Module):
    """``forward`` of the core as a module: ``(imgs, proj, depths)`` ->
    ``{'depth', 'photometric_confidence'}``."""

    def __init__(self, model: AARMVSNetCore, config: SweepConfig):
        super().__init__()
        self.model = model
        self.config = config

    def forward(self, imgs, proj_matrices, depth_values):
        return forward(self.model, imgs, proj_matrices, depth_values, self.config)


class _Evidential(nn.Module):
    """The eval-mode head on a cost volume, with the softmax over D in fp32
    (:func:`..models.evidential.evidential_apply`): ``(cost_volume,
    depth_values)`` -> ``{'gamma', 'nu', 'alpha', 'beta', 'prob_combine'}``."""

    def __init__(self, head: EvidentialHead):
        super().__init__()
        self.model = head

    def forward(self, cost_volume, depth_values):
        return evidential_apply(self.model, cost_volume, depth_values)


def _export(module: nn.Module, args: tuple) -> tuple[bytes, torch.export.ExportedProgram]:
    with torch.no_grad():
        exported = torch.export.export(module, args)
    buffer = io.BytesIO()
    torch.export.save(exported, buffer)
    return buffer.getvalue(), exported


def export_forward(model: AARMVSNetCore, input_shape=(1, 3, 64, 80, 3), num_depth: int = 16,
                   depth_block: int = 8, device="cuda"):
    """Export the depth-map forward of ``model`` (moved to ``device``, eval
    mode) at ``input_shape`` ``(B, V, H, W, 3)`` and ``num_depth``
    hypotheses, with ``SweepConfig(depth_block, collect_volume=False)``.
    Returns the serialised bytes and the ``ExportedProgram``."""
    dev = resolve_device(device)
    disable_tf32()
    B, V, H, W, C = input_shape
    config = SweepConfig(depth_block=depth_block, collect_volume=False)
    args = (torch.zeros(input_shape, device=dev),
            torch.zeros(B, V, 4, 4, device=dev),
            torch.zeros(B, num_depth, device=dev))
    return _export(_Forward(model.to(dev).eval(), config), args)


def export_evidential(head: EvidentialHead, input_shape=(1, 32, 64, 80), maxdisp: int = 32,
                      device="cuda"):
    """Export the evidential head (moved to ``device``, eval mode) on a
    ``(B, D, H, W)`` cost volume, with the depth-axis softmax folded in, as
    ``run_inference`` applies it.  ``head.maxdisp`` must be
    ``maxdisp``.  Returns the serialised bytes and the ``ExportedProgram``."""
    if head.maxdisp != maxdisp:
        raise ValueError(f"the head's maxdisp is {head.maxdisp}, not {maxdisp}")
    dev = resolve_device(device)
    disable_tf32()
    B, D, H, W = input_shape
    args = (torch.zeros(input_shape, device=dev),
            torch.linspace(400.0, 600.0, D, device=dev)[None].repeat(B, 1))
    return _export(_Evidential(head.to(dev).eval()), args)


def save_exported(path, model: AARMVSNetCore, **kwargs) -> int:
    """:func:`export_forward` written to ``path``; returns its bytes."""
    data, _ = export_forward(model, **kwargs)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def save_exported_evidential(path, head: EvidentialHead, **kwargs) -> int:
    """:func:`export_evidential` written to ``path``; returns its bytes."""
    data, _ = export_evidential(head, **kwargs)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_and_call(path, model: nn.Module, *inputs):
    """Round trip: load the program at ``path``, load ``model``'s weights
    into it (strict: the core for a forward, the head for a head), and call
    it on ``inputs`` (``imgs, proj, depths`` for a forward, ``cost_volume,
    depth_values`` for a head) on the device it was traced on."""
    disable_tf32()
    program = torch.export.load(path).module()
    program.load_state_dict({"model." + k: v for k, v in model.state_dict().items()},
                            strict=True)
    with torch.no_grad():
        return program(*inputs)
