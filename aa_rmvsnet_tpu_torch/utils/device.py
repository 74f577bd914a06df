"""Device selection and fp32 numerics for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; asking for CUDA where there is none raises
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """Keep fp32 convolutions and matmuls in full fp32 on the card.

    cuDNN runs fp32 convolutions in TF32 by default, which keeps about three
    decimal digits; the exact fp32 path (and its parity with the JAX
    package) needs both switches off.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
