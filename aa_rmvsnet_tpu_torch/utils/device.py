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


def device_ms(step, flush=None, reps: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``step()`` in ms, by CUDA events around it alone.

    ``flush``, a tensor far larger than the card's L2 cache (50 MB on an
    H100), is written before each run so that the inputs come from device
    memory; with ``None`` they stay in the L2 cache from the run before.
    """
    for _ in range(warmup):
        step()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps
