"""ConvLSTM gate math: the hand-written CUDA kernel and its plain version.

Once per depth hypothesis and per U-Net cell the regularizer applies, to
the gate-conv output ``z`` split into (i, f, o, g) channel groups and the
previous cell state ``c``:

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

:func:`lstm_gates` is the entry point.  On CUDA tensors it launches the
kernel in ``csrc/lstm_gates.cu`` (the port of the Pallas kernel
``aa_rmvsnet_tpu/ops/pallas/gates.py:_gate_kernel``) or raises; on CPU
tensors it runs :func:`lstm_gates_reference`.  ``launches`` counts kernel
launches so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Kernel launches since the last reset (CPU calls are not counted).
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_forward = None


def lstm_gates_reference(z: torch.Tensor, c: torch.Tensor):
    """Plain version: split ``z`` (NCHW, ``4*hidden`` channels in the order
    i, f, o, g) and apply the gate chain in fp32, as the kernel does.

    Returns ``(h_next, c_next)`` shaped and typed like ``c``.
    """
    i, f, o, g = torch.chunk(z.float(), 4, dim=1)
    c_next = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_next = torch.sigmoid(o) * torch.tanh(c_next)
    return h_next.to(c.dtype), c_next.to(c.dtype)


def _kernel():
    global _forward
    if _forward is None:
        fn = _build.load("lstm_gates.cu").lstm_gates_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _forward = fn
    return _forward


def lstm_gates(z: torch.Tensor, c: torch.Tensor):
    """Fused gate math.

    Args:
      z: ``(B, 4*hidden, H, W)`` gate-conv output, channels (i, f, o, g).
      c: ``(B, hidden, H, W)`` previous cell state.

    Returns:
      ``(h_next, c_next)``, both shaped and typed like ``c``.  On CUDA the
      math runs in fp32 for fp32 or bf16 storage.
    """
    if z.device.type == "cpu" and c.device.type == "cpu":
        return lstm_gates_reference(z, c)
    if z.device.type != "cuda" or c.device != z.device:
        raise ValueError(
            f"lstm_gates: z on {z.device} and c on {c.device}; both must be "
            "on one CUDA device (or both on the CPU)"
        )
    if z.dtype != c.dtype or z.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"lstm_gates: dtypes {z.dtype}/{c.dtype}; the kernel takes "
            "float32 or bfloat16, the same for z and c"
        )
    if (
        z.dim() != 4 or c.dim() != 4 or z.shape[0] != c.shape[0]
        or z.shape[1] != 4 * c.shape[1] or z.shape[2:] != c.shape[2:]
    ):
        raise ValueError(
            f"lstm_gates: z {tuple(z.shape)} must be (B, 4*hidden, H, W) for "
            f"c {tuple(c.shape)}"
        )
    if not (z.is_contiguous() and c.is_contiguous()):
        raise ValueError("lstm_gates: z and c must be contiguous")
    if z.requires_grad or c.requires_grad:
        raise NotImplementedError(
            "lstm_gates: the backward kernel is not ported yet; call it under "
            "torch.inference_mode() or torch.no_grad()"
        )
    fn = _kernel()
    h_next = torch.empty_like(c)
    c_next = torch.empty_like(c)
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), c.data_ptr(), h_next.data_ptr(), c_next.data_ptr(),
            c.shape[0], c[0].numel(), _DTYPE_CODES[z.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"lstm_gates: kernel launch failed (cudaError {rc})")
    global launches
    launches += 1
    return h_next, c_next
