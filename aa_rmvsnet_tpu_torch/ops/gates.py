"""ConvLSTM gate math: the hand-written CUDA kernels and their plain versions.

Once per depth hypothesis and per U-Net cell the regularizer applies, to
the gate-conv output ``z`` split into (i, f, o, g) channel groups and the
previous cell state ``c``:

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

:func:`lstm_gates` is the entry point, differentiable through
:class:`LSTMGates` (the counterpart of the JAX package's ``custom_vjp``
around ``_fused``).  On CUDA tensors the forward launches the kernel in
``csrc/lstm_gates.cu`` (the port of the Pallas kernel
``aa_rmvsnet_tpu/ops/pallas/gates.py:_gate_kernel``) and the backward its
second kernel (the port of ``_gate_bwd_kernel``), or they raise; on CPU
tensors they run :func:`lstm_gates_reference` and
:func:`lstm_gates_backward_reference`.  ``launches`` and
``backward_launches`` count kernel launches so a run can show that its
main path went through the kernels.  ``lstm_gates_backward`` is the
backward kernel's own wrapper, for callers that time or check it alone.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Forward-kernel launches since the last reset (CPU calls are not counted).
launches = 0
#: Backward-kernel launches since the last reset (CPU calls are not counted).
backward_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_kernels: dict = {}  # C entry point name -> ctypes function


def lstm_gates_reference(z: torch.Tensor, c: torch.Tensor):
    """Plain version: split ``z`` (NCHW, ``4*hidden`` channels in the order
    i, f, o, g) and apply the gate chain in fp32, as the kernel does.

    Returns ``(h_next, c_next)`` shaped and typed like ``c``.
    """
    i, f, o, g = torch.chunk(z.float(), 4, dim=1)
    c_next = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_next = torch.sigmoid(o) * torch.tanh(c_next)
    return h_next.to(c.dtype), c_next.to(c.dtype)


def lstm_gates_backward_reference(z: torch.Tensor, c: torch.Tensor,
                                  dh: torch.Tensor, dc_next: torch.Tensor):
    """Plain version of the backward (``gates.py:_gate_bwd_kernel``):
    recompute the activations from ``(z, c)`` and apply the cotangents
    ``dh`` of ``h'`` and ``dc_next`` of ``c'``, in fp32.

    Returns ``(dz, dc)``: ``dz`` in z's layout (gates i, f, o, g at channel
    offsets ``k * hidden``) and dtype, ``dc`` like ``c``.
    """
    i, f, o, g = torch.chunk(z.float(), 4, dim=1)
    i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
    cf = c.float()
    dhf = dh.float()
    tc = torch.tanh(f * cf + i * g)
    dct = dc_next.float() + dhf * o * (1.0 - tc * tc)
    dz = torch.cat([
        dct * g * i * (1.0 - i),
        dct * cf * f * (1.0 - f),
        dhf * tc * o * (1.0 - o),
        dct * i * (1.0 - g * g),
    ], dim=1)
    return dz.to(z.dtype), (dct * f).to(c.dtype)


def _kernel(name: str, n_pointers: int):
    fn = _kernels.get(name)
    if fn is None:
        fn = getattr(_build.load("lstm_gates.cu"), name)
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _kernels[name] = fn
    return fn


def _check(z: torch.Tensor, *cell_shaped: torch.Tensor) -> None:
    """What the kernels take: one CUDA device, one dtype of fp32 or bf16,
    ``z`` of ``(B, 4*hidden, H, W)`` and the others of ``(B, hidden, H, W)``,
    all contiguous."""
    c = cell_shaped[0]
    if z.device.type != "cuda" or any(t.device != z.device for t in cell_shaped):
        raise ValueError(
            "lstm_gates: tensors on "
            f"{sorted({str(t.device) for t in (z, *cell_shaped)})}; all must be "
            "on one CUDA device (or all on the CPU)"
        )
    if z.dtype not in _DTYPE_CODES or any(t.dtype != z.dtype for t in cell_shaped):
        raise TypeError(
            f"lstm_gates: dtypes {[t.dtype for t in (z, *cell_shaped)]}; the "
            "kernels take float32 or bfloat16, the same for every tensor"
        )
    if (
        z.dim() != 4 or c.dim() != 4 or z.shape[0] != c.shape[0]
        or z.shape[1] != 4 * c.shape[1] or z.shape[2:] != c.shape[2:]
        or any(t.shape != c.shape for t in cell_shaped)
    ):
        raise ValueError(
            f"lstm_gates: z {tuple(z.shape)} must be (B, 4*hidden, H, W) for "
            f"c {tuple(c.shape)}, and every cotangent shaped like c"
        )
    if not all(t.is_contiguous() for t in (z, *cell_shaped)):
        raise ValueError("lstm_gates: every tensor must be contiguous")


def _launch(fn, z: torch.Tensor, c: torch.Tensor, pointers) -> None:
    with torch.cuda.device(z.device):
        rc = fn(
            *pointers, c.shape[0], c[0].numel(), _DTYPE_CODES[z.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"lstm_gates: kernel launch failed (cudaError {rc})")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _forward(z: torch.Tensor, c: torch.Tensor):
    if _on_cpu(z, c):
        return lstm_gates_reference(z, c)
    _check(z, c)
    h_next = torch.empty_like(c)
    c_next = torch.empty_like(c)
    _launch(_kernel("lstm_gates_forward", 4), z, c,
            (z.data_ptr(), c.data_ptr(), h_next.data_ptr(), c_next.data_ptr()))
    global launches
    launches += 1
    return h_next, c_next


def lstm_gates_backward(z: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                        dc_next: torch.Tensor):
    """The backward kernel's wrapper: ``(dz, dc)`` from the forward's inputs
    and the cotangents of its outputs, as
    :func:`lstm_gates_backward_reference` gives them.  On CUDA tensors it
    launches the kernel or raises; CPU tensors take the plain version."""
    if _on_cpu(z, c, dh, dc_next):
        return lstm_gates_backward_reference(z, c, dh, dc_next)
    _check(z, c, dh, dc_next)
    dz = torch.empty_like(z)
    dc = torch.empty_like(c)
    _launch(_kernel("lstm_gates_backward", 6), z, c,
            (z.data_ptr(), c.data_ptr(), dh.data_ptr(), dc_next.data_ptr(),
             dz.data_ptr(), dc.data_ptr()))
    global backward_launches
    backward_launches += 1
    return dz, dc


class LSTMGates(torch.autograd.Function):
    """The gate math with the backward of ``_fused_fwd`` / ``_fused_bwd``:
    the forward saves the pre-activation ``z`` and ``c`` (not the
    activations), the backward recomputes the activations from them.

    ``dz`` comes back as one tensor in z's NCHW layout, which the gate
    conv's backward takes as it is.  A cotangent that autograd has none
    for (``dc'`` of the sweep's last depth step) arrives as zeros: the
    Function keeps autograd's default of materialising them.
    """

    @staticmethod
    def forward(ctx, z, c):
        ctx.save_for_backward(z, c)
        return _forward(z, c)

    @staticmethod
    def backward(ctx, dh, dc_next):
        z, c = ctx.saved_tensors
        # A cotangent may be a strided view (a slice of a concat's gradient).
        return lstm_gates_backward(z, c, dh.contiguous(), dc_next.contiguous())


def lstm_gates(z: torch.Tensor, c: torch.Tensor):
    """Fused gate math, differentiable in ``z`` and ``c``.

    Args:
      z: ``(B, 4*hidden, H, W)`` gate-conv output, channels (i, f, o, g).
      c: ``(B, hidden, H, W)`` previous cell state.

    Returns:
      ``(h_next, c_next)``, both shaped and typed like ``c``.  On CUDA the
      math runs in fp32 for fp32 or bf16 storage, forward and backward.
    """
    return LSTMGates.apply(z, c)
