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
main path went through the kernels (``bf16_launches`` and
``bf16_backward_launches`` those of the bf16 instantiations; a bf16
training step is the path that launches the bf16 backward).
``lstm_gates_backward`` is the backward kernel's own wrapper, for callers
that time or check it alone.
Where there is no graph to record (inference), the forward skips the
``Function``, whose host cost is a large share of a small cell's call.

Both directions are also registered as ``torch.library`` custom ops,
``torch.ops.aa_rmvsnet_torch.lstm_gates`` and ``lstm_gates_backward``, with
fake implementations and the forward's autograd formula, so that
``torch.export`` and ``torch.compile`` keep the kernel as one node of their
graph (tracing cannot follow a ctypes launch on ``data_ptr()``).  Their
CPU implementations are the plain versions, their CUDA ones the launches
above.  :func:`lstm_gates` goes through the op only while it is traced:
the dispatcher's host cost would add to every eager call.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Forward-kernel launches since the last reset (CPU calls are not counted).
launches = 0
#: Backward-kernel launches since the last reset (CPU calls are not counted).
backward_launches = 0
#: The launches of each kernel's bf16 instantiation among those above.
bf16_launches = 0
bf16_backward_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Both kernels index inside a plane (hidden * H * W) with 32-bit offsets.
_PLANE_LIMIT = 2**31
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
    """The C entry point ``name`` as a ctypes prototype call, which costs the
    host less per call than a function with ``argtypes``."""
    fn = _kernels.get(name)
    if fn is None:
        prototype = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_void_p] * n_pointers,
                                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p)
        fn = prototype((name, _build.load("lstm_gates.cu")))
        _kernels[name] = fn
    return fn


def _refusal(z: torch.Tensor, *cell_shaped: torch.Tensor) -> Exception:
    """The error for arguments the kernels do not take: the first rule they
    break, in the order device, dtype, shape, layout, plane.  The kernels
    take one CUDA device, one dtype of fp32 or bf16, ``z`` of ``(B,
    4*hidden, H, W)`` and the others of ``(B, hidden, H, W)``, all
    contiguous, and a plane ``hidden * H * W`` under ``_PLANE_LIMIT``."""
    tensors = (z, *cell_shaped)
    index = z.get_device()
    if not all(t.is_cuda and t.get_device() == index for t in tensors):
        return ValueError(
            "lstm_gates: tensors on "
            f"{sorted({str(t.device) for t in tensors})}; all must be "
            "on one CUDA device (or all on the CPU)"
        )
    dtype = z.dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in cell_shaped):
        return TypeError(
            f"lstm_gates: dtypes {[t.dtype for t in tensors]}; the "
            "kernels take float32 or bfloat16, the same for every tensor"
        )
    zs, cs = z.shape, cell_shaped[0].shape
    if (
        len(zs) != 4 or len(cs) != 4 or zs[0] != cs[0] or zs[1] != 4 * cs[1]
        or zs[2:] != cs[2:] or any(t.shape != cs for t in cell_shaped)
    ):
        return ValueError(
            f"lstm_gates: z {tuple(zs)} must be (B, 4*hidden, H, W) for "
            f"c {tuple(cs)}, and every cotangent shaped like c"
        )
    if not all(t.is_contiguous() for t in tensors):
        return ValueError("lstm_gates: every tensor must be contiguous")
    return ValueError(
        f"lstm_gates: a plane of {cs[1] * cs[2] * cs[3]} elements (hidden * H * W); "
        f"the kernels take fewer than {_PLANE_LIMIT}"
    )


def _check_launch(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"lstm_gates: kernel launch failed (cudaError {rc})")


# The wrappers below run ~5,000 times a map and ~2,000 times a training
# step, so the case the kernels take reads each tensor attribute once, in
# one condition; ``_refusal`` explains the others.  A launch goes to the
# current stream of the tensors' device, entered only when it is not
# already current (as the CUDA runtime reports it), with the stream read as
# the raw handle (as Triton's launcher does), not as a ``Stream``.

def _forward(z: torch.Tensor, c: torch.Tensor):
    if not z.is_cuda:
        if z.is_cpu and c.is_cpu:
            return lstm_gates_reference(z, c)
        raise _refusal(z, c)
    cs, dtype, index = c.shape, z.dtype, z.get_device()
    if not (c.is_cuda and c.get_device() == index and dtype in _DTYPE_CODES
            and c.dtype == dtype and len(cs) == 4
            and z.shape == (cs[0], 4 * cs[1], cs[2], cs[3])
            and z.is_contiguous() and c.is_contiguous()
            and cs[1] * cs[2] * cs[3] < _PLANE_LIMIT):
        raise _refusal(z, c)
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return _forward(z, c)
    h_next = torch.empty_like(c)
    c_next = torch.empty_like(c)
    _check_launch(_kernel("lstm_gates_forward", 4)(
        z.data_ptr(), c.data_ptr(), h_next.data_ptr(), c_next.data_ptr(), cs[0],
        cs[1] * cs[2] * cs[3], _DTYPE_CODES[dtype], torch._C._cuda_getCurrentRawStream(index)))
    global launches, bf16_launches
    launches += 1
    bf16_launches += dtype == torch.bfloat16
    return h_next, c_next


def lstm_gates_backward(z: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                        dc_next: torch.Tensor):
    """The backward kernel's wrapper: ``(dz, dc)`` from the forward's inputs
    and the cotangents of its outputs, as
    :func:`lstm_gates_backward_reference` gives them.  On CUDA tensors it
    launches the kernel or raises; CPU tensors take the plain version."""
    if not z.is_cuda:
        if z.is_cpu and c.is_cpu and dh.is_cpu and dc_next.is_cpu:
            return lstm_gates_backward_reference(z, c, dh, dc_next)
        raise _refusal(z, c, dh, dc_next)
    cs, dtype, index = c.shape, z.dtype, z.get_device()
    if not (dtype in _DTYPE_CODES and len(cs) == 4
            and z.shape == (cs[0], 4 * cs[1], cs[2], cs[3]) and z.is_contiguous()
            and cs[1] * cs[2] * cs[3] < _PLANE_LIMIT
            and all(t.is_cuda and t.get_device() == index and t.dtype == dtype
                    and t.shape == cs and t.is_contiguous() for t in (c, dh, dc_next))):
        raise _refusal(z, c, dh, dc_next)
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return lstm_gates_backward(z, c, dh, dc_next)
    dz = torch.empty_like(z)
    dc = torch.empty_like(c)
    _check_launch(_kernel("lstm_gates_backward", 6)(
        z.data_ptr(), c.data_ptr(), dh.data_ptr(), dc_next.data_ptr(), dz.data_ptr(),
        dc.data_ptr(), cs[0], cs[1] * cs[2] * cs[3], _DTYPE_CODES[dtype],
        torch._C._cuda_getCurrentRawStream(index)))
    global backward_launches, bf16_backward_launches
    backward_launches += 1
    bf16_backward_launches += dtype == torch.bfloat16
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


@torch.library.custom_op("aa_rmvsnet_torch::lstm_gates", mutates_args=(), device_types="cpu")
def lstm_gates_op(z: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gate forward as a custom op: the plain version on the CPU, the
    kernel on CUDA (registered below)."""
    return lstm_gates_reference(z, c)


@torch.library.custom_op("aa_rmvsnet_torch::lstm_gates_backward", mutates_args=(),
                         device_types="cpu")
def lstm_gates_backward_op(z: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
                           dc_next: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gate backward as a custom op, as :func:`lstm_gates_op`."""
    return lstm_gates_backward_reference(z, c, dh, dc_next)


lstm_gates_op.register_kernel("cuda")(_forward)
lstm_gates_backward_op.register_kernel("cuda")(lstm_gates_backward)


@lstm_gates_op.register_fake
def _(z, c):
    if z.dim() != 4 or c.dim() != 4 or z.shape[1] != 4 * c.shape[1] or z.dtype != c.dtype:
        raise ValueError(f"lstm_gates: z {tuple(z.shape)} {z.dtype} must be "
                         f"(B, 4*hidden, H, W) for c {tuple(c.shape)} {c.dtype}")
    return torch.empty_like(c), torch.empty_like(c)


@lstm_gates_backward_op.register_fake
def _(z, c, dh, dc_next):
    return torch.empty_like(z), torch.empty_like(c)


def _save_gate_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _gate_op_backward(ctx, dh, dc_next):
    # As LSTMGates: the activations are recomputed from (z, c), and a
    # missing cotangent is zeros.
    z, c = ctx.saved_tensors
    dh = torch.zeros_like(c) if dh is None else dh.contiguous()
    dc_next = torch.zeros_like(c) if dc_next is None else dc_next.contiguous()
    return lstm_gates_backward_op(z, c, dh, dc_next)


lstm_gates_op.register_autograd(_gate_op_backward, setup_context=_save_gate_inputs)


def lstm_gates(z: torch.Tensor, c: torch.Tensor):
    """Fused gate math, differentiable in ``z`` and ``c``.

    Args:
      z: ``(B, 4*hidden, H, W)`` gate-conv output, channels (i, f, o, g).
      c: ``(B, hidden, H, W)`` previous cell state.

    Returns:
      ``(h_next, c_next)``, both shaped and typed like ``c``.  On CUDA the
      math runs in fp32 for fp32 or bf16 storage, forward and backward.
    """
    if torch.compiler.is_compiling():  # torch.export or torch.compile
        return lstm_gates_op(z, c)
    if torch.is_grad_enabled() and (z.requires_grad or c.requires_grad):
        return LSTMGates.apply(z, c)
    return _forward(z, c)  # no graph to record: skip the Function's host cost
