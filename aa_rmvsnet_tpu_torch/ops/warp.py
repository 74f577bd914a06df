"""The sweep's unpacked warp with its squared residual, for inference: the
hand-written CUDA kernel and its plain version.

For one source view's NHWC features ``src`` ``(B, Hs, Ws, C)``, a block's
fp32 coordinates ``x, y`` ``(B, Db, H*W)`` (``ops/homography.py:
plane_sweep_xy``) and the reference features ``ref`` ``(B, H, W, C)``,
the squared residual ``(bilinear(src, x, y) - ref) ** 2`` as ``(B, Db, H,
W, C)`` in src's dtype, rounded as the composition it replaces rounds it
(``ops/patch_sample.py:patch_bilinear_sample`` on the 2x2 table of ``src``,
then ``(warped - ref) ** 2``):

- ``xb = clamp(floor(x), 0, Ws - 1)``, likewise ``yb``; the texels ``(yb,
  xb)``, ``(yb, xb + 1)``, ``(yb + 1, xb)``, ``(yb + 1, xb + 1)``, zero past
  the last row or column (the table's zero padding);
- the tents ``max(0, 1 - |d|)`` and their four products in fp32, each
  product rounded to the dtype;
- each tap's ``texel * weight`` rounded to the dtype (aten's ``mul``), the
  four summed in fp32 in that order and rounded once (aten's ``sum``);
- the difference and its square, each rounded to the dtype.

:func:`warp_residual` is the entry point.  On CUDA tensors it launches the
kernel of ``csrc/warp_residual.cu``, which reads the feature map itself
where the composition gathered whole 2x2 table rows; on CPU tensors it
runs :func:`warp_residual_reference`.  It has no backward:
``models/network.py:_takes_warp_kernel`` sends it only sweeps that record
no autograd graph.  ``launches`` counts calls through the kernel, so a run
can show that its main path went through it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .patch_sample import _tent

#: Calls through the kernel since the last reset (CPU calls are not
#: counted).
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_kernel = None  # the C entry point, bound on first use


def warp_residual_reference(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                            ref: torch.Tensor) -> torch.Tensor:
    """Plain version: the four texels gathered from ``src`` with one zero
    row and column past its end, blended and squared in the kernel's
    order of roundings."""
    B, Hs, Ws, C = src.shape
    _, Db, P = x.shape
    dtype = src.dtype
    xb = torch.clamp(torch.floor(x), 0, Ws - 1)
    yb = torch.clamp(torch.floor(y), 0, Hs - 1)
    padded = F.pad(src, (0, 0, 0, 1, 0, 1)).reshape(B, (Hs + 1) * (Ws + 1), C)
    first = (yb.long() * (Ws + 1) + xb.long()).reshape(B, Db * P, 1)
    tx0, tx1 = _tent(x - xb), _tent(x - (xb + 1.0))
    ty0, ty1 = _tent(y - yb), _tent(y - (yb + 1.0))
    acc = None
    for offset, w in ((0, ty0 * tx0), (1, ty0 * tx1), (Ws + 1, ty1 * tx0), (Ws + 2, ty1 * tx1)):
        texels = torch.gather(padded, 1, (first + offset).expand(B, Db * P, C))
        tap = texels * w.to(dtype).reshape(B, Db * P, 1)
        acc = tap.float() if acc is None else acc + tap
    warped = acc.to(dtype).view(B, Db, *ref.shape[1:])
    return (warped - ref[:, None]) ** 2


def _refusal(src, x, y, ref) -> Exception:
    """The error for arguments the kernel does not take: the first rule
    they break, in the order device, dtype, layout, shape.  It takes
    ``src`` ``(B, Hs, Ws, C)`` and ``ref`` ``(B, H, W, C)`` in fp32 or bf16
    alike, ``x`` and ``y`` ``(B, Db, H * W)`` in fp32, all contiguous on one
    CUDA device (the plain version the same on the CPU)."""
    tensors = (src, x, y, ref)
    if not (all(t.is_cpu for t in tensors)
            or all(t.is_cuda and t.get_device() == src.get_device() for t in tensors)):
        return ValueError(
            f"warp_residual: tensors on {sorted({str(t.device) for t in tensors})}; all "
            "must be on one CUDA device (or all on the CPU)")
    if src.dtype not in _DTYPE_CODES or ref.dtype != src.dtype or x.dtype != torch.float32 \
            or y.dtype != torch.float32:
        return TypeError(
            f"warp_residual: src {src.dtype}, ref {ref.dtype}, x {x.dtype}, y {y.dtype}; the "
            "kernel takes src and ref alike in float32 or bfloat16, x and y in float32")
    if not all(t.is_contiguous() for t in tensors):
        return ValueError("warp_residual: every tensor must be contiguous")
    return ValueError(
        f"warp_residual: src {tuple(src.shape)}, x {tuple(x.shape)}, y {tuple(y.shape)}, "
        f"ref {tuple(ref.shape)}; the kernel takes src (B, Hs, Ws, C), ref (B, H, W, C) "
        "and x, y (B, Db, H * W)")


def _check_launch(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"warp_residual: kernel launch failed (cudaError {rc})")


def warp_residual(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  ref: torch.Tensor) -> torch.Tensor:
    """The squared residual of ``src`` warped to ``x, y`` against ``ref``,
    ``(B, Db, H, W, C)`` in src's dtype.  Not differentiable.

    Arguments the kernel does not take raise, on either device; then CUDA
    tensors launch the kernel and CPU tensors take
    :func:`warp_residual_reference`.
    """
    tensors = (src, x, y, ref)
    same_place = all(t.is_cpu for t in tensors) or all(
        t.is_cuda and t.get_device() == src.get_device() for t in tensors)
    if not (same_place and src.dim() == 4 and ref.dim() == 4 and x.dim() == 3
            and src.dtype in _DTYPE_CODES and ref.dtype == src.dtype
            and x.dtype == torch.float32 and y.dtype == torch.float32
            and x.shape == y.shape and ref.shape[0] == src.shape[0] == x.shape[0]
            and ref.shape[3] == src.shape[3] and x.shape[2] == ref.shape[1] * ref.shape[2]
            and all(t.is_contiguous() for t in tensors)):
        raise _refusal(src, x, y, ref)
    if src.is_cpu:
        return warp_residual_reference(src, x, y, ref)
    index = src.get_device()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return warp_residual(src, x, y, ref)
    global _kernel, launches
    if _kernel is None:
        prototype = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_void_p] * 5,
                                     *[ctypes.c_longlong] * 6, ctypes.c_int, ctypes.c_void_p)
        _kernel = prototype(("warp_residual_forward", _build.load("warp_residual.cu")))
    B, Hs, Ws, C = src.shape
    Db = x.shape[1]
    out = torch.empty((B, Db, *ref.shape[1:]), dtype=src.dtype, device=src.device)
    _check_launch(_kernel(
        src.data_ptr(), x.data_ptr(), y.data_ptr(), ref.data_ptr(), out.data_ptr(),
        B, Db, x.shape[2], Hs, Ws, C, _DTYPE_CODES[src.dtype],
        torch._C._cuda_getCurrentRawStream(index)))
    launches += 1
    return out
