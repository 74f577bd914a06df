"""GroupNorm, with an optional ReLU after it, for inference: the
hand-written CUDA kernel pair and its plain version.

For ``x`` of ``(N, C, *)`` with ``G`` groups, each (sample, group) row's
mean and biased variance in fp32, then ``y = x * a + b`` with ``a = rstd *
weight`` and ``b = bias - mean * a`` in fp32, rounded once to x's dtype,
then the ReLU if asked for: the numerics of aten's GroupNorm.

:func:`group_norm` is the entry point.  On CUDA tensors it launches the
two kernels of ``csrc/group_norm.cu`` (partial moments over many blocks a
row, then the merge of a row's partials and the affine with the ReLU
fused), or raises; on CPU tensors it runs :func:`group_norm_reference`.
The kernels replace no TPU kernel (the JAX package leaves GroupNorm to
XLA): aten's CUDA GroupNorm reduces each row in one block, so a
GroupNorm of few rows runs on a few of the card's SMs.  They have no
backward: ``parallel/spatial.py:group_norm_rows`` launches them only
where no autograd graph is recorded.  ``launches`` counts calls through
the kernel pair, so a run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Calls through the kernel pair since the last reset (CPU calls are not
#: counted).
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Both kernels index inside a (sample, group) row with 32-bit offsets.
_ROW_LIMIT = 2**31
#: A moments block reduces ``chunk`` values of its row: a multiple of
#: ``_CHUNK_UNIT`` (``csrc/group_norm.cu:kChunkUnit``) from one to four
#: units, as many as spread the tensor over at least ~4 blocks an SM.
_CHUNK_UNIT = 8192
_CHUNK_UNITS_MAX = 4
_BLOCKS_PER_SM = 4
_sm_counts: dict[int, int] = {}  # device index -> its SMs
_kernel = None  # the C entry point, bound on first use


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``x`` ``(N, C, *)`` normalised with the ``(N, G)`` statistics
    ``mean`` and ``var`` of its groups: ``x * a + b`` with ``a = rstd *
    weight`` and ``b = bias - mean * a`` in fp32, rounded once to x's
    dtype."""
    N, C = x.shape[:2]
    per_group = C // mean.shape[1]
    rstd = torch.rsqrt(var + eps).repeat_interleave(per_group, dim=1)  # (N, C)
    a = rstd * weight.float()
    b = bias.float() - mean.repeat_interleave(per_group, dim=1) * a
    shape = (N, C) + (1,) * (x.dim() - 2)
    return torch.addcmul(b.view(shape), x.float(), a.view(shape)).to(x.dtype)


def group_norm_reference(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float, relu: bool = False) -> torch.Tensor:
    """Plain version: each row's fp32 mean, then its centred mean square
    (the biased variance), then :func:`normalize`, then the ReLU."""
    rows = x.float().reshape(x.shape[0], num_groups, -1)
    mean = rows.mean(dim=2)
    var = (rows - mean[..., None]).square().mean(dim=2)
    y = normalize(x, mean, var, weight, bias, eps)
    return torch.relu(y) if relu else y


def _refusal(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
             bias: torch.Tensor) -> Exception:
    """The error for arguments the kernels do not take: the first rule
    they break, in the order device, dtype, shape, layout, row.  The
    kernels take ``x`` of ``(N, C, *)`` in fp32 or bf16 on one CUDA device
    (the plain version the same on the CPU) with ``weight`` and ``bias``
    of ``(C,)`` in fp32 or x's dtype, all contiguous, ``num_groups``
    dividing C, and rows of ``C / G * HW`` values under ``_ROW_LIMIT``."""
    tensors = (x, weight, bias)
    if not (all(t.is_cpu for t in tensors)
            or all(t.is_cuda and t.get_device() == x.get_device() for t in tensors)):
        return ValueError(
            f"group_norm: tensors on {sorted({str(t.device) for t in tensors})}; all must "
            "be on one CUDA device (or all on the CPU)")
    if (x.dtype not in _DTYPE_CODES or weight.dtype not in (torch.float32, x.dtype)
            or bias.dtype != weight.dtype):
        return TypeError(
            f"group_norm: x {x.dtype}, weight {weight.dtype}, bias {bias.dtype}; the "
            "kernels take x in float32 or bfloat16, weight and bias alike in float32 or "
            "x's dtype")
    C = x.shape[1] if x.dim() >= 2 else None
    if (C is None or num_groups <= 0 or C % num_groups
            or weight.shape != (C,) or bias.shape != (C,)):
        return ValueError(
            f"group_norm: x {tuple(x.shape)} must be (N, C, *) with C a multiple of "
            f"{num_groups} groups, weight {tuple(weight.shape)} and bias "
            f"{tuple(bias.shape)} of (C,)")
    if not all(t.is_contiguous() for t in tensors):
        return ValueError("group_norm: every tensor must be contiguous")
    return ValueError(
        f"group_norm: rows of {x[0].numel() // num_groups} values (C / G * HW); the "
        f"kernels take fewer than {_ROW_LIMIT}")


def _chunk(total: int, index: int) -> int:
    """The values of its row a moments block reduces, for a tensor of
    ``total`` values on device ``index``."""
    sms = _sm_counts.get(index)
    if sms is None:
        sms = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    units = total // (_BLOCKS_PER_SM * sms * _CHUNK_UNIT)
    return _CHUNK_UNIT * min(_CHUNK_UNITS_MAX, max(1, units))


def _check_launch(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"group_norm: kernel launch failed (cudaError {rc})")


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, relu: bool = False) -> torch.Tensor:
    """GroupNorm of ``x`` ``(N, C, *)`` in ``num_groups`` groups with the
    affine ``weight`` and ``bias``, then ``relu`` if asked for.  Not
    differentiable.

    Arguments the kernels do not take raise, on either device; then CUDA
    tensors launch the kernel pair and CPU tensors take
    :func:`group_norm_reference`.  Returns a tensor shaped and typed like
    ``x``.
    """
    shape, dtype, index = x.shape, x.dtype, x.get_device()
    C = shape[1] if len(shape) >= 2 else 0
    on_cpu = x.is_cpu and weight.is_cpu and bias.is_cpu
    if not ((on_cpu or (x.is_cuda and weight.get_device() == index
                        and bias.get_device() == index))
            and dtype in _DTYPE_CODES and C and num_groups > 0 and C % num_groups == 0
            and weight.dtype in (torch.float32, dtype) and bias.dtype == weight.dtype
            and weight.shape == (C,) and bias.shape == (C,)
            and x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise _refusal(x, num_groups, weight, bias)
    if on_cpu:
        return group_norm_reference(x, num_groups, weight, bias, eps, relu)
    N = shape[0]
    total = x.numel()
    plane = total // (N * C) if N else 0
    if C // num_groups * plane >= _ROW_LIMIT:
        raise _refusal(x, num_groups, weight, bias)
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return group_norm(x, num_groups, weight, bias, eps, relu)
    global _kernel, launches
    if _kernel is None:
        prototype = ctypes.CFUNCTYPE(
            ctypes.c_int, *[ctypes.c_void_p] * 5, *[ctypes.c_longlong] * 5, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
        _kernel = prototype(("group_norm_forward", _build.load("group_norm.cu")))
    chunk = _chunk(total, index)
    parts = -(-(C // num_groups * plane) // chunk)
    partials = torch.empty(N * num_groups * parts * 2, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _check_launch(_kernel(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), partials.data_ptr(),
        N, C, num_groups, plane, chunk, eps, int(relu), _DTYPE_CODES[dtype],
        _DTYPE_CODES[weight.dtype], torch._C._cuda_getCurrentRawStream(index)))
    launches += 1
    return y
