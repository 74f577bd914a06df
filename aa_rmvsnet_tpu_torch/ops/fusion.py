"""The reproject-and-vote of depth-map fusion: the hand-written CUDA kernel
and its plain version.

For one reference view and its source views, per reference pixel: back-
project with the reference depth, project into each source, sample the
source depth bilinearly with a zero border, project back, and count the
sources whose reprojection lies within ``i / dist_base`` px and
``i / rel_base`` relative depth, for each level i in ``[2, 2 +
num_levels)``; at the loosest level also count them and sum their
reprojected depths (float32).  This is what the JAX package's C++ core
computes one pair at a time (``native/fusion_core.cpp:fuse_pair``, bound
by ``aa_rmvsnet_tpu/pipeline/native.py:fuse_pair_native``), with its
float64 projections.

:func:`fuse_ref` is the entry point.  On CUDA tensors it launches the
kernel in ``csrc/fusion_core.cu`` (one launch per reference view) or
raises; on CPU tensors it runs :func:`fuse_ref_reference`, which writes
the same arithmetic out as elementwise torch ops in the C++ core's order:
each matrix-vector product as ``m0*v0 + m1*v1 + m2*v2``, never ``@``, and
no division by a Python scalar (torch's CUDA kernels multiply by its
reciprocal).  The two are equal bit for bit on the same inputs, on the
CPU and on the card.  ``launches`` counts kernel launches.

The kernel tests the levels in an exact rewrite whose constants
:func:`kernel_levels` builds on the host: the squared distance against
:func:`dist_sq_threshold` of each distance threshold (no square root),
and no level at all where the relative difference misses the loosest
relative threshold.  :func:`check_kernel_inputs` holds the arguments to
what the kernel takes, on any device.  Its quotients share a divisor's
reciprocal; :func:`kernel_quotients` runs that division alone, to hold it
to IEEE division.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

#: Kernel launches since the last reset (CPU calls are not counted).
launches = 0

#: Largest ``num_levels`` (the kernel's template parameter, 1 to 16).
MAX_LEVELS = 16
#: Largest source count whose matrices the kernel stages in a block's
#: shared memory (60 float64 each: 48,960 bytes).
MAX_SOURCES = 102
#: float64 values per source in ``mats``: kinv_ref, k_src, kinv_src, k_ref
#: (3x3), rt_ref2src, rt_src2ref (3x4), row-major.
MAT_STRIDE = 60
#: float64 operations by the FLOP convention (an operation each, a division
#: one) that the function needs per reference pixel: the pixel times its
#: depth (2); per distinct kinv_ref, that matrix times the pixel (15); and
#: per pixel and source two rigid transforms (2 x 18), three 3x3 products
#: (3 x 15), the four projective divisions (xs, ys, xr, yr), the source
#: pixel times its depth (2), the squared distance (5: two differences, two
#: squares, their sum; no square root, as :func:`dist_sq_threshold` compares
#: the square) and the relative difference (2: the depth difference and the
#: quotient, the fifth division).  :func:`fp64_operations` sums them; the
#: kernel's bound counts them.
FP64_OPS_PER_PIXEL = 2
FP64_OPS_PER_REFERENCE_RAY = 15
FP64_OPS_PER_PIXEL_SOURCE = 2 * 18 + 3 * 15 + 4 + 2 + 5 + 2

_kernel_fn = None


def pair_matrices(K_ref: np.ndarray, E_ref: np.ndarray, K_src: np.ndarray,
                  E_src: np.ndarray) -> np.ndarray:
    """The ``(60,)`` float64 matrices of one (reference, source) pair, made
    on the host as ``pipeline/native.py:fuse_pair_native`` makes them: the
    inverses of the intrinsics in their own dtype (float32 as read from a
    cam file), the camera-to-camera transforms in float64."""
    E_ref64 = E_ref.astype(np.float64)
    E_src64 = E_src.astype(np.float64)
    return np.concatenate([
        np.asarray(np.linalg.inv(K_ref), np.float64).reshape(-1),
        np.asarray(K_src, np.float64).reshape(-1),
        np.asarray(np.linalg.inv(K_src), np.float64).reshape(-1),
        np.asarray(K_ref, np.float64).reshape(-1),
        (E_src64 @ np.linalg.inv(E_ref64))[:3].reshape(-1),
        (E_ref64 @ np.linalg.inv(E_src64))[:3].reshape(-1),
    ])


def fp64_operations(pixels: int, mats: np.ndarray) -> int:
    """float64 operations by the FLOP convention of one reference view of
    ``pixels`` pixels against the sources of ``mats`` (``(S, 60)``,
    :func:`pair_matrices`): the counts above, the reference ray once for
    each distinct kinv_ref (compared bit for bit)."""
    mats = np.ascontiguousarray(mats, np.float64).reshape(-1, MAT_STRIDE)
    rays = len(np.unique(mats[:, :9].view(np.int64), axis=0))
    return pixels * (FP64_OPS_PER_PIXEL + rays * FP64_OPS_PER_REFERENCE_RAY
                     + len(mats) * FP64_OPS_PER_PIXEL_SOURCE)


def _mul_vec(m, v):
    return tuple(m[3 * r] * v[0] + m[3 * r + 1] * v[1] + m[3 * r + 2] * v[2]
                 for r in range(3))


def _transform(m, v):
    return tuple(m[4 * r] * v[0] + m[4 * r + 1] * v[1] + m[4 * r + 2] * v[2] + m[4 * r + 3]
                 for r in range(3))


def _bilinear_zero(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 bilinear samples of ``img`` (h, w) at ``(x, y)`` with a zero
    border, the four taps summed in the C++ core's order; a tap counts
    where ``floor + {0, 1}`` lies in the image (never for NaN)."""
    h, w = img.shape
    flat = img.reshape(-1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    acc = torch.zeros_like(x)
    for dy in (0, 1):
        yy = y0 + dy
        wy = fy if dy else 1.0 - fy
        for dx in (0, 1):
            xx = x0 + dx
            wx = fx if dx else 1.0 - fx
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (torch.where(valid, yy, 0.0).long() * w + torch.where(valid, xx, 0.0).long())
            acc = acc + torch.where(valid, (wy * wx) * flat[idx], 0.0)
    return acc


def pair_terms(ref_depth: torch.Tensor, src_depth: torch.Tensor, mats):
    """The reprojection of one pair, in float64 elementwise torch ops in the
    C++ core's order.

    Args:
      ref_depth, src_depth: ``(h, w)`` float32.
      mats: the pair's 60 matrix entries (:func:`pair_matrices`) as Python
        floats.

    Returns:
      ``(dist, rel, depth_reproj, x_reproj, y_reproj)``, ``(h, w)``
      float64 each: the reprojected pixel's distance from its reference
      pixel, the relative depth difference (inf where the reference depth
      is 0), the reprojected depth and the reprojected pixel.
    """
    h, w = ref_depth.shape
    dev = ref_depth.device
    d = ref_depth.double()
    xg = torch.arange(w, dtype=torch.float64, device=dev)[None, :].expand(h, w)
    yg = torch.arange(h, dtype=torch.float64, device=dev)[:, None].expand(h, w)
    kinv_ref, k_src, kinv_src, k_ref = mats[0:9], mats[9:18], mats[18:27], mats[27:36]
    ref2src, src2ref = mats[36:48], mats[48:60]

    cam_src = _transform(ref2src, _mul_vec(kinv_ref, (xg * d, yg * d, d)))
    k_xyz = _mul_vec(k_src, cam_src)
    xs, ys = k_xyz[0] / k_xyz[2], k_xyz[1] / k_xyz[2]
    ds = _bilinear_zero(src_depth, xs.float(), ys.float()).double()
    cam_ref2 = _transform(src2ref, _mul_vec(kinv_src, (xs * ds, ys * ds, ds)))
    k_xyz2 = _mul_vec(k_ref, cam_ref2)
    xr, yr = k_xyz2[0] / k_xyz2[2], k_xyz2[1] / k_xyz2[2]
    dist = torch.sqrt((xr - xg) * (xr - xg) + (yr - yg) * (yr - yg))
    rel = torch.where(d != 0, (cam_ref2[2] - d).abs() / d, torch.inf)
    return dist, rel, cam_ref2[2], xr, yr


def level_thresholds(num_levels: int, dist_base: float, rel_base: float):
    """``[(i / dist_base, i / rel_base)]`` for i in ``[2, 2 + num_levels)``."""
    return [(i / dist_base, i / rel_base) for i in range(2, 2 + num_levels)]


def dist_sq_threshold(t: float) -> float:
    """S(t): the least float64 whose correctly rounded square root reaches
    ``t``, so that ``sqrt(s) < t`` exactly where ``s < S(t)`` for every
    float64 ``s >= 0`` and for NaN (``sqrt`` is monotone).  0 where ``t <= 0``
    or NaN (no ``s`` passes), inf where ``t`` is inf."""
    t = float(t)
    if not t > 0.0:
        return 0.0
    with np.errstate(over="ignore"):
        s = np.float64(t) * np.float64(t)
    zero, inf = np.float64(0.0), np.float64(np.inf)
    while s > 0.0 and np.sqrt(np.nextafter(s, zero)) >= t:
        s = np.nextafter(s, zero)
    while np.sqrt(s) < t:
        s = np.nextafter(s, inf)
    return float(s)


class KernelLevels(ctypes.Structure):
    """The kernel's ``FuseLevels`` (``csrc/fusion_core.cu``): per level the
    squared distance threshold and the relative one, and the loosest
    relative threshold."""

    _fields_ = [
        ("num_levels", ctypes.c_int),
        ("dist_sq", ctypes.c_double * MAX_LEVELS),
        ("rel", ctypes.c_double * MAX_LEVELS),
        ("rel_max", ctypes.c_double),
    ]


@functools.lru_cache(maxsize=64)
def kernel_levels(num_levels: int, dist_base: float, rel_base: float) -> KernelLevels:
    """The thresholds of :func:`level_thresholds` as the kernel tests them:
    S(i / dist_base) (:func:`dist_sq_threshold`) and i / rel_base, and the
    largest relative threshold (-inf where all are NaN: no value passes a
    NaN threshold, and none can pass any level).  Entries past
    ``num_levels`` are 0 and unread."""
    pairs = level_thresholds(num_levels, dist_base, rel_base)
    rel = [rt for _, rt in pairs]
    levels = KernelLevels(num_levels=num_levels,
                          rel_max=max((r for r in rel if not math.isnan(r)), default=-math.inf))
    levels.dist_sq[:num_levels] = [dist_sq_threshold(dt) for dt, _ in pairs]
    levels.rel[:num_levels] = rel
    return levels


def fuse_ref_reference(depths: torch.Tensor, ref: int, src_index: torch.Tensor,
                       mats: torch.Tensor, num_levels: int = 9, dist_base: float = 4.0,
                       rel_base: float = 1300.0):
    """Plain version of the kernel: :func:`pair_terms` per source, in order.
    Arguments and results as :func:`fuse_ref`."""
    ref_depth = depths[ref]
    h, w = ref_depth.shape
    dev = depths.device
    counts = torch.zeros(num_levels, h, w, dtype=torch.int32, device=dev)
    loose = torch.zeros(h, w, dtype=torch.int32, device=dev)
    reproj_sum = torch.zeros(h, w, dtype=torch.float32, device=dev)
    thresholds = level_thresholds(num_levels, dist_base, rel_base)
    for s, m in zip(src_index.tolist(), mats.cpu().tolist()):
        dist, rel, depth_reproj, _, _ = pair_terms(ref_depth, depths[s], m)
        passed = torch.stack([(dist < dt) & (rel < rt) for dt, rt in thresholds])
        counts += passed
        loose += passed[-1]
        reproj_sum = reproj_sum + torch.where(passed[-1], depth_reproj.float(), 0.0)
    return counts, loose, reproj_sum


def check_kernel_inputs(depths: torch.Tensor, ref: int, src_index: torch.Tensor,
                        mats: torch.Tensor, num_levels: int = 9) -> None:
    """Raise where the kernel cannot take these arguments (their device
    aside): ``depths`` ``(views, h, w)`` float32, ``src_index`` ``(S,)``
    int32 with ``S <= MAX_SOURCES``, ``mats`` ``(S, 60)`` float64 row-major
    as its blocks stage them, all contiguous, ``ref`` a view and
    ``num_levels`` in ``[1, MAX_LEVELS]``."""
    tensors = (depths, src_index, mats)
    if depths.dtype != torch.float32 or src_index.dtype != torch.int32 \
            or mats.dtype != torch.float64:
        raise TypeError(f"fuse_ref: dtypes {[t.dtype for t in tensors]}; the kernel takes "
                        "float32 depths, int32 source indices and float64 matrices")
    S = src_index.shape[0] if src_index.dim() == 1 else -1
    if depths.dim() != 3 or src_index.dim() != 1 or tuple(mats.shape) != (S, MAT_STRIDE):
        raise ValueError(f"fuse_ref: depths {tuple(depths.shape)} must be (views, h, w), "
                         f"src_index {tuple(src_index.shape)} (S,) and mats "
                         f"{tuple(mats.shape)} (S, {MAT_STRIDE})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fuse_ref: every tensor must be contiguous")
    if not 0 <= ref < depths.shape[0]:
        raise ValueError(f"fuse_ref: reference view {ref} of {depths.shape[0]}")
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"fuse_ref: num_levels {num_levels} outside [1, {MAX_LEVELS}]")
    if S > MAX_SOURCES:
        raise ValueError(f"fuse_ref: {S} sources; the kernel takes at most {MAX_SOURCES}")


def fuse_ref(depths: torch.Tensor, ref: int, src_index: torch.Tensor, mats: torch.Tensor,
             num_levels: int = 9, dist_base: float = 4.0, rel_base: float = 1300.0):
    """Reproject-and-vote of reference view ``ref`` against its sources.

    Args:
      depths: ``(views, h, w)`` float32 depth maps; ``depths[ref]`` is the
        reference, and the sources share its size.
      src_index: ``(S,)`` int32 indices into ``depths``, in the order the
        sums run.
      mats: ``(S, 60)`` float64, per source :func:`pair_matrices`.
      num_levels, dist_base, rel_base: levels i in ``[2, 2 + num_levels)``
        pass where the distance is below ``i / dist_base`` px and the
        relative depth difference below ``i / rel_base``.

    Returns:
      ``(level_counts, loose, reproj_sum)``: ``(num_levels, h, w)`` int32
      passing sources per level, ``(h, w)`` int32 of them at the loosest
      level, and ``(h, w)`` float32 the sum of their reprojected depths.
    """
    tensors = (depths, src_index, mats)
    if all(t.is_cpu for t in tensors):
        return fuse_ref_reference(depths, ref, src_index, mats, num_levels, dist_base,
                                  rel_base)
    index = depths.get_device()
    if not all(t.is_cuda and t.get_device() == index for t in tensors):
        raise ValueError(f"fuse_ref: tensors on {sorted({str(t.device) for t in tensors})}; "
                         "all must be on one CUDA device (or all on the CPU)")
    check_kernel_inputs(depths, ref, src_index, mats, num_levels)
    levels = kernel_levels(num_levels, float(dist_base), float(rel_base))
    _, h, w = depths.shape
    counts = torch.empty(num_levels, h, w, dtype=torch.int32, device=depths.device)
    loose = torch.empty(h, w, dtype=torch.int32, device=depths.device)
    reproj_sum = torch.empty(h, w, dtype=torch.float32, device=depths.device)
    with torch.cuda.device(index):
        rc = _kernel()(
            depths.data_ptr(), h * w, ref, src_index.data_ptr(), src_index.shape[0],
            mats.data_ptr(), ctypes.byref(levels), h, w, counts.data_ptr(), loose.data_ptr(),
            reproj_sum.data_ptr(), torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fuse_ref: kernel launch failed (cudaError {rc})")
    global launches
    launches += 1
    return counts, loose, reproj_sum


def kernel_quotients(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a / c`` by the kernel's division (``csrc/fusion_core.cu:quotient``
    of a ``divisor``), float64, elementwise, for holding it to IEEE
    division; on CPU tensors ``a / c``.  No launch of it is counted: the
    fusion does not call it."""
    if a.is_cpu and c.is_cpu:
        return a / c
    if not (a.is_cuda and c.is_cuda and a.get_device() == c.get_device()
            and a.dtype == c.dtype == torch.float64 and a.shape == c.shape
            and a.is_contiguous() and c.is_contiguous()):
        raise ValueError("kernel_quotients: a and c must be contiguous float64 tensors of "
                         "one shape on one CUDA device (or both on the CPU)")
    out = torch.empty_like(a)
    fn = _build.load("fusion_core.cu").fuse_quotients
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.get_device()):
        rc = fn(a.data_ptr(), c.data_ptr(), a.numel(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel_quotients: kernel launch failed (cudaError {rc})")
    return out


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load("fusion_core.cu").fuse_ref_views
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.POINTER(KernelLevels), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn
