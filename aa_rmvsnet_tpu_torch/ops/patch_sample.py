"""Patch-table bilinear sampling, the warp gather (port of
``build_patch_table`` / ``build_patch_table_quant`` /
``patch_bilinear_sample`` / ``build_patch_table_packed`` /
``build_patch_table_packed_quant`` / ``patch_bilinear_sample_packed`` in
``aa_rmvsnet_tpu/ops/patch_sample.py``).

Once per source view a **patch table** is built: row ``p = y*W + x`` holds
the ``taps x taps`` neighbourhood ``f(y..y+taps-1, x..x+taps-1)`` of a
zero-padded feature map, flattened to ``taps^2 * C`` values.  With the 2x2
table each sample is one gathered row plus a tent-weight blend.  The tent
weights ``max(0, 1 - |coord - corner|)`` give zero-padding, align-corners
bilinear semantics for every case (inside, straddling the border, fully
outside).  With a 4x4 or 6x6 table one gathered row serves a group of K
samples (in the sweep: one pixel, K consecutive depth hypotheses), exact
while the group spans at most ``taps - 2`` px per axis.

The gathers index the JAX package's tables rather than calling
``F.grid_sample``: grid_sample round-trips through normalised coordinates,
which costs ~1e-4 px at W=1152 and can flip winner-take-all near-ties.
Tables are channels-last ``(B, H*W, taps^2 * C)``, like the reference.
Coordinates and weights are computed in fp32 whatever the table's dtype:
bf16 integers step by 2 above 256, so bf16 coordinates would gather the
wrong row.

Quantized tables (the ``--fp8_tables`` / ``--int8_tables`` levers) store
each channel scaled by its own amax over the map, in ``float8_e4m3fn``
(amax onto 448) or ``int8`` (amax onto 127, rounded half to even); the
gather moves whole 1-byte rows and the samplers dequantize after it.  An
int8 table on the packed path takes the JAX package's int8 blend: the
tent weights go onto the 1/127 grid and meet the raw int8 rows in an
integer-exact product (:func:`int8_blend`).  The packed sampler's fused
epilogue can also quantize the squared residual it emits, to fp8, int8
or both (the ``--fp8_residual`` / ``--int8_residual`` / ``--dual_residual``
levers).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.spans import span

#: Largest finite float8_e4m3fn value: a quantized channel's amax maps onto
#: it.  torch saturates casts past it to 448 where JAX gives NaN from 464
#: up; in-range scales never reach there.
F8_MAX = 448.0
QUANT_DTYPES = (torch.float8_e4m3fn, torch.int8)


def true_div(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` rounded once, on every device, as JAX divides.  On
    CUDA, torch divides by a Python scalar as a product with its
    reciprocal, which can land an ulp away (1/448 and 1/127 are inexact)
    and so move a quantization scale off the CPU's and JAX's; a divisor
    tensor on t's device (filled there, no copy from the host) takes the
    true division."""
    return t / torch.full((), divisor, dtype=t.dtype, device=t.device)


def _tent(d: torch.Tensor) -> torch.Tensor:
    """The JAX tent ``max(0, 1 - |d|)``, with JAX's gradients at its kinks:
    ``|d|`` takes slope +1 at d = 0 (the where keeps d >= 0 on the + side;
    torch.abs would give 0), and maximum splits the gradient half and half
    at a tie (clamp would pass all of it).  Offsets of a freshly
    initialised deformable conv are exactly zero, so every deform sample
    lies on a kink there."""
    return torch.maximum(d.new_zeros(()), 1.0 - torch.where(d >= 0, d, -d))


def build_patch_table_packed(feat: torch.Tensor, taps: int = 4) -> torch.Tensor:
    """``taps x taps``-neighbourhood table of an NHWC feature map.

    Args:
      feat: ``(B, H, W, C)``.

    Returns:
      ``(B, H*W, taps^2 * C)``: row ``y*W + x`` holds the texels
      ``(y..y+taps-1) x (x..x+taps-1)`` in row-major order; out-of-image
      texels are zero.
    """
    B, H, W, C = feat.shape
    padded = F.pad(feat, (0, 0, 0, taps - 1, 0, taps - 1))
    views = [padded[:, dy : H + dy, dx : W + dx]
             for dy in range(taps) for dx in range(taps)]
    return torch.cat(views, dim=-1).reshape(B, H * W, taps * taps * C)


def build_patch_table(feat: torch.Tensor) -> torch.Tensor:
    """2x2-neighbourhood table ``(B, H*W, 4C)``: row ``y*W + x`` is
    ``[f(y,x), f(y,x+1), f(y+1,x), f(y+1,x+1)]``."""
    return build_patch_table_packed(feat, taps=2)


def build_patch_table_packed_quant(feat: torch.Tensor, dtype: torch.dtype,
                                   taps: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized :func:`build_patch_table_packed` (``taps=2`` is the 2x2
    table of ``build_patch_table_quant``).

    Each channel is scaled by its own amax over H, W: ``scale = max(amax /
    448, 1e-12)`` for ``torch.float8_e4m3fn`` (a plain cast), ``max(amax /
    127, 1e-12)`` for ``torch.int8`` (rounded half to even, clipped to
    +-127), all in fp32.

    Returns:
      ``(table, scale)``: ``(B, H*W, taps^2 * C)`` in ``dtype`` and the
      fp32 dequantization factors ``(B, 1, taps^2 * C)`` (the channel
      scales tiled over the taps).
    """
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"quantized tables are float8_e4m3fn or int8, not {dtype}")
    B, H, W, C = feat.shape
    feat32 = feat.float()
    amax = feat32.abs().amax(dim=(1, 2), keepdim=True)  # (B, 1, 1, C)
    if dtype == torch.int8:
        scale = torch.clamp_min(true_div(amax, 127.0), 1e-12)
        q = torch.clamp(torch.round(feat32 / scale), -127, 127).to(dtype)
    else:
        scale = torch.clamp_min(true_div(amax, F8_MAX), 1e-12)
        q = (feat32 / scale).to(dtype)
    return build_patch_table_packed(q, taps), scale.reshape(B, 1, C).repeat(1, 1, taps * taps)


def _copy_rows(table: torch.Tensor, take) -> torch.Tensor:
    """``take(table)`` for a gather that copies whole values, run on the
    uint8 view of a float8 table (the CPU's gather has no float8 kernel)."""
    if table.dtype == torch.float8_e4m3fn:
        return take(table.view(torch.uint8)).view(table.dtype)
    return take(table)


class _GatherRowsFp32Sum(torch.autograd.Function):
    """``torch.gather`` of whole table rows, ``(B, N)`` row indices into a
    ``(B, R, K)`` bf16 table, whose backward sums the rows' cotangents in
    fp32 and rounds the sum once to bf16.  A bf16 ``scatter_add`` (the
    gather's own backward) adds every cotangent into a bf16 sum, rounding
    at each of the many samples that share a row (on CUDA with bf16
    atomics): the training sweep gathers each row of a table for every
    depth hypothesis that lands near it."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        B, N = idx.shape
        return torch.gather(table, 1, idx[..., None].expand(B, N, table.shape[2]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        B, R, K = ctx.table_shape
        flat = (idx + torch.arange(B, device=idx.device)[:, None] * R).reshape(-1)
        acc = torch.zeros(B * R, K, dtype=torch.float32, device=grad.device)
        acc.index_add_(0, flat, grad.reshape(-1, K).float())
        return acc.view(B, R, K).to(grad.dtype), None


def int8_blend(weights: torch.Tensor, rows: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``bmm`` of integer tent weights ``(N, K, T^2)`` in [0, 127] and int8
    rows ``(N, T^2, C)`` as the JAX int8 blend's int32 product cast to
    ``out_dtype``: the exact integer sum, rounded once.

    Every operand is an integer of at most 8 bits, exact in bf16; a sum is
    at most 36 * 127 * 127 = 580,644 < 2^24, exact in an fp32
    accumulator.  So an fp32 product is the integer sum, and a bf16 one
    (fp32 accumulation over an inner dimension of 16 or 36, one k-tile, so
    no split-K) is that sum rounded once to bf16, as JAX's int32 -> bf16
    cast rounds it.  Torch has no batched int8 matmul on CUDA, and the
    CPU's int8 ``bmm`` wraps around.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the int8 blend computes in float32 or bfloat16, not {out_dtype}")
    return torch.bmm(weights.to(out_dtype), rows.to(out_dtype))


def patch_bilinear_sample(
    table: torch.Tensor, x: torch.Tensor, y: torch.Tensor, height: int, width: int,
    scale: torch.Tensor | None = None, compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Bilinear samples from a patch table.

    Args:
      table: ``(B, H*W, 4C)`` from :func:`build_patch_table` (or the
        quantized :func:`build_patch_table_packed_quant` with ``taps=2``).
      x, y: ``(B, N)`` fractional pixel coordinates (computed in fp32).
      height, width: table geometry.
      scale: the ``(B, 1, 4C)`` dequantization factors of a quantized
        table; the gathered rows are cast to ``compute_dtype`` and
        multiplied by them before the blend.
      compute_dtype: dtype of the blend and the result; defaults to the
        table's, and a quantized table needs one.

    Returns:
      ``(B, N, C)`` samples in ``compute_dtype``; zero out of bounds.
    """
    B, _, C4 = table.shape
    C = C4 // 4
    N = x.shape[1]
    out_dtype = compute_dtype or table.dtype
    if table.dtype in QUANT_DTYPES and (scale is None or compute_dtype is None):
        raise ValueError("a quantized table needs its scale and a compute_dtype")
    x = x.float()
    y = y.float()
    xb = torch.clamp(torch.floor(x), 0, width - 1)
    yb = torch.clamp(torch.floor(y), 0, height - 1)
    idx = (yb * width + xb).long()
    if table.dtype == torch.bfloat16 and table.requires_grad and torch.is_grad_enabled():
        rows = _GatherRowsFp32Sum.apply(table, idx)
    else:
        rows = _copy_rows(table, lambda t: torch.gather(t, 1, idx[..., None].expand(B, N, C4)))
    rows = rows.to(out_dtype)
    if scale is not None:
        rows = rows * scale.to(out_dtype)

    tx0, tx1 = _tent(x - xb), _tent(x - (xb + 1.0))
    ty0, ty1 = _tent(y - yb), _tent(y - (yb + 1.0))
    w4 = torch.stack([ty0 * tx0, ty0 * tx1, ty1 * tx0, ty1 * tx1], dim=-1)
    return (rows.view(B, N, 4, C) * w4.to(out_dtype)[..., None]).sum(dim=2)


def patch_bilinear_sample_packed(
    table: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    height: int,
    width: int,
    taps: int = 4,
    folded_out: bool = False,
    ref: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
    residual_inv_scale: torch.Tensor | None = None,
    residual_dtype=None,
):
    """Bilinear samples of K grouped coordinates from ONE gathered
    ``taps x taps`` row per group.

    Args:
      table: ``(B, H*W, taps^2 * C)`` from :func:`build_patch_table_packed`
        or :func:`build_patch_table_packed_quant`.
      x, y: ``(B, G, K)`` fractional pixel coordinates; the K samples of a
        group share one gathered row.
      taps: window size per axis (4 or 6); the exactness span is
        ``taps - 2`` px.
      folded_out: return ``(B, G, K*C)`` (k-major, the depth-folded layout
        the cost block consumes) instead of ``(B, G, K, C)``.
      ref: optional ``(B, G, C)`` reference features per group.  Then the
        result is the squared residual ``(sample - ref)**2``, subtracted
        and squared in ``compute_dtype`` on the folded layout, in the
        unfused path's order, so it equals that path bit for bit.
        Requires ``folded_out``.
      scale: the ``(B, 1, taps^2 * C)`` dequantization factors of a
        quantized table.  An fp8 table's rows are cast to
        ``compute_dtype`` and scaled before the blend; an int8 table takes
        the int8 blend: tent weights ``clip(round(w * 127), 0, 127)``
        against the raw rows (:func:`int8_blend`), then ``scale[:C] / 127``
        (in ``compute_dtype``) on the ``(K, C)`` result.
      compute_dtype: dtype of the blend and the result; defaults to the
        table's, and a quantized table needs one.
      residual_inv_scale: optional ``(C,)`` inverse quantization scale of
        the fused residual, multiplied in ``compute_dtype`` after the
        square, tiled over K.
      residual_dtype: storage of the fused residual: ``None`` (in
        ``compute_dtype``), ``torch.float8_e4m3fn`` (a cast),
        ``torch.int8`` (``clip(round(fp32), 0, 127)``) or ``"dual"``, an
        ``(fp8, int8)`` pair whose int8 member is ``clip(round(fp32 *
        127/448), 0, 127)``.

    Returns:
      ``(B, G, K, C)`` samples, or ``(B, G, K*C)`` when ``folded_out``, in
      ``compute_dtype`` or ``residual_dtype`` (a pair of them for
      ``"dual"``).

    EXACTNESS: equal to per-sample bilinear sampling iff every group spans
    at most ``taps - 2`` px per axis.  The window is anchored at the floor
    of the group's minimum coordinate, clipped into the image as in the
    2x2 path; out-of-image texels are zero in the table and taps farther
    than 1 px from a sample get zero tent weight, which covers every
    border case.  A group wider than the span silently loses taps: gate
    with ``models.network.pick_packed_rows``.
    """
    if ref is not None and not folded_out:
        raise ValueError("ref (fused residual) requires folded_out=True")
    if ref is None and (residual_inv_scale is not None or residual_dtype is not None):
        raise ValueError("residual_inv_scale and residual_dtype quantize the fused residual "
                         "and need ref")
    if residual_dtype not in (None, "dual", *QUANT_DTYPES):
        raise ValueError(f"residual_dtype is float8_e4m3fn, int8 or 'dual', not {residual_dtype!r}")
    if table.dtype in QUANT_DTYPES and (scale is None or compute_dtype is None):
        raise ValueError("a quantized table needs its scale and a compute_dtype")
    B, G, K = x.shape
    _, HW, CT = table.shape
    T = taps
    C = CT // (T * T)
    out_dtype = compute_dtype or table.dtype
    x = x.float()
    y = y.float()

    ax = torch.clamp(torch.floor(x.amin(dim=2)), 0, width - 1)  # (B, G)
    ay = torch.clamp(torch.floor(y.amin(dim=2)), 0, height - 1)
    idx = (ay * width + ax).long()
    # Whole rows of T*T*C values: index_select copies rows, where gather
    # would address every element; a quantized table's rows are 1 byte a
    # value.
    flat = (idx + torch.arange(B, device=idx.device)[:, None] * HW).reshape(-1)
    rows = _copy_rows(table.reshape(B * HW, CT), lambda t: t.index_select(0, flat))
    rows = rows.view(B * G, T * T, C)

    # Per-sample weights over the T window rows and columns, combined into
    # one (K, T^2) matrix per group: the blend is one (K x T^2) @ (T^2 x C)
    # product per pixel.  On the card that is a batched GEMM with an inner
    # dimension of 16 or 36, one k-tile, so cuBLAS has no split-K reduction
    # to run in reduced precision and
    # torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # changes nothing; the bf16 product accumulates in fp32 and rounds once.
    tap_pos = torch.arange(T, dtype=torch.float32, device=x.device)
    wx = _tent(x[..., None] - (ax[:, :, None, None] + tap_pos))  # (B, G, K, T)
    wy = _tent(y[..., None] - (ay[:, :, None, None] + tap_pos))
    w = (wy[..., :, None] * wx[..., None, :]).reshape(B * G, K, T * T)
    if table.dtype == torch.int8:
        with span("quant.int8_blend"):
            wq = torch.clamp(torch.round(w * 127.0), 0, 127)
            s_c = true_div(scale[:, :, :C].to(out_dtype), 127.0)  # (B, 1, C)
            out = int8_blend(wq, rows, out_dtype).view(B, G, K, C) * s_c[:, :, None, :]
    elif scale is not None:
        with span("quant.dequant_rows"):
            rows = rows.view(B, G, T * T, C).to(out_dtype) \
                * scale.to(out_dtype).view(B, 1, T * T, C)
        out = torch.bmm(w.to(out_dtype), rows.view(B * G, T * T, C))
    else:
        out = torch.bmm(w.to(out_dtype), rows.to(out_dtype))
    out = out.reshape(B, G, K * C)
    if ref is not None:
        out = (out - ref.to(out_dtype).repeat(1, 1, K)) ** 2
        if residual_inv_scale is not None or residual_dtype is not None:
            with span("quant.residual"):
                out = quantize_residual(out, residual_inv_scale, residual_dtype, K)
    if folded_out:
        return out
    if isinstance(out, tuple):
        return tuple(o.view(B, G, K, C) for o in out)
    return out.view(B, G, K, C)


def quantize_residual(residual_sq: torch.Tensor, inv_scale: torch.Tensor | None,
                      residual_dtype, groups: int):
    """The JAX package's residual quantization on a folded ``(..., G*C)``
    squared residual, in its order: times ``inv_scale`` (``(C,)``, tiled G
    times) in the residual's dtype, then stored as ``residual_dtype``:
    ``torch.float8_e4m3fn`` (a cast), ``torch.int8`` (``clip(round(fp32),
    0, 127)``) or ``"dual"``, an ``(fp8, int8)`` pair whose int8 member is
    ``clip(round(fp32 * 127/448), 0, 127)``: the fp8-scaled value spans
    [0, 448], and 127/448 maps that onto the int8 grid.  Shared by the
    packed sampler's fused epilogue and the unfused cost path, which are
    therefore equal bit for bit."""
    out = residual_sq
    if inv_scale is not None:
        out = out * inv_scale.to(out.dtype).repeat(groups)
    if residual_dtype == "dual":
        i8 = torch.clamp(torch.round(out.float() * (127.0 / F8_MAX)), 0, 127).to(torch.int8)
        return out.to(torch.float8_e4m3fn), i8
    if residual_dtype == torch.int8:
        out = torch.clamp(torch.round(out.float()), 0, 127)
    return out if residual_dtype is None else out.to(residual_dtype)
