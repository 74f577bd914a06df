"""Patch-table bilinear sampling, the exact warp gather (port of
``build_patch_table`` / ``patch_bilinear_sample`` /
``build_patch_table_packed`` / ``patch_bilinear_sample_packed`` in
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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def patch_bilinear_sample(
    table: torch.Tensor, x: torch.Tensor, y: torch.Tensor, height: int, width: int
) -> torch.Tensor:
    """Bilinear samples from a patch table.

    Args:
      table: ``(B, H*W, 4C)`` from :func:`build_patch_table`.
      x, y: ``(B, N)`` fractional pixel coordinates (computed in fp32).
      height, width: table geometry.

    Returns:
      ``(B, N, C)`` samples in the table's dtype; zero out of bounds.
    """
    B, _, C4 = table.shape
    C = C4 // 4
    N = x.shape[1]
    x = x.float()
    y = y.float()
    xb = torch.clamp(torch.floor(x), 0, width - 1)
    yb = torch.clamp(torch.floor(y), 0, height - 1)
    idx = (yb * width + xb).long()
    rows = torch.gather(table, 1, idx[..., None].expand(B, N, C4))

    tx0, tx1 = _tent(x - xb), _tent(x - (xb + 1.0))
    ty0, ty1 = _tent(y - yb), _tent(y - (yb + 1.0))
    w4 = torch.stack([ty0 * tx0, ty0 * tx1, ty1 * tx0, ty1 * tx1], dim=-1)
    return (rows.view(B, N, 4, C) * w4.to(table.dtype)[..., None]).sum(dim=2)


def patch_bilinear_sample_packed(
    table: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    height: int,
    width: int,
    taps: int = 4,
    folded_out: bool = False,
    ref: torch.Tensor | None = None,
    scale=None,
    residual_inv_scale=None,
    residual_dtype=None,
) -> torch.Tensor:
    """Bilinear samples of K grouped coordinates from ONE gathered
    ``taps x taps`` row per group.

    Args:
      table: ``(B, H*W, taps^2 * C)`` from :func:`build_patch_table_packed`.
      x, y: ``(B, G, K)`` fractional pixel coordinates; the K samples of a
        group share one gathered row.
      taps: window size per axis (4 or 6); the exactness span is
        ``taps - 2`` px.
      folded_out: return ``(B, G, K*C)`` (k-major, the depth-folded layout
        the cost block consumes) instead of ``(B, G, K, C)``.
      ref: optional ``(B, G, C)`` reference features per group.  Then the
        result is the squared residual ``(sample - ref)**2``, subtracted
        and squared in the table's dtype on the folded layout, in the
        unfused path's order, so it equals that path bit for bit.
        Requires ``folded_out``.
      scale, residual_inv_scale, residual_dtype: the JAX package's
        quantized tables and residuals; not ported (``NotImplementedError``).

    Returns:
      ``(B, G, K, C)`` samples, or ``(B, G, K*C)`` when ``folded_out``, in
      the table's dtype.

    EXACTNESS: equal to per-sample bilinear sampling iff every group spans
    at most ``taps - 2`` px per axis.  The window is anchored at the floor
    of the group's minimum coordinate, clipped into the image as in the
    2x2 path; out-of-image texels are zero in the table and taps farther
    than 1 px from a sample get zero tent weight, which covers every
    border case.  A group wider than the span silently loses taps: gate
    with ``models.network.pick_packed_rows``.
    """
    if scale is not None or residual_inv_scale is not None or residual_dtype is not None:
        raise NotImplementedError(
            "quantized tables and residuals are not ported to aa_rmvsnet_tpu_torch")
    if ref is not None and not folded_out:
        raise ValueError("ref (fused residual) requires folded_out=True")
    B, G, K = x.shape
    _, HW, CT = table.shape
    T = taps
    C = CT // (T * T)
    x = x.float()
    y = y.float()

    ax = torch.clamp(torch.floor(x.amin(dim=2)), 0, width - 1)  # (B, G)
    ay = torch.clamp(torch.floor(y.amin(dim=2)), 0, height - 1)
    idx = (ay * width + ax).long()
    # Whole rows of T*T*C values: index_select copies rows, where gather
    # would address every element.
    flat = idx + torch.arange(B, device=idx.device)[:, None] * HW
    rows = table.reshape(B * HW, CT).index_select(0, flat.reshape(-1))

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
    out = torch.bmm(w.to(table.dtype), rows.view(B * G, T * T, C)).view(B, G, K * C)
    if ref is not None:
        out = (out - ref.to(out.dtype).repeat(1, 1, K)) ** 2
    return out if folded_out else out.view(B, G, K, C)
