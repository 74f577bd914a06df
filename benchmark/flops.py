"""Model FLOPs from shapes: 2 x the multiply-adds of every convolution,
deformable convolution and GEMM of AA-RMVSNet and of the evidential head.

Counted from the published layer list at a given geometry, independent of
how the port computes: the bilinear blends, norms and activations are not
counted, the warp's homography GEMM and the head's depth resampling are.
A transposed convolution counts ``k^d`` multiply-adds per input voxel and
output channel.  A training step is three forward passes' worth (forward,
and the backward's two products per layer); remat's recompute is not
counted.
"""

from __future__ import annotations

from .reference.aa_rmvsnet import HIDDEN


def _conv(out_px: int, in_c: int, out_c: int, k: int, dims: int = 2) -> float:
    return 2.0 * out_px * in_c * out_c * k ** dims


def featnet(H: int, W: int) -> float:
    """One view's FeatNet."""
    px = [H * W, H * W // 4, H * W // 16]
    f = _conv(px[0], 3, 8, 3) + _conv(px[0], 8, 16, 3) + _conv(px[0], 16, 32, 3)
    f += _conv(px[1], 32, 32, 3) + _conv(px[2], 32, 32, 3)
    for n, out_c in zip(px, (16, 8, 8)):
        # offsets (18), modulations (9), the 9 modulated taps, the 1x1 squeeze
        f += _conv(n, 32, 18, 3) + _conv(n, 32, 9, 3) + _conv(n, 32, 32, 3) + _conv(n, 32, out_c, 1)
    return f


def depth_step(H: int, W: int, V: int) -> float:
    """One hypothesis: omega on each source view's residual and one
    ConvLSTM U-Net step."""
    px = H * W
    omega = _conv(px, 32, 4, 3) + _conv(px, 4, 4, 1) + _conv(px, 4, 4, 1) + _conv(px, 4, 1, 1)
    res = [px, px // 4, px // 16, px // 4, px]
    ins = (32, 16, 16, 32, 32)
    cells = sum(_conv(n, i + h, 4 * h, 3) for n, i, h in zip(res, ins, HIDDEN))
    deconvs = _conv(px // 16, 16, 16, 3) + _conv(px // 4, 16, 16, 3)  # per input pixel
    return (V - 1) * omega + cells + deconvs + _conv(px, 8, 1, 3)


def core_forward(H: int, W: int, V: int, D: int, batch: int = 1) -> float:
    """The core's forward over all D hypotheses, with the homography GEMMs."""
    homography = (V - 1) * (2.0 * 4 * 4 * 4 + 2.0 * 3 * 3 * H * W)
    return batch * (V * featnet(H, W) + homography + D * depth_step(H, W, V))


def head_forward(H: int, W: int, D: int, maxdisp: int, batch: int = 1) -> float:
    """The evidential head on a ``(D, H, W)`` probability volume: volumes at
    full, half and quarter resolution of ``(maxdisp, H, W)``."""
    f = 32
    full = maxdisp * H * W
    half = (maxdisp // 2) * (H // 2) * (W // 2)
    quarter = (maxdisp // 4) * (H // 4) * (W // 4)

    def c3(n, i, o, k=3):
        return _conv(n, i, o, k, dims=3)

    total = c3(full, 1, f) + 3 * c3(full, f, f)  # dres0, dres1
    total += c3(half, 1, f) + c3(half, f, f) + c3(quarter, 1, f) + c3(quarter, f, f)  # conv_vol2, 3
    # hourglass_up; a transposed convolution counts per input voxel
    total += c3(half, f, 2 * f) + c3(half, 2 * f + 32, 2 * f) + c3(half, 2 * f, 2 * f)
    total += c3(quarter, 2 * f, 4 * f) + c3(quarter, 4 * f + 32, 4 * f) + c3(quarter, 4 * f, 4 * f)
    total += c3(quarter, 4 * f, 4 * f, 1) + c3(quarter, 4 * f, 2 * f) + c3(half, 2 * f, 2 * f, 1)
    total += c3(half, 2 * f, f) + c3(full, f, f, 1)
    hourglass = (c3(half, f, 2 * f) + c3(half, 2 * f, 2 * f) + c3(quarter, 2 * f, 4 * f)
                 + c3(quarter, 4 * f, 4 * f) + c3(quarter, 4 * f, 2 * f)
                 + c3(half, 2 * f, 2 * f, 1) + c3(half, 2 * f, f) + c3(full, f, f, 1))
    total += 2 * hourglass  # dres2, dres3
    total += 3 * (c3(full, f, f) + c3(full, f, 4))  # the classifiers
    total += 2.0 * D * maxdisp  # the depth hypotheses onto the maxdisp grid
    return batch * total
