"""AA-RMVSNet in plain PyTorch, float32: the yardstick the port is judged by.

Written from the published network (Wei et al., "AA-RMVSNet: Adaptive
Aggregation Recurrent Multi-view Stereo Network", ICCV 2021) and its
reference code's layer list, one function per layer over a dict of
tensors whose keys are the reference torch ``state_dict`` keys.  No kernel,
cache, table or batching trick: every warp is a four-corner bilinear gather
in pixel coordinates with zero padding, every convolution a plain
``torch.nn.functional`` call, and the depth sweep a loop over hypotheses.

- FeatNet: a 3-scale pyramid (stride 1 / 2 / 4) refined by modulated
  deformable 3x3 convolutions (v2), compressed to 16 / 8 / 8 channels,
  upsampled with align-corners bilinear and concatenated to 32 channels.
- The cost: each source view warped to every hypothesis through the
  plane-sweep homography, its squared residual against the reference
  reweighted by the inter-view network omega as ``(w + 1) * r``, averaged
  over the source views and negated.
- The regularizer: a 5-cell ConvLSTM U-Net stepped once per hypothesis,
  whose 1-channel output is the cost slice of that depth.
- The training loss: masked cross-entropy of the probability volume
  against the nearest-hypothesis one-hot bin.

Two departures from the published text, as the port's reference code has
them: GroupNorm uses ``max(1, C // 8)`` groups, and a warp denominator that
is exactly 0 gets ``+1e-4``.

The reference computes in float32 with TF32 off.  Given a ``Weights``
whose ``cast`` rounds tensors (:func:`fp8_e4m3`), it computes in a lower
precision instead: every convolution's and GEMM's operands and every warp
sample rounded, products accumulated in float32, as an fp8 GEMM does; that
is the control the check must tell apart.

This module imports nothing of the program.  Tensors are NCHW inside.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: Hidden channels of the five ConvLSTM cells, at resolutions 1, 1/2, 1/4,
#: 1/2, 1 of the map.
HIDDEN = (16, 16, 16, 16, 8)
FEATURES = 32


def parameter_shapes() -> list[tuple[str, tuple[int, ...]]]:
    """Every parameter of the core, with the reference's ``state_dict`` key."""
    shapes = []

    def conv(name, out_c, in_c, k, bias=True):
        shapes.append((f"{name}.weight", (out_c, in_c, k, k)))
        if bias:
            shapes.append((f"{name}.bias", (out_c,)))

    def gn(name, c):
        shapes.append((f"{name}.weight", (c,)))
        shapes.append((f"{name}.bias", (c,)))

    def conv_gn(name, out_c, in_c, k):
        conv(f"{name}.0", out_c, in_c, k)
        gn(f"{name}.1", out_c)

    conv_gn("feature.init_conv.0", 8, 3, 3)
    conv_gn("feature.init_conv.1", 16, 8, 3)
    conv_gn("feature.conv0", 32, 16, 3)
    conv_gn("feature.conv1", 32, 32, 3)
    conv_gn("feature.conv2", 32, 32, 3)
    for i, out_c in enumerate((16, 8, 8)):
        base = f"feature.intraAA.deformconv{i}"
        conv(f"{base}.0.conv", 32, 32, 3)
        conv(f"{base}.0.p_conv", 18, 32, 3)
        conv(f"{base}.0.m_conv", 9, 32, 3)
        gn(f"{base}.1", 32)
        conv_gn(f"feature.intraAA.conv{i}", out_c, 32, 1)
    conv_gn("omega.reweight_network.0", 4, 32, 3)
    conv_gn("omega.reweight_network.1.stem.0", 4, 4, 1)
    conv("omega.reweight_network.1.stem.1", 4, 4, 1)
    gn("omega.reweight_network.1.stem.2", 4)
    conv("omega.reweight_network.2", 1, 4, 1)
    for i, (in_c, hid) in enumerate(zip((32, 16, 16, 32, 32), HIDDEN)):
        conv(f"cost_regularization.cell_list.{i}.conv", 4 * hid, in_c + hid, 3)
    for i in range(2):
        # A transposed convolution's weight is (in, out, k, k).
        conv(f"cost_regularization.deconv_{i}.conv", 16, 16, 3)
        gn(f"cost_regularization.deconv_{i}.gn", 16)
    conv("cost_regularization.conv_0", 1, 8, 3)
    return shapes


class Weights(dict):
    """The parameters by ``state_dict`` key, and the rounding of the
    operands (none: float32)."""

    cast = None


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude onto 448), returned in ``t``'s dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _cast(p: dict, *tensors):
    cast = getattr(p, "cast", None)
    return tensors if cast is None else tuple(cast(t) for t in tensors)


# ---------------------------------------------------------------- layers


def group_norm(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    c = x.shape[1]
    return F.group_norm(x, max(1, c // 8), p[f"{name}.weight"], p[f"{name}.bias"], eps=1e-5)


def conv(x: torch.Tensor, p: dict, name: str, stride: int = 1) -> torch.Tensor:
    x, w = _cast(p, x, p[f"{name}.weight"])
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride=stride, padding=w.shape[-1] // 2)


def conv_gn_relu(x: torch.Tensor, p: dict, name: str, stride: int = 1) -> torch.Tensor:
    return torch.relu(group_norm(conv(x, p, f"{name}.0", stride), p, f"{name}.1"))


def bilinear(feat: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Samples of ``feat`` ``(B, C, H, W)`` at pixel coordinates ``x``, ``y``
    ``(B, N)`` (pixel centres at whole numbers), zero outside the map.
    Returns ``(B, C, N)``."""
    B, C, H, W = feat.shape
    flat = feat.reshape(B, C, H * W)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    out = None
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi = x0 + dx
            yi = y0 + dy
            inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            weight = torch.where(inside, wx * wy, torch.zeros_like(wx))
            term = torch.gather(flat, 2, idx[:, None].expand(B, C, idx.shape[1])) * weight[:, None]
            out = term if out is None else out + term
    return out


def deform_conv_gn_relu(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """Modulated deformable 3x3 convolution (v2) + GroupNorm + ReLU: tap
    ``n`` of output pixel ``(i, j)`` samples ``x`` at ``(i + n // 3 - 1 +
    dy_n, j + n % 3 - 1 + dx_n)``, the offsets ``dy`` (channels 0-8) and
    ``dx`` (9-17) from a 3x3 convolution, scaled by the sigmoid of another."""
    B, C, H, W = x.shape
    offset = conv(x, p, f"{name}.0.p_conv")
    modulation = torch.sigmoid(conv(x, p, f"{name}.0.m_conv"))
    x_taps, weight = _cast(p, x, p[f"{name}.0.conv.weight"])  # weight (O, C, 3, 3)
    rows = torch.arange(H, dtype=x.dtype, device=x.device)[:, None].expand(H, W)
    cols = torch.arange(W, dtype=x.dtype, device=x.device)[None, :].expand(H, W)
    out = p[f"{name}.0.conv.bias"][None, :, None].expand(B, -1, H * W)
    for n in range(9):
        y = rows + (n // 3 - 1) + offset[:, n]
        xx = cols + (n % 3 - 1) + offset[:, 9 + n]
        tap = bilinear(x_taps, xx.reshape(B, -1), y.reshape(B, -1))  # (B, C, HW)
        tap, = _cast(p, tap * modulation[:, n].reshape(B, 1, -1))
        out = out + torch.einsum("oc,bcn->bon", weight[:, :, n // 3, n % 3], tap)
    out = out.reshape(B, -1, H, W)
    return torch.relu(group_norm(out, p, f"{name}.1"))


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, size=(x.shape[2] * factor, x.shape[3] * factor), mode="bilinear",
                         align_corners=True)


def featnet(p: dict, imgs: torch.Tensor) -> torch.Tensor:
    """``(N, 3, H, W)`` standardized images -> ``(N, 32, H, W)`` features."""
    x = conv_gn_relu(imgs, p, "feature.init_conv.0")
    x = conv_gn_relu(x, p, "feature.init_conv.1")
    x0 = conv_gn_relu(x, p, "feature.conv0")
    x1 = conv_gn_relu(x0, p, "feature.conv1", stride=2)
    x2 = conv_gn_relu(x1, p, "feature.conv2", stride=2)
    scales = []
    for i, (xi, factor) in enumerate(((x0, 1), (x1, 2), (x2, 4))):
        m = deform_conv_gn_relu(xi, p, f"feature.intraAA.deformconv{i}")
        m = conv_gn_relu(m, p, f"feature.intraAA.conv{i}")
        scales.append(m if factor == 1 else upsample(m, factor))
    return torch.cat(scales, dim=1)


def omega(p: dict, residual: torch.Tensor) -> torch.Tensor:
    """Inter-view reweighting: ``(N, 32, H, W)`` squared residual -> ``(N,
    1, H, W)`` weight in (0, 1)."""
    y = conv_gn_relu(residual, p, "omega.reweight_network.0")
    z = conv_gn_relu(y, p, "omega.reweight_network.1.stem.0")
    z = group_norm(conv(z, p, "omega.reweight_network.1.stem.1"), p,
                   "omega.reweight_network.1.stem.2")
    y = torch.relu(z + y)
    return torch.sigmoid(conv(y, p, "omega.reweight_network.2"))


def warp_terms(src_proj: torch.Tensor, ref_proj: torch.Tensor, H: int, W: int):
    """``R @ [x, y, 1]`` per reference pixel ``(B, 3, H*W)`` and the
    translation ``(B, 3, 1)`` of ``src_proj @ ref_proj^-1``."""
    proj = src_proj @ torch.linalg.inv(ref_proj)
    kw = dict(dtype=src_proj.dtype, device=src_proj.device)
    y, x = torch.meshgrid(torch.arange(H, **kw), torch.arange(W, **kw), indexing="ij")
    pix = torch.stack([x.reshape(-1), y.reshape(-1), torch.ones(H * W, **kw)])
    return proj[:, :3, :3] @ pix, proj[:, :3, 3:4]


def cost_slices(p: dict, ref: torch.Tensor, sources: list, terms: list,
                depths: torch.Tensor) -> torch.Tensor:
    """The negated reweighted variance of the hypotheses ``depths`` ``(B,
    K)``: ``(K, B, 32, H, W)``."""
    B, C, H, W = ref.shape
    K = depths.shape[1]
    total = None
    for src, (rot, trans) in zip(sources, terms):
        xyz = rot[:, None] * depths[:, :, None, None] + trans[:, None]  # (B, K, 3, HW)
        z = xyz[:, :, 2]
        z = torch.where(z == 0.0, z + 1e-4, z)
        x = (xyz[:, :, 0] / z).reshape(B, -1)
        y = (xyz[:, :, 1] / z).reshape(B, -1)
        warped = bilinear(src, x, y).reshape(B, C, K, H, W).transpose(1, 2)
        residual = (warped - ref[:, None]) ** 2  # (B, K, C, H, W)
        weight = omega(p, residual.reshape(B * K, C, H, W)).reshape(B, K, 1, H, W)
        term = (weight + 1.0) * residual
        total = term if total is None else total + term
    return -(total / len(sources)).transpose(0, 1)


def lstm_cell(p: dict, i: int, x: torch.Tensor, state):
    h, c = state
    z = conv(torch.cat([x, h], dim=1), p, f"cost_regularization.cell_list.{i}.conv")
    gi, gf, go, gg = torch.chunk(z, 4, dim=1)
    c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    return torch.sigmoid(go) * torch.tanh(c), c


def deconv_gn_relu(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    x, w = _cast(p, x, p[f"{name}.conv.weight"])
    y = F.conv_transpose2d(x, w, p[f"{name}.conv.bias"], stride=2, padding=1, output_padding=1)
    return torch.relu(group_norm(y, p, f"{name}.gn"))


def regularize(p: dict, cost: torch.Tensor, states: list):
    """One ConvLSTM U-Net step: ``(B, 32, H, W)`` cost slice -> ``(B, 1, H,
    W)`` regularized cost, and the new states."""
    s0 = lstm_cell(p, 0, cost, states[0])
    s1 = lstm_cell(p, 1, F.max_pool2d(s0[0], 2, 2), states[1])
    s2 = lstm_cell(p, 2, F.max_pool2d(s1[0], 2, 2), states[2])
    up = deconv_gn_relu(s2[0], p, "cost_regularization.deconv_0")
    s3 = lstm_cell(p, 3, torch.cat([up, s1[0]], dim=1), states[3])
    up = deconv_gn_relu(s3[0], p, "cost_regularization.deconv_1")
    s4 = lstm_cell(p, 4, torch.cat([up, s0[0]], dim=1), states[4])
    return conv(s4[0], p, "cost_regularization.conv_0"), [s0, s1, s2, s3, s4]


def zero_states(B: int, H: int, W: int, like: torch.Tensor) -> list:
    sizes = ((H, W), (H // 2, W // 2), (H // 4, W // 4), (H // 2, W // 2), (H, W))
    return [(like.new_zeros(B, hid, h, w), like.new_zeros(B, hid, h, w))
            for hid, (h, w) in zip(HIDDEN, sizes)]


def cost_volume(p: dict, imgs: torch.Tensor, proj: torch.Tensor, depth_values: torch.Tensor,
                block: int = 8) -> torch.Tensor:
    """The regularized cost volume ``(B, D, H, W)`` of ``imgs`` ``(B, V, H,
    W, 3)`` (view 0 the reference), ``proj`` ``(B, V, 4, 4)`` and the
    hypotheses ``depth_values`` ``(B, D)`` in sweep order.  ``block``
    hypotheses are warped at a time; it changes no value."""
    B, V, H, W, _ = imgs.shape
    feats = featnet(p, imgs.permute(0, 1, 4, 2, 3).reshape(B * V, 3, H, W))
    feats = feats.reshape(B, V, FEATURES, H, W)
    ref, *sources = _cast(p, *feats.unbind(1))
    terms = [warp_terms(proj[:, v], proj[:, 0], H, W) for v in range(1, V)]
    states = zero_states(B, H, W, imgs)
    costs = []
    D = depth_values.shape[1]
    for start in range(0, D, block):
        for cost in cost_slices(p, ref, sources, terms, depth_values[:, start:start + block]):
            out, states = regularize(p, cost, states)
            costs.append(out[:, 0])
    return torch.stack(costs, dim=1)


def depth_and_confidence(volume: torch.Tensor, depth_values: torch.Tensor):
    """Winner-take-all depth (the first of equal maxima) and its softmax
    probability, ``(B, H, W)`` each."""
    best = torch.argmax(volume, dim=1)
    depth = torch.gather(depth_values, 1, best.reshape(best.shape[0], -1)).reshape(best.shape)
    conf = torch.exp(volume.max(dim=1).values - torch.logsumexp(volume, dim=1))
    return depth, conf


def classification_loss(volume: torch.Tensor, depth_gt: torch.Tensor, mask: torch.Tensor,
                        depth_values: torch.Tensor) -> torch.Tensor:
    """Masked cross-entropy of ``softmax(volume)`` against the hypothesis
    nearest the ground truth (the first of a tie), per-image sums over the
    valid count + 1e-6, averaged over the batch."""
    prob = torch.softmax(volume, dim=1)
    gt = torch.argmin(torch.abs(depth_values[:, :, None, None] - depth_gt[:, None]), dim=1)
    gt = torch.round(mask * gt).long()
    ce = -torch.log(torch.gather(prob, 1, gt[:, None])[:, 0] + 1e-12)
    return ((mask * ce).sum(dim=(1, 2)) / (mask.sum(dim=(1, 2)) + 1e-6)).mean()


def cosine_factor(step: int, total_steps: int, alpha: float) -> float:
    """The cosine schedule from 1 to ``alpha`` over ``total_steps``."""
    t = min(step, total_steps)
    return alpha + (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / total_steps))
