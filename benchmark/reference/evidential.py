"""The EMVSNet evidential head in plain PyTorch, float32.

A 3D-CNN hourglass stack over the depth probability volume predicts the
Normal-Inverse-Gamma parameters (gamma, nu, alpha, beta) of each pixel's
depth at three stages, fused by the mixture-of-NIG rule; trained with the
fork's loss, ``log(var) + (1 + r * nu) * err^2 / var`` with ``var = beta /
nu``.  Layer list and keys are those of the reference torch module
(``evidential.py`` of the EMVSNet fork); kept as the port keeps them: the
third input volume is all ones, and the depth hypotheses are resampled
onto the ``maxdisp`` grid by the align-corners map that resamples the
volume.  BatchNorm (eps 1e-5) normalises with the running statistics in
eval mode and with the batch's in train mode, where the running statistics
move by ``0.9 * stat + 0.1 * batch_stat`` with the biased batch variance.

This module imports nothing of the program.  Tensors are NCDHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F0 = 32  # the stack's base width


def _stack_shapes(shapes: list, name: str, layers: list) -> None:
    for i, (kind, in_c, out_c, k) in enumerate(layers):
        key = f"{name}.{i}"
        if kind == "convbn":
            shapes.append((f"{key}.0.weight", (out_c, in_c, k, k, k)))
            _bn(shapes, f"{key}.1", out_c)
        elif kind == "conv":
            shapes.append((f"{key}.weight", (out_c, in_c, k, k, k)))


def _bn(shapes: list, key: str, c: int) -> None:
    shapes += [(f"{key}.weight", (c,)), (f"{key}.bias", (c,)), (f"{key}.running_mean", (c,)),
               (f"{key}.running_var", (c,)), (f"{key}.num_batches_tracked", ())]


def parameter_shapes() -> list[tuple[str, tuple[int, ...]]]:
    """Every parameter and BatchNorm statistic of the head, with the
    reference's ``state_dict`` key (the head's shapes do not depend on
    ``maxdisp``)."""
    f = F0
    shapes: list = []
    convbn_mish = lambda i, o: [("convbn", i, o, 3), ("mish", 0, 0, 0)]  # noqa: E731
    _stack_shapes(shapes, "dres0", convbn_mish(1, f) + convbn_mish(f, f))
    _stack_shapes(shapes, "dres1", convbn_mish(f, f) + convbn_mish(f, f))
    _stack_shapes(shapes, "conv_vol2", convbn_mish(1, f) + [("convbn", f, f, 3)])
    _stack_shapes(shapes, "conv_vol3", convbn_mish(1, f) + [("convbn", f, f, 3)])

    def convbn(key, i, o, k=3):
        shapes.append((f"{key}.0.weight", (o, i, k, k, k)))
        _bn(shapes, f"{key}.1", o)

    def deconvbn(key, i, o):
        shapes.append((f"{key}.0.weight", (i, o, 3, 3, 3)))
        _bn(shapes, f"{key}.1", o)

    up = "combine1"
    shapes.append((f"{up}.conv1.weight", (2 * f, f, 3, 3, 3)))
    convbn(f"{up}.combine1.0", 2 * f + 32, 2 * f)
    convbn(f"{up}.conv2.0", 2 * f, 2 * f)
    shapes.append((f"{up}.conv3.weight", (4 * f, 2 * f, 3, 3, 3)))
    convbn(f"{up}.combine2.0", 4 * f + 32, 4 * f)
    convbn(f"{up}.conv4.0", 4 * f, 4 * f)
    convbn(f"{up}.redir3", 4 * f, 4 * f, 1)
    deconvbn(f"{up}.conv8", 4 * f, 2 * f)
    convbn(f"{up}.redir2", 2 * f, 2 * f, 1)
    deconvbn(f"{up}.conv9", 2 * f, f)
    convbn(f"{up}.redir1", f, f, 1)
    for hg in ("dres2", "dres3"):
        convbn(f"{hg}.conv1.0", f, 2 * f)
        convbn(f"{hg}.conv2.0", 2 * f, 2 * f)
        convbn(f"{hg}.conv3.0", 2 * f, 4 * f)
        convbn(f"{hg}.conv4.0", 4 * f, 4 * f)
        deconvbn(f"{hg}.conv5", 4 * f, 2 * f)
        deconvbn(f"{hg}.conv6", 2 * f, f)
        convbn(f"{hg}.redir1", f, f, 1)
        convbn(f"{hg}.redir2", 2 * f, 2 * f, 1)
    for c in ("classif0", "classif1", "classif2"):
        convbn(f"{c}.0", f, f)
        shapes.append((f"{c}.2.weight", (4, f, 3, 3, 3)))
    return shapes


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def batch_norm(x: torch.Tensor, p: dict, key: str, train: bool, stats: dict | None):
    """BatchNorm3d of ``x``; in train mode on the batch's statistics, with
    the new running statistics written to ``stats`` (a dict the caller
    keeps; ``p`` is never written)."""
    w, b = p[f"{key}.weight"], p[f"{key}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3, 4))
        var = ((x - mean[:, None, None, None]) ** 2).mean(dim=(0, 2, 3, 4))
        if stats is not None:
            rm, rv = p[f"{key}.running_mean"], p[f"{key}.running_var"]
            stats[f"{key}.running_mean"] = 0.9 * rm + 0.1 * mean.detach()
            stats[f"{key}.running_var"] = 0.9 * rv + 0.1 * var.detach()
    else:
        mean, var = p[f"{key}.running_mean"], p[f"{key}.running_var"]
    scale = w / torch.sqrt(var + 1e-5)
    return (x - mean[:, None, None, None]) * scale[:, None, None, None] + b[:, None, None, None]


class _Head:
    """One application of the head: the parameters, the mode and where the
    new running statistics go."""

    def __init__(self, p: dict, train: bool, stats: dict | None):
        self.p, self.train, self.stats = p, train, stats

    def convbn(self, x, key, stride=1):
        w = self.p[f"{key}.0.weight"]
        y = F.conv3d(x, w, stride=stride, padding=w.shape[-1] // 2)
        return batch_norm(y, self.p, f"{key}.1", self.train, self.stats)

    def deconvbn(self, x, key):
        y = F.conv_transpose3d(x, self.p[f"{key}.0.weight"], stride=2, padding=1,
                               output_padding=1)
        return batch_norm(y, self.p, f"{key}.1", self.train, self.stats)

    def conv_mish(self, x, key, stride=1):
        return mish(self.convbn(x, f"{key}.0", stride))

    def hourglass(self, x, key):
        conv2 = self.conv_mish(self.conv_mish(x, f"{key}.conv1", 2), f"{key}.conv2")
        conv4 = self.conv_mish(self.conv_mish(conv2, f"{key}.conv3", 2), f"{key}.conv4")
        conv5 = mish(self.deconvbn(conv4, f"{key}.conv5") + self.convbn(conv2, f"{key}.redir2"))
        return mish(self.deconvbn(conv5, f"{key}.conv6") + self.convbn(x, f"{key}.redir1"))

    def hourglass_up(self, x, feat4, feat5, key):
        p = self.p
        down = F.conv3d(x, p[f"{key}.conv1.weight"], stride=2, padding=1)
        conv1 = self.conv_mish(torch.cat([down, feat4], dim=1), f"{key}.combine1")
        conv2 = self.conv_mish(conv1, f"{key}.conv2")
        down = F.conv3d(conv2, p[f"{key}.conv3.weight"], stride=2, padding=1)
        conv3 = self.conv_mish(torch.cat([down, feat5], dim=1), f"{key}.combine2")
        conv4 = self.conv_mish(conv3, f"{key}.conv4")
        conv7 = mish(self.convbn(conv4, f"{key}.redir3"))
        conv8 = mish(self.deconvbn(conv7, f"{key}.conv8") + self.convbn(conv2, f"{key}.redir2"))
        return mish(self.deconvbn(conv8, f"{key}.conv9") + self.convbn(x, f"{key}.redir1"))

    def stack(self, x, key, pairs):
        """``convbn (+ mish)`` layers ``{key}.0``, ``{key}.2``, ..."""
        for i, with_mish in pairs:
            x = self.convbn(x, f"{key}.{i}")
            if with_mish:
                x = mish(x)
        return x

    def classify(self, feat, key, dvals):
        x = mish(self.convbn(feat, f"{key}.0"))
        out = F.conv3d(x, self.p[f"{key}.2.weight"], padding=1)
        cost, logla, logalpha, logbeta = out.unbind(1)
        prob = torch.softmax(cost, dim=1)
        pred = torch.sum(prob * dvals[:, :, None, None], dim=1)
        la = F.softplus(torch.sum(logla * prob, dim=1))
        alpha = F.softplus(torch.sum(logalpha * prob, dim=1)) + 1.0
        beta = F.softplus(torch.sum(logbeta * prob, dim=1))
        return pred, la, alpha, beta


def interp_matrix(in_size: int, out_size: int, device) -> torch.Tensor:
    """``(out, in)`` align-corners linear interpolation weights; a size-1 axis
    maps every output to input 0."""
    m = torch.zeros(out_size, in_size, dtype=torch.float64)
    if out_size == 1 or in_size == 1:
        m[:, 0] = 1.0
        return m.float().to(device)
    pos = torch.arange(out_size, dtype=torch.float64) * (in_size - 1) / (out_size - 1)
    i0 = torch.clamp(torch.floor(pos).long(), max=in_size - 2)
    frac = pos - i0
    rows = torch.arange(out_size)
    m[rows, i0] = 1.0 - frac
    m[rows, i0 + 1] = frac
    return m.float().to(device)


def moe_nig(u1, la1, a1, b1, u2, la2, a2, b2):
    la = la1 + la2
    u = (la1 * u1 + la2 * u2) / la
    return (u, la, a1 + a2 + 0.5,
            b1 + b2 + 0.5 * (la1 * (u1 - u) ** 2 + la2 * (u2 - u) ** 2))


def head(p: dict, prob_volume: torch.Tensor, depth_values: torch.Tensor, maxdisp: int,
         train: bool = False, stats: dict | None = None) -> dict:
    """NIG maps ``(B, H, W)`` of a ``(B, D, H, W)`` probability volume."""
    B, D, H, W = prob_volume.shape
    M = maxdisp
    run = _Head(p, train, stats)
    x = prob_volume[:, None]
    vol1 = torch.softmax(F.interpolate(x, size=(M, H, W), mode="trilinear",
                                       align_corners=True), dim=2)
    vol2 = torch.softmax(F.interpolate(x, size=(M // 2, H // 2, W // 2), mode="trilinear",
                                       align_corners=True), dim=2)
    vol3 = x.new_ones(B, 1, M // 4, H // 4, W // 4)
    cost0 = run.stack(vol1, "dres0", ((0, True), (2, True)))
    cost0 = run.stack(cost0, "dres1", ((0, True), (2, True))) + cost0
    v2 = run.stack(vol2, "conv_vol2", ((0, True), (2, False)))
    v3 = run.stack(vol3, "conv_vol3", ((0, True), (2, False)))
    combine = run.hourglass_up(cost0, v2, v3, "combine1")
    out1 = run.hourglass(combine, "dres2")
    out2 = run.hourglass(out1, "dres3")
    dvals = depth_values.float() @ interp_matrix(D, M, depth_values.device).T
    est = [run.classify(f, k, dvals) for f, k in ((cost0, "classif0"), (out1, "classif1"),
                                                 (out2, "classif2"))]
    u, la, alpha, beta = moe_nig(*est[0], *est[1])
    u, la, alpha, beta = moe_nig(u, la, alpha, beta, *est[2])
    return {"gamma": u, "nu": la, "alpha": alpha, "beta": beta}


def evidential_loss(nig: dict, depth_gt: torch.Tensor, mask: torch.Tensor,
                    weight_reg: float = 0.1) -> torch.Tensor:
    valid = mask > 0.5
    var = nig["beta"] / nig["nu"]
    err = nig["gamma"] - depth_gt
    per_px = torch.log(var) + (1.0 + weight_reg * nig["nu"]) * err ** 2 / var
    return torch.where(valid, per_px, 0.0).sum() / valid.sum().clamp(min=1)


def uncertainty(nig: dict) -> dict:
    """The aleatoric and epistemic maps ``cli eval`` writes."""
    nu, alpha, beta = nig["nu"], nig["alpha"], nig["beta"]
    return {"aleatoric": torch.sqrt(beta * (nu + 1) / nu / alpha),
            "epistemic": 1.0 / torch.sqrt(nu)}
