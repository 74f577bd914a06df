"""Evidential (NIG) uncertainty head and its losses (port of
``aa_rmvsnet_tpu/models/evidential.py``), NCDHW.

A 3D-CNN hourglass stack over the depth probability volume predicts
Normal-Inverse-Gamma parameters (gamma, nu, alpha, beta) per pixel at three
depths of the stack and fuses them by the analytic mixture-of-NIG rule.  The
JAX package's two deliberate deviations from the reference are kept:

1. the third input volume is all ones (the reference softmaxes it over its
   size-1 batch axis, ``evidential.py:184-187``);
2. with D != maxdisp hypotheses the depth values are resampled onto the
   maxdisp grid by the align-corners map that resamples the volume
   (``evidential.py:204-207``); the identity when D == maxdisp.

Submodule names are those of the reference torch module, so
``state_dict`` keys are the ones ``aa_rmvsnet_tpu/models/convert.py``
``_evidential_rules`` lists: a ``convbn_3d`` is ``Sequential(conv, bn)``, a
Mish-wrapped stack is ``Sequential(convbn, Mish, ...)``, a transposed conv
with its BN is ``Sequential(deconv, bn)``.  In eval mode BatchNorm
normalises with its running statistics (eps 1e-5); in train mode with the
batch's, and the running statistics update as flax's do
(:class:`FlaxBatchNorm3d`).  The JAX package computes all of it in XLA;
here the 3D convolutions are cuDNN's and the rest plain torch ops.

On a spatial mesh (``forward(..., mesh)``, ``parallel/spatial.py``) each
rank runs the head on its slab of the volume's rows, as GSPMD keeps the
JAX package's head row-sharded: every 3D convolution reads its halo rows
(``conv3d_rows``, ``conv_transpose3d_rows``), the half-height volume's
rows are resampled at their map indices (``resize_rows``), the
quarter-height volume of ones reads its neighbours' ones, train-mode
BatchNorm sums its statistics over the ranks, and the rest is per pixel.
A slab's rows must be a multiple of 4 (the head halves them twice).
Profiler ranges (``evidential.volumes``, ``.dres``, ``.hourglass_up``,
``.hourglass``, ``.classify``) name its stages, and ``head.deconv`` each
transposed 3D convolution inside them, for the benchmark's traced cells
and ``tools/profile_head.py``.  ``head.deconv`` does not start with
``evidential.``: ``head.ms_per_map`` sums the ``evidential.*`` ranges.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.resize import interp_matrix, resize_trilinear_align_corners
from ..parallel.mesh import Mesh, all_reduce_sum
from ..parallel.spatial import conv3d_rows, conv_transpose3d_rows, resize_rows
from ..utils.spans import span
from .init import init_like_jax


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x * tanh(softplus(x))`` (``evidential.py:37``)."""
    return F.mish(x)


class FlaxBatchNorm3d(nn.BatchNorm3d):
    """``BatchNorm3d`` whose train-mode update of the running statistics is
    flax's ``nn.BatchNorm(momentum=0.9)`` (``evidential.py:59-60, 94-95``):
    ``stat = 0.9 * stat + 0.1 * batch_stat`` with the *biased* batch
    variance, where ``nn.BatchNorm3d`` takes the unbiased one (n / (n - 1)
    times larger).  The normalisation, its gradient through the batch
    statistics, the eval mode and the ``state_dict`` keys are
    ``nn.BatchNorm3d``'s.

    With ``process_groups`` set (:func:`batch_statistics_over`: the spatial
    group, whose ranks hold the rows, and the data group, whose ranks hold
    the samples) the batch is the global batch, as flax computes it over
    the whole sharded batch: the sum, the count and the sum of centred
    squares are summed over each group's ranks in turn by a differentiable
    all-reduce, so that the normalisation, its gradient and the running
    statistics (identical on every rank) are those of one process holding
    the global batch.  ``nn.SyncBatchNorm`` is no substitute: it refuses
    CPU tensors and keeps the unbiased running variance."""

    #: The process groups whose ranks share the batch in train mode; none:
    #: this process's batch.
    process_groups: tuple = ()

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_groups:
            return self._forward_global(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), correction=0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_sum(self, t: torch.Tensor) -> torch.Tensor:
        for group in self.process_groups:
            t = all_reduce_sum(t, group)
        return t

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        dims = (0, 2, 3, 4)
        count = x.new_full((1,), x.numel() // x.shape[1])
        total = self._global_sum(torch.cat([x.sum(dims), count]))
        mean = total[:-1] / total[-1]
        centred = x - mean[:, None, None, None]
        var = self._global_sum(centred.square().sum(dims)) / total[-1]
        with torch.no_grad():
            self._update_running(mean, var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return centred * scale[:, None, None, None] + self.bias[:, None, None, None]


@contextlib.contextmanager
def batch_statistics_over(module: nn.Module, groups):
    """Every :class:`FlaxBatchNorm3d` of ``module`` takes its train-mode
    statistics over the global batch inside the context: ``groups`` are the
    process groups (the spatial group, then the data group) whose ranks
    together hold it; None entries are skipped, and none leave this
    process's batch."""
    groups = tuple(g for g in groups if g is not None)
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm3d)]
    for m in norms:
        m.process_groups = groups
    try:
        yield
    finally:
        for m in norms:
            m.process_groups = ()


class _Stack(nn.Sequential):
    """``nn.Sequential`` whose ``forward`` takes the spatial mesh: each 3D
    convolution runs on the slab with the halo it reads
    (``parallel/spatial.py``), a nested stack passes the mesh on, and the
    rest (BatchNorm, Mish) is per pixel.  ``mesh=None`` is the plain
    ``nn.Sequential``."""

    def forward(self, x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        for module in self:
            if isinstance(module, nn.ConvTranspose3d):
                with span("head.deconv"):
                    x = conv_transpose3d_rows(module, x, mesh)
            elif isinstance(module, nn.Conv3d):
                x = conv3d_rows(module, x, mesh)
            elif isinstance(module, _Stack):
                x = module(x, mesh)
            else:
                x = module(x)
        return x


class ConvBN3d(_Stack):
    """Conv3d without bias + BatchNorm3d (``evidential.py:41``)."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1):
        super().__init__(
            nn.Conv3d(in_c, out_c, kernel, stride=stride, padding=pad, bias=False),
            FlaxBatchNorm3d(out_c),
        )


def conv3d_stride2(in_c: int, out_c: int) -> nn.Conv3d:
    """Bare strided Conv3d, no BN or bias (``evidential.py:64``)."""
    return nn.Conv3d(in_c, out_c, 3, stride=2, padding=1, bias=False)


class Deconv3dBN(_Stack):
    """``ConvTranspose3d(k3, s2, p1, output_padding 1)`` without bias + BN
    (``evidential.py:77``, which writes it as an input-dilated conv padded
    (1, 2))."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__(
            nn.ConvTranspose3d(in_c, out_c, 3, stride=2, padding=1, output_padding=1,
                               bias=False),
            FlaxBatchNorm3d(out_c),
        )


def _conv_mish(in_c: int, out_c: int, stride: int = 1) -> _Stack:
    return _Stack(ConvBN3d(in_c, out_c, stride=stride), nn.Mish())


class HourGlass(nn.Module):
    """Two-level 3D hourglass with skip redirections (``evidential.py:99``)."""

    def __init__(self, features: int = 32):
        super().__init__()
        f = features
        self.conv1 = _conv_mish(f, 2 * f, stride=2)
        self.conv2 = _conv_mish(2 * f, 2 * f)
        self.conv3 = _conv_mish(2 * f, 4 * f, stride=2)
        self.conv4 = _conv_mish(4 * f, 4 * f)
        self.conv5 = Deconv3dBN(4 * f, 2 * f)
        self.conv6 = Deconv3dBN(2 * f, f)
        self.redir1 = ConvBN3d(f, f, kernel=1, pad=0)
        self.redir2 = ConvBN3d(2 * f, 2 * f, kernel=1, pad=0)

    def forward(self, x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        conv2 = self.conv2(self.conv1(x, mesh), mesh)
        conv4 = self.conv4(self.conv3(conv2, mesh), mesh)
        conv5 = mish(self.conv5(conv4, mesh) + self.redir2(conv2, mesh))
        del conv2, conv4
        return mish(self.conv6(conv5, mesh) + self.redir1(x, mesh))


class HourGlassUp(nn.Module):
    """Hourglass that merges two lower-scale volumes on the way down
    (``evidential.py:123``); ``cat`` runs on the channel axis."""

    def __init__(self, features: int = 32):
        super().__init__()
        f = features
        self.conv1 = conv3d_stride2(f, 2 * f)
        self.combine1 = _conv_mish(2 * f + 32, 2 * f)
        self.conv2 = _conv_mish(2 * f, 2 * f)
        self.conv3 = conv3d_stride2(2 * f, 4 * f)
        self.combine2 = _conv_mish(4 * f + 32, 4 * f)
        self.conv4 = _conv_mish(4 * f, 4 * f)
        self.redir3 = ConvBN3d(4 * f, 4 * f, kernel=1, pad=0)
        self.conv8 = Deconv3dBN(4 * f, 2 * f)
        self.redir2 = ConvBN3d(2 * f, 2 * f, kernel=1, pad=0)
        self.conv9 = Deconv3dBN(2 * f, f)
        self.redir1 = ConvBN3d(f, f, kernel=1, pad=0)

    def forward(self, x: torch.Tensor, feat4: torch.Tensor, feat5: torch.Tensor,
                mesh: Mesh | None = None) -> torch.Tensor:
        conv1 = self.combine1(torch.cat([conv3d_rows(self.conv1, x, mesh), feat4], dim=1), mesh)
        conv2 = self.conv2(conv1, mesh)
        del conv1
        conv3 = self.combine2(torch.cat([conv3d_rows(self.conv3, conv2, mesh), feat5], dim=1),
                              mesh)
        conv4 = self.conv4(conv3, mesh)
        del conv3
        conv7 = mish(self.redir3(conv4, mesh))
        del conv4
        conv8 = mish(self.conv8(conv7, mesh) + self.redir2(conv2, mesh))
        del conv2, conv7
        return mish(self.conv9(conv8, mesh) + self.redir1(x, mesh))


def moe_nig(u1, la1, a1, b1, u2, la2, a2, b2):
    """Mixture of two NIG estimates, Eq. 9 (``evidential.py:154``)."""
    la = la1 + la2
    u = (la1 * u1 + la2 * u2) / la
    alpha = a1 + a2 + 0.5
    beta = b1 + b2 + 0.5 * (la1 * (u1 - u) ** 2 + la2 * (u2 - u) ** 2)
    return u, la, alpha, beta


def _classifier() -> _Stack:
    return _Stack(ConvBN3d(32, 32), nn.Mish(), nn.Conv3d(32, 4, 3, padding=1, bias=False))


class EvidentialHead(nn.Module):
    """NIG parameter head over the probability volume
    (``evidential.py:163``), 4,311,328 parameters and BN statistics.

    ``forward(prob_volume (B, D, H, W), depth_values (B, D))`` returns
    ``gamma``, ``nu``, ``alpha`` and ``beta``, each ``(B, H, W)``, and the
    three scales' mean probability volume ``prob_combine`` ``(B, maxdisp, H,
    W)``.  H and W must be divisible by 4.  With a spatial ``mesh``
    (``parallel/mesh.py``) ``prob_volume`` is this rank's slab of rows, and
    so are the outputs; the slab's rows, H / S, must be divisible by 4.  A
    fresh head draws the JAX package's ``init_evidential`` distributions
    (:func:`.init.init_like_jax`) from ``generator``, else from torch's
    global generator.
    """

    def __init__(self, maxdisp: int = 32, generator: torch.Generator | None = None):
        super().__init__()
        self.maxdisp = maxdisp
        self.dres0 = _Stack(ConvBN3d(1, 32), nn.Mish(), ConvBN3d(32, 32), nn.Mish())
        self.dres1 = _Stack(ConvBN3d(32, 32), nn.Mish(), ConvBN3d(32, 32), nn.Mish())
        self.conv_vol2 = _Stack(ConvBN3d(1, 32), nn.Mish(), ConvBN3d(32, 32))
        self.conv_vol3 = _Stack(ConvBN3d(1, 32), nn.Mish(), ConvBN3d(32, 32))
        self.combine1 = HourGlassUp(32)
        self.dres2 = HourGlass(32)
        self.dres3 = HourGlass(32)
        self.classif0 = _classifier()
        self.classif1 = _classifier()
        self.classif2 = _classifier()
        init_like_jax(self, generator)

    def forward(self, prob_volume: torch.Tensor, depth_values: torch.Tensor,
                mesh: Mesh | None = None) -> dict:
        B, D, h, W = prob_volume.shape  # h: the slab's rows on a mesh
        M = self.maxdisp
        S = 1 if mesh is None else mesh.shape["spatial"]
        if h % 4 or W % 4:
            raise ValueError(f"the evidential head needs H / S and W divisible by 4, got "
                             f"H={h * S}, W={W} on a spatial axis of S={S}")
        x = prob_volume[:, None]  # (B, 1, D, h, W)

        with span("evidential.volumes"):
            vol1 = torch.softmax(_resize(x, M, h * S, W, mesh), dim=2)
            vol2 = torch.softmax(_resize(x, M // 2, h * S // 2, W // 2, mesh), dim=2)
            # The reference softmaxes its third volume over the (size-1)
            # batch axis, which makes it all ones; kept as the JAX package
            # keeps it.  On a mesh its halo rows are the neighbours' ones
            # (zeros past the map's edges), as the whole map's padding.
            vol3 = x.new_ones(B, 1, M // 4, h // 4, W // 4)

        with span("evidential.dres"):
            cost0 = self.dres0(vol1, mesh)
            del vol1
            cost0 = self.dres1(cost0, mesh) + cost0
            v2 = self.conv_vol2(vol2, mesh)
            v3 = self.conv_vol3(vol3, mesh)
            del vol2, vol3

        with span("evidential.hourglass_up"):
            combine = self.combine1(cost0, v2, v3, mesh)
            del v2, v3
        with span("evidential.hourglass"):
            out1 = self.dres2(combine, mesh)
            del combine
            out2 = self.dres3(out1, mesh)

        # Depth hypotheses resampled onto the maxdisp grid (the identity
        # when D == maxdisp).
        interp = torch.from_numpy(interp_matrix(D, M)).to(depth_values.device)
        dvals = depth_values.float() @ interp.T  # (B, M)

        def classify(classif, feat):
            cost, logla, logalpha, logbeta = classif(feat, mesh).unbind(1)  # (B, M, H, W) each
            prob = torch.softmax(cost, dim=1)
            pred = torch.sum(prob * dvals[:, :, None, None], dim=1)
            la = F.softplus(torch.sum(logla * prob, dim=1))
            alpha = F.softplus(torch.sum(logalpha * prob, dim=1)) + 1.0
            beta = F.softplus(torch.sum(logbeta * prob, dim=1))
            return (pred, la, alpha, beta), prob

        with span("evidential.classify"):
            est0, prob0 = classify(self.classif0, cost0)
            del cost0
            est1, prob1 = classify(self.classif1, out1)
            del out1
            est2, prob2 = classify(self.classif2, out2)
            del out2

            u, la, alpha, beta = moe_nig(*est0, *est1)
            u, la, alpha, beta = moe_nig(u, la, alpha, beta, *est2)
        return {
            "gamma": u,
            "nu": la,
            "alpha": alpha,
            "beta": beta,
            "prob_combine": (prob0 + prob1 + prob2) / 3.0,
        }


def _resize(x: torch.Tensor, d: int, rows: int, w: int, mesh: Mesh | None) -> torch.Tensor:
    """The align-corners trilinear resize of the map whose slab is ``x``
    (NCDHW) to ``(d, rows, w)``, this rank's slab of it: one trilinear
    resize without a mesh; on a mesh D and W on the slab (its rows kept,
    which is exact), then the rows at their map indices (``resize_rows``)."""
    if mesh is None:
        return resize_trilinear_align_corners(x, d, rows, w)
    return resize_rows(resize_trilinear_align_corners(x, d, x.shape[-2], w), rows, mesh)


def evidential_apply(head: EvidentialHead, cost_volume: torch.Tensor,
                     depth_values: torch.Tensor, mesh: Mesh | None = None) -> dict:
    """The eval-mode head on a ``(B, D, H, W)`` cost volume
    (``make_evidential_apply``, ``evidential.py:246``): softmax over D in
    fp32, then :class:`EvidentialHead`, on this rank's slab of rows with a
    spatial ``mesh``.  Drops its own reference to ``cost_volume`` once the
    probability volume exists, so a caller that passes its last reference
    frees the volume."""
    prob = torch.softmax(cost_volume.float(), dim=1)
    del cost_volume
    return head(prob, depth_values, mesh)


def loss_emvsnet(gamma, nu, alpha, beta, depth_gt, mask,
                 weight_reg: float = 0.1, group=None, rows_group=None) -> torch.Tensor:
    """The fork's production loss (``evidential.py:263``): the masked mean
    of ``log(var) + (1 + weight_reg * nu) * err^2 / var`` with ``var = beta /
    nu``.  Masked pixels are selected away, not multiplied by 0, as JAX's
    ``where`` does: where ``beta / nu`` underflows their term is infinite,
    and a product would make the loss NaN.

    With a process ``group`` (data-parallel training) the mean is over the
    global batch: one sum divided by the valid pixels of every rank, so
    ranks whose masks differ are weighted as one batch would weight them.
    The returned value is this rank's term times the group's size, so that
    the ranks' mean, and the mean of their gradients, are the global
    loss's.  With a ``rows_group`` (the spatial group, whose ranks hold the
    rows of the maps) the valid pixels are counted over its ranks too, and
    the returned value is this rank's share: the shares, and their
    gradients, sum to the loss over the group."""
    valid = mask > 0.5
    err = gamma - depth_gt
    var = beta / nu
    per_px = torch.log(var) + (1.0 + weight_reg * nu) * err**2 / var
    total = torch.where(valid, per_px, 0.0).sum()
    if group is None and rows_group is None:
        return total / valid.sum().clamp(min=1)
    count = valid.sum().to(total.dtype)
    for g in (rows_group, group):
        if g is not None:
            dist.all_reduce(count, group=g)
    size = 1 if group is None else dist.get_world_size(group)
    return total * size / count.clamp(min=1)


def nig_nll_loss(gamma, nu, alpha, beta, depth_gt, mask,
                 weight_reg: float = 0.1) -> torch.Tensor:
    """The full NIG negative log-likelihood plus the |err|-scaled evidence
    regulariser, masked means (``evidential.py:273``)."""
    valid = mask > 0.5
    om = 2.0 * beta * (1.0 + nu)
    err = gamma - depth_gt
    nll = (
        0.5 * torch.log(math.pi / nu)
        - alpha * torch.log(om)
        + (alpha + 0.5) * torch.log(nu * err**2 + om)
        + torch.lgamma(alpha)
        - torch.lgamma(alpha + 0.5)
    )
    reg = torch.abs(err) * (2.0 * nu + alpha)
    count = valid.sum().clamp(min=1)
    return (torch.where(valid, nll, 0.0).sum() / count
            + weight_reg * torch.where(valid, reg, 0.0).sum() / count)


def uncertainty_decompositions(nu, alpha, beta) -> dict:
    """Both decompositions the reference derives (``evidential.py:294``)."""
    return {
        "aleatoric_1": torch.sqrt(beta * (nu + 1.0) / nu / alpha),
        "epistemic_1": 1.0 / torch.sqrt(nu),
        "aleatoric_2": beta / (alpha - 1.0),
        "epistemic_2": beta / (alpha - 1.0) / nu,
    }
