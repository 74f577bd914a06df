"""Seeded synthetic inputs for runs without a dataset or a checkpoint.

:func:`plane_scene` builds, in memory with numpy and scipy, the sample
dicts that ``EvalDataset.__getitem__`` returns for a textured
fronto-parallel plane seen by cameras translating along x (the geometry of
``tests/scenefix.py:make_plane_scene``, without cv2 or files; the
cameras are :func:`plane_cameras`), and
:func:`plane_train_sample` the ``DTUTrainDataset`` sample of that plane,
its ground truth the plane's depth.
:func:`seeded_model` gives the full-width core random weights from a seed,
and :func:`matching_model` the same with a regularizer that passes the
photometric cost through, a stand-in for a trained network.
:func:`seeded_head` gives the evidential head random weights from a seed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.samplers import linear_depth_train
from ..core.transforms import standardize_image
from ..models.evidential import EvidentialHead
from ..models.network import AARMVSNetCore


def seeded_model(seed: int) -> AARMVSNetCore:
    """The full-width core with random weights from ``seed``: He-normal
    conv kernels and zero conv biases (GroupNorm keeps weight 1, bias 0).

    PyTorch's default init leaves a pixel's regularized costs so close
    together that nearly every depth would be a near-tie; He init spreads
    them as a trained network's are spread.  The deformable convs'
    offset / modulation kernels (zero-initialised in the reference) get
    noise of sigma 0.1 so the deformable sampling does real work.
    """
    model = AARMVSNetCore()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                continue
            w = mod.weight
            if name.endswith(("p_conv", "m_conv")):
                std = 0.1
            else:
                fan_in = w.shape[0 if isinstance(mod, nn.ConvTranspose2d) else 1]
                std = (2.0 / (fan_in * w.shape[2] * w.shape[3])) ** 0.5
            w.copy_(std * torch.randn(w.shape, generator=gen))
            mod.bias.zero_()
    return model.eval()


def seeded_head(seed: int) -> EvidentialHead:
    """The evidential head with random weights from ``seed``: the JAX
    package's init (lecun-normal kernels), then BatchNorm scales ~ N(1,
    0.1), biases ~ N(0, 0.1), running means ~ N(0, 0.1) and variances ~
    U(0.5, 1.5), so that every BN does work.  Eval mode."""
    gen = torch.Generator().manual_seed(seed)
    head = EvidentialHead(generator=gen)
    with torch.no_grad():
        for mod in head.modules():
            if isinstance(mod, nn.BatchNorm3d):
                c = mod.num_features
                mod.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return head.eval()


def matching_model(seed: int, gain: float = 0.02, sharpness: float = 20.0) -> AARMVSNetCore:
    """:func:`seeded_model` with the ConvLSTM U-Net replaced by a plane
    sweep's winner-take-all on the reweighted variance: cell 0's first
    hidden channel holds ``tanh(gain * sum of the 32 cost channels)`` (input
    and output gates open, forget gate shut, by biases of +-8), cell 4's
    first channel passes it on the same way, and the output conv averages
    it over 3x3 pixels times ``sharpness``; every other regularizer weight
    is zero.  FeatNet and omega keep their He-normal weights.

    With random weights a pixel's costs are nearly flat across depth, so
    any rounding moves its winner far: that measures ties, not precision.
    This network's costs peak at the photometric match, as a trained
    one's do, and its confidence is high where the match is clear, which
    is what the JAX package's bf16 guardrail assumes of its weights.
    ``gain`` keeps the sum of squared residuals of unit-variance features
    (~64 at a wrong depth) inside tanh's slope.
    """
    model = seeded_model(seed)
    reg = model.cost_regularization
    with torch.no_grad():
        for param in reg.parameters():
            param.zero_()
        for cell, g_inputs in ((reg.cell_list[0], slice(0, 32)), (reg.cell_list[4], slice(16, 17))):
            hidden = cell.conv.out_channels // 4
            bias = cell.conv.bias
            bias[0], bias[hidden], bias[2 * hidden] = 8.0, -8.0, 8.0  # i, f, o of channel 0
            weight = gain if cell is reg.cell_list[0] else 2.0
            cell.conv.weight[3 * hidden, g_inputs, 1, 1] = weight  # g of channel 0
        reg.conv_0.weight[0, 0] = sharpness / 9.0
    return model


def plane_cameras(height: int, width: int, n_cams: int, focal: float,
                  baseline: float) -> list[tuple[np.ndarray, np.ndarray]]:
    """``(K, E)`` float32 of ``n_cams`` cameras translating along x by
    ``baseline``, principal point at the image centre: camera ``v`` sits at
    ``x = v * baseline`` (``E`` is world to camera)."""
    K = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]],
                 np.float32)
    cams = []
    for v in range(n_cams):
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = -v * baseline
        cams.append((K, E))
    return cams


def plane_scene(height: int, width: int, views: int, num_depth: int, maps: int,
                seed: int, focal: float, baseline: float, plane_depth: float,
                depth_min: float, depth_interval: float) -> list[dict]:
    """``maps`` eval samples of a textured fronto-parallel plane at
    ``plane_depth``, seen by ``maps + views - 1`` cameras translating along
    x by ``baseline``; sample ``r`` has reference camera ``r`` and the
    ``views - 1`` nearest others as sources.  Depth hypotheses are
    ``depth_min + depth_interval * arange(num_depth)``.
    """
    from scipy.ndimage import gaussian_filter, map_coordinates

    n_cams = maps + views - 1
    rng = np.random.RandomState(seed)
    max_shift = focal * baseline * n_cams / plane_depth
    tex_w = width + int(np.ceil(max_shift)) + 8
    texture = gaussian_filter(
        rng.rand(height, tex_w, 3).astype(np.float32) * 255.0, sigma=(2.0, 2.0, 0.0))
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    imgs, projs = [], []
    for v, (K, E) in enumerate(plane_cameras(height, width, n_cams, focal, baseline)):
        shift = focal * baseline * v / plane_depth
        img = np.stack([
            map_coordinates(texture[..., ch], [ys, xs + shift], order=1)
            for ch in range(3)
        ], axis=-1)
        imgs.append(standardize_image(img, eps=0.0))
        P = E.copy()
        P[:3, :4] = K @ P[:3, :4]
        projs.append(P)
    depths = (depth_min + depth_interval * np.arange(num_depth)).astype(np.float32)
    samples = []
    for ref in range(maps):
        others = sorted((v for v in range(n_cams) if v != ref), key=lambda v: abs(v - ref))
        chosen = [ref] + others[: views - 1]
        samples.append({
            "imgs": np.stack([imgs[v] for v in chosen]).astype(np.float32),
            "proj_matrices": np.stack([projs[v] for v in chosen]),
            "depth_values": depths,
            "filename": "scan1/{}/" + f"{ref:08d}" + "{}",
            "scan": "scan1",
            "ref_view": ref,
        })
    return samples


def plane_train_sample(height: int, width: int, views: int, num_depth: int,
                       seed: int, focal: float, baseline: float,
                       plane_depth: float, depth_min: float,
                       depth_interval: float) -> dict:
    """The ``DTUTrainDataset.__getitem__`` sample dict (imgs, proj_matrices,
    depth_values, depth, mask, depth_interval, name) of the textured plane
    of :func:`plane_scene`, seen from its first camera: the ground-truth
    depth is ``plane_depth`` at every pixel and the mask is all ones."""
    (scene,) = plane_scene(height, width, views, num_depth, maps=1, seed=seed,
                           focal=focal, baseline=baseline, plane_depth=plane_depth,
                           depth_min=depth_min, depth_interval=depth_interval)
    return {
        "imgs": scene["imgs"],
        "proj_matrices": scene["proj_matrices"],
        "depth_values": linear_depth_train(depth_min, depth_interval, num_depth),
        "depth": np.full((height, width), plane_depth, np.float32),
        "mask": np.ones((height, width), np.float32),
        "depth_interval": np.float32(depth_interval),
        "name": "scan1/0/0",
    }
