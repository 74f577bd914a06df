"""Seeded synthetic inputs for runs without a dataset or a checkpoint.

:func:`plane_scene` builds, in memory with numpy and scipy, the sample
dicts that ``EvalDataset.__getitem__`` returns for a textured
fronto-parallel plane seen by cameras translating along x (the geometry of
``tests/scenefix.py:make_plane_scene``, without cv2 or files; the
cameras are :func:`plane_cameras`, the images :func:`plane_views` and the
sources :func:`plane_sources`), and
:func:`plane_train_sample` the ``DTUTrainDataset`` sample of that plane,
its ground truth the plane's depth.
:func:`seeded_model` gives the full-width core random weights from a seed,
and :func:`matching_model` the same with a regularizer that passes the
photometric cost through, a stand-in for a trained network.
:func:`seeded_head` gives the evidential head random weights from a seed.
:func:`fusion_plane_views` gives the fusion kernel the views of a noisy
plane, :func:`fusion_edge_case` inputs that reach every branch of its
arithmetic, :func:`fusion_scan` a scan of such views for
``pipeline/fuse.py:fuse_views``, and :func:`division_operands` operands
for its division.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.samplers import linear_depth_train
from ..core.transforms import standardize_image
from ..models.evidential import EvidentialHead
from ..models.network import AARMVSNetCore
from ..ops.fusion import pair_matrices


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


def seeded_head(seed: int, maxdisp: int = 32) -> EvidentialHead:
    """The evidential head with random weights from ``seed``: the JAX
    package's init (lecun-normal kernels), then BatchNorm scales ~ N(1,
    0.1), biases ~ N(0, 0.1), running means ~ N(0, 0.1) and variances ~
    U(0.5, 1.5), so that every BN does work.  Eval mode."""
    gen = torch.Generator().manual_seed(seed)
    head = EvidentialHead(maxdisp, generator=gen)
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


def fusion_plane_views(height: int, width: int, num_src: int, focal: float, baseline: float,
                       plane: float, noise: float, seed: int, device="cuda"):
    """Inputs of ``ops/fusion.py:fuse_ref`` on ``device``: ``num_src + 1``
    views of a plane at ``plane`` + N(0, ``noise``^2) (``torch.randn`` from
    a generator on ``device`` seeded with ``seed``) seen by
    :func:`plane_cameras`, the middle view the reference and the others its
    sources, nearest first.

    Returns ``(depths, ref, src_index, mats)`` as ``fuse_ref`` takes them.
    """
    cams = plane_cameras(height, width, num_src + 1, focal, baseline)
    gen = torch.Generator(device=device).manual_seed(seed)
    depths = (plane + noise * torch.randn(num_src + 1, height, width, device=device,
                                          generator=gen)).contiguous()
    ref = num_src // 2
    (_, srcs), = nearest_pairs(range(num_src + 1), num_src)[ref:ref + 1]
    mats = torch.from_numpy(np.stack([pair_matrices(*cams[ref], *cams[s]) for s in srcs]))
    return depths, ref, torch.tensor(srcs, dtype=torch.int32, device=device), mats.to(device)


def nearest_pairs(views, num_src: int) -> list[tuple[int, list[int]]]:
    """``[(ref, srcs)]``: each view with its ``num_src`` nearest others as
    sources, nearest (then lowest) first."""
    return [(r, sorted((v for v in views if v != r), key=lambda v: (abs(v - r), v))[:num_src])
            for r in views]


def fusion_scan(views: int, num_src: int, height: int, width: int, image_height: int,
                image_width: int, focal: float, baseline: float, plane: float, noise: float,
                seed: int, device="cuda"):
    """A scan for ``fuse_views`` on ``device``: ``views`` depth maps of a
    plane at ``plane`` + N(0, ``noise``^2) at ``height`` x ``width``,
    confidences uniform in [0, 1) and uint8 RGB images at ``image_height`` x
    ``image_width`` (drawn in that order from a generator on ``device``
    seeded with ``seed``), the cameras :func:`plane_cameras` with intrinsics
    at the images' size, and :func:`nearest_pairs`.

    Returns ``(depths, confidences, images, cams, pairs)``, the maps as
    ``{view: tensor}``.
    """
    cams = {}
    for v, (K, E) in enumerate(plane_cameras(height, width, views, focal, baseline)):
        K_img = K.copy()
        K_img[:2] /= np.float32(height / image_height)
        cams[v] = (K_img, E)
    gen = torch.Generator(device=device).manual_seed(seed)
    depths = plane + noise * torch.randn(views, height, width, device=device, generator=gen)
    confs = torch.rand(views, height, width, device=device, generator=gen)
    images = torch.randint(0, 256, (views, image_height, image_width, 3), device=device,
                           dtype=torch.uint8, generator=gen)
    return (dict(enumerate(depths)), dict(enumerate(confs)), dict(enumerate(images)), cams,
            nearest_pairs(range(views), num_src))


def division_operands(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` float64 dividend and divisor pairs: a third random bit patterns
    (every exponent, subnormals, infinities and NaNs), a third magnitudes
    log-uniform in [1e-6, 1e6] with random signs (the fusion's
    coordinates and depths), and a third at the edges of a division's fast
    range (magnitudes from 2^-1074 to 2^1023, zeros, infinities, NaNs, and
    quotients that land on whole numbers and on halfway points)."""
    rng = np.random.RandomState(seed)
    third = n // 3
    bits = rng.randint(-2**63, 2**63 - 1, size=(2, third), dtype=np.int64).view(np.float64)
    signs = rng.choice([-1.0, 1.0], size=(2, third))
    typical = signs * 10.0 ** rng.uniform(-6, 6, size=(2, third))
    rest = n - 2 * third
    edges = np.ldexp(rng.uniform(1, 2, size=(2, rest)), rng.randint(-1075, 1024, size=(2, rest)))
    edges *= rng.choice([-1.0, 1.0], size=(2, rest))
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, 2.0**-1022, 2.0**1023])
    pick = rng.randint(0, len(special), size=(2, rest))
    where = rng.rand(2, rest) < 0.05
    edges[where] = special[pick[where]]
    exact = rng.rand(rest) < 0.1  # a = c * k, k a whole number or a half
    k = rng.randint(-1000, 1000, size=rest) / rng.choice([1.0, 2.0], size=rest)
    with np.errstate(over="ignore", invalid="ignore"):
        edges[0, exact] = edges[1, exact] * k[exact]
    a, c = np.concatenate([bits, typical, edges], axis=1)
    return np.ascontiguousarray(a), np.ascontiguousarray(c)


def fusion_edge_case(height: int, width: int, num_src: int, seed: int):
    """Inputs of ``ops/fusion.py:fuse_ref`` that reach every branch of its
    arithmetic: a reference view (0) and five source views of a plane at
    500 + N(0, 1.5^2), cameras of focal ``width`` 2 apart (every level's
    masks mixed) besides one 0.4 of the image away and one turned 0.2 rad
    about y (pixels project outside the image); in every map 2 % of the
    depths each 0, negative, NaN, +inf and -inf.  ``num_src`` sources cycle
    over the five views (a view repeats, with its matrices); every third
    source sees the reference through intrinsics whose principal point lies
    0.25 px to the right, so that the reference intrinsics change between
    sources.

    Returns ``(depths (6, height, width) float32, ref, srcs, mats
    (num_src, 60) float64)``, numpy.
    """
    rng = np.random.RandomState(seed)
    focal, plane = float(width), 500.0
    K = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]], np.float32)
    cams = []
    for v, (shift, turn) in enumerate([(0.0, 0.0), (2.0, 0.0), (-2.0, 0.0), (4.0, 0.0),
                                       (0.4 * plane, 0.0), (1.0, 0.2)]):
        E = np.eye(4, dtype=np.float32)
        c, s = np.cos(turn), np.sin(turn)
        E[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        E[0, 3] = -shift
        cams.append((K, E))
    depths = (plane + 1.5 * rng.randn(len(cams), height, width)).astype(np.float32)
    special = rng.randint(0, 50, size=depths.shape)
    depths[special == 0] = 0.0
    depths[special == 1] *= -1.0
    depths[special == 2] = np.nan
    depths[special == 3] = np.inf
    depths[special == 4] = -np.inf
    srcs = [1 + i % (len(cams) - 1) for i in range(num_src)]
    K_moved = K.copy()
    K_moved[0, 2] += 0.25
    mats = np.stack([pair_matrices(K_moved if i % 3 == 2 else K, cams[0][1], *cams[s])
                     for i, s in enumerate(srcs)])
    return depths, 0, srcs, mats


def plane_views(height: int, width: int, n_cams: int, seed: int, focal: float,
                baseline: float, plane_depth: float) -> list[np.ndarray]:
    """The ``(height, width, 3)`` float32 RGB images, in [0, 255], of a
    textured fronto-parallel plane at ``plane_depth`` seen by
    :func:`plane_cameras`' ``n_cams`` cameras."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.RandomState(seed)
    max_shift = focal * baseline * n_cams / plane_depth
    tex_w = width + int(np.ceil(max_shift)) + 8
    texture = gaussian_filter(
        rng.rand(height, tex_w, 3).astype(np.float32) * 255.0, sigma=(2.0, 2.0, 0.0))
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    imgs = []
    for v in range(n_cams):
        shift = focal * baseline * v / plane_depth
        imgs.append(np.stack([
            map_coordinates(texture[..., ch], [ys, xs + shift], order=1)
            for ch in range(3)
        ], axis=-1))
    return imgs


def plane_sources(ref: int, n_cams: int) -> list[int]:
    """Every camera but ``ref``, nearest first (the lower one of a tie)."""
    return sorted((v for v in range(n_cams) if v != ref), key=lambda v: abs(v - ref))


def plane_scene(height: int, width: int, views: int, num_depth: int, maps: int,
                seed: int, focal: float, baseline: float, plane_depth: float,
                depth_min: float, depth_interval: float) -> list[dict]:
    """``maps`` eval samples of :func:`plane_views`' plane, seen by ``maps +
    views - 1`` cameras translating along x by ``baseline``; sample ``r``
    has reference camera ``r`` and the ``views - 1`` nearest others as
    sources.  Depth hypotheses are ``depth_min + depth_interval *
    arange(num_depth)``.
    """
    n_cams = maps + views - 1
    imgs, projs = [], []
    raw = plane_views(height, width, n_cams, seed, focal, baseline, plane_depth)
    for img, (K, E) in zip(raw, plane_cameras(height, width, n_cams, focal, baseline)):
        imgs.append(standardize_image(img, eps=0.0))
        P = E.copy()
        P[:3, :4] = K @ P[:3, :4]
        projs.append(P)
    depths = (depth_min + depth_interval * np.arange(num_depth)).astype(np.float32)
    samples = []
    for ref in range(maps):
        chosen = [ref] + plane_sources(ref, n_cams)[: views - 1]
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
