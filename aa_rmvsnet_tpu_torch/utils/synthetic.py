"""Seeded synthetic inputs for runs without a dataset or a checkpoint.

:func:`plane_scene` builds, in memory with numpy and scipy, the sample
dicts that ``EvalDataset.__getitem__`` returns for a textured
fronto-parallel plane seen by cameras translating along x (the geometry of
``tests/scenefix.py:make_plane_scene``, without cv2 or files).
:func:`seeded_model` gives the full-width core random weights from a seed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.transforms import standardize_image
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
    K = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]],
                 np.float32)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    imgs, projs = [], []
    for v in range(n_cams):
        shift = focal * baseline * v / plane_depth
        img = np.stack([
            map_coordinates(texture[..., ch], [ys, xs + shift], order=1)
            for ch in range(3)
        ], axis=-1)
        imgs.append(standardize_image(img, eps=0.0))
        P = np.eye(4, dtype=np.float32)
        P[0, 3] = -v * baseline  # world -> camera: the camera sits at +v*b
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
