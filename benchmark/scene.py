"""The traffic generator: distinct textured-plane scenes from a seed.

One scene is what the port's eval loader (``EvalDataset``) or training
loader (``DTUTrainDataset``) hands over for one reference view: ``V``
standardized images of a fronto-parallel textured plane, their projection
matrices (reference first, then the sources nearest first) and the depth
hypotheses; a training scene adds the ground-truth depth (the plane's, at
every pixel) and its mask.  Every scene draws its own texture, plane depth
and reference camera from one generator seeded with the run's seed, so a
seed fixes every input of a run, and two seeds give the same sizes and
the same amount of work.

The cameras sit on a line along x, ``baseline`` apart, focal length
``focal`` px, principal point at the image centre; the reference is
camera ``r`` of the ``V`` and its sources are the others, nearest first
(the lower one of a tie).  Camera ``k`` sees the plane at depth ``z`` as
the texture shifted by ``k * baseline * focal / z`` px, sampled linearly.
The texture is uniform noise in [0, 255] smoothed by a Gaussian of
``texture_sigma`` px (reflected at its edges), one per colour channel.
Images are standardized per channel over the pixels (eps 0), as the eval
loader does.

The parameters come from the cell's traffic (``benchmark/workloads/``) and
the configuration's geometry (``benchmark/configs/``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian(sigma: float, device) -> torch.Tensor:
    radius = int(4.0 * sigma + 0.5)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    return k / k.sum()


def textures(n: int, height: int, width: int, sigma: float, gen: torch.Generator,
             device) -> torch.Tensor:
    """``(n, 3, height, width)`` smoothed noise textures in [0, 255]."""
    noise = torch.rand(n * 3, 1, height, width, generator=gen, device=device) * 255.0
    k = _gaussian(sigma, device)
    r = k.numel() // 2
    x = F.conv2d(F.pad(noise, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))
    return x.view(n, 3, height, width)


def projection(focal: float, height: int, width: int, camera_x: float) -> np.ndarray:
    K = np.array([[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[0, 3] = -camera_x
    P = E.copy()
    P[:3, :4] = K @ E[:3, :4]
    return P


def sources(ref: int, views: int) -> list[int]:
    return sorted((v for v in range(views) if v != ref), key=lambda v: (abs(v - ref), v))


def scenes(n: int, seed: int, geometry: dict, traffic: dict, device,
           train: bool = False) -> list[dict]:
    """``n`` distinct scenes as numpy sample dicts (``imgs`` ``(V, H, W,
    3)``, ``proj_matrices`` ``(V, 4, 4)``, ``depth_values`` ``(D,)``, and
    for training ``depth`` and ``mask`` ``(H, W)`` and ``depth_interval``).

    ``geometry``: ``height``, ``width``, ``views``, ``num_depth``,
    ``depth_min``, ``depth_interval``; ``traffic``: ``focal``, ``baseline``,
    ``plane_depth`` (the ``[low, high]`` range a scene's depth is drawn
    from) and ``texture_sigma``.  Made on ``device`` in chunks, returned on
    the host."""
    H, W, V = geometry["height"], geometry["width"], geometry["views"]
    D = geometry["num_depth"]
    dmin, step = float(geometry["depth_min"]), float(geometry["depth_interval"])
    focal, baseline = float(traffic["focal"]), float(traffic["baseline"])
    low, high = (float(v) for v in traffic["plane_depth"])
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.rand(n, 2, generator=gen, device=device, dtype=torch.float64).cpu().numpy()
    depths = low + (high - low) * draws[:, 0]
    refs = np.minimum((draws[:, 1] * V).astype(int), V - 1)
    max_shift = (V - 1) * baseline * focal / low
    tex_w = W + int(math.ceil(max_shift)) + 2
    if train:
        hyps = np.linspace(dmin, dmin + (D - 1) * step, D).astype(np.float32)
    else:
        hyps = (dmin + step * np.arange(D)).astype(np.float32)
    out = []
    chunk = max(1, int(2**28 // (3 * H * tex_w * 4 * V)))
    cols = torch.arange(W, device=device, dtype=torch.float64)
    for first in range(0, n, chunk):
        count = min(chunk, n - first)
        tex = textures(count, H, tex_w, float(traffic["texture_sigma"]), gen, device)
        for j in range(count):
            i = first + j
            z, ref = float(depths[i]), int(refs[i])
            order = [ref] + sources(ref, V)
            imgs = []
            for k in order:
                pos = cols + k * baseline * focal / z
                x0 = torch.floor(pos)
                frac = (pos - x0).float()
                x0 = x0.long()
                img = tex[j][:, :, x0] * (1.0 - frac) + tex[j][:, :, x0 + 1] * frac  # (3, H, W)
                mean = img.mean(dim=(1, 2), keepdim=True)
                std = img.var(dim=(1, 2), keepdim=True, unbiased=False).sqrt()
                imgs.append(((img - mean) / std).permute(1, 2, 0))
            sample = {
                "imgs": torch.stack(imgs).cpu().numpy(),
                "proj_matrices": np.stack([projection(focal, H, W, k * baseline)
                                           for k in order]),
                "depth_values": hyps,
            }
            if train:
                sample["depth"] = np.full((H, W), z, np.float32)
                sample["mask"] = np.ones((H, W), np.float32)
                sample["depth_interval"] = np.float32(step)
            else:
                sample.update(scan=f"scene{i}", ref_view=i)
            out.append(sample)
    return out
