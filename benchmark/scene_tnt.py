"""The traffic generator of the Tanks and Temples cells: distinct
textured-plane scenes from a seed, as the padded eval loader hands them
over.

One scene is what the port's ``EvalDataset(pad_vertical=True)`` (the
fork's ``data_eval_transform_padding.py``) makes of a scene directory for
one reference view: the frames of the reference and of the sources that
``select_views_both_ends`` takes from its pair list, each zero-padded by 4
rows above and below, standardized (eps 0), down-scaled adaptively to fit
``max_h x max_w`` and centre-cropped to a multiple of 8; the cameras with
the principal point moved down by the 4 padded rows, then scaled and
cropped with the images; and bounded inverse-depth hypotheses between the
reference camera's ``depth_min`` and ``depth_end``.  :func:`sample` runs
those steps with the port's own functions on frames and cameras held in
memory, so a scene written to disk reads back through ``EvalDataset`` as
the same sample.

The cameras sit on a line along x, ``baseline`` apart, focal length
``focal`` px, principal point at the frame's centre: camera ``c`` of
``2 * neighbours + 1`` sits at ``(c - neighbours) * baseline``, and the
reference is the middle one.  Its pair list is the ``2 * neighbours``
others nearest first, the one below before the one above.  A frame of the
fronto-parallel plane at depth ``z`` is its texture shifted by the
camera's position times ``focal / z`` px, sampled linearly; the texture is
``benchmark/scene.py``'s smoothed noise in [0, 255].  Every scene draws its
plane depth and its texture from one generator seeded with the run's
seed.

The parameters come from the cell's traffic (``benchmark/workloads/``) and
the configuration's geometry (``benchmark/configs/``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scene import textures


def pair_list(ref: int, neighbours: int) -> list[int]:
    """The reference camera's sources, nearest first, the lower of a tie
    first: ``ref - 1, ref + 1, ref - 2, ...``."""
    return [ref + sign * k for k in range(1, neighbours + 1) for sign in (-1, 1)]


def camera(focal: float, frame_h: int, frame_w: int, x: float) -> tuple[np.ndarray, np.ndarray]:
    """Intrinsics and world-to-camera extrinsics, float32 as a cam file
    reads, of a camera at ``(x, 0, 0)`` looking down z."""
    K = np.array([[focal, 0.0, frame_w / 2.0], [0.0, focal, frame_h / 2.0], [0.0, 0.0, 1.0]],
                 np.float32)
    E = np.eye(4, dtype=np.float32)
    E[0, 3] = -x
    return K, E


def frames(texture: torch.Tensor, shifts: dict, frame_w: int) -> dict[int, np.ndarray]:
    """Camera -> its ``(frame_h, frame_w, 3)`` float32 frame: ``texture``
    ``(3, frame_h, tex_w)`` read from column ``shifts[camera]`` on."""
    cols = torch.arange(frame_w, device=texture.device, dtype=torch.float64)
    out = {}
    for cam, shift in shifts.items():
        pos = cols + shift
        x0 = torch.floor(pos)
        frac = (pos - x0).float()
        x0 = x0.long()
        img = texture[:, :, x0] * (1.0 - frac) + texture[:, :, x0 + 1] * frac
        out[cam] = img.permute(1, 2, 0).cpu().numpy()
    return out


def sample(frames_by_camera: dict, cameras: dict, ref: int, sources: list[int],
           depth_min: float, depth_end: float, geometry: dict) -> dict:
    """``EvalDataset(pad_vertical=True)``'s sample of reference ``ref`` with
    the scored source list ``sources``: ``imgs`` ``(V, H, W, 3)``,
    ``proj_matrices`` ``(V, 4, 4)`` and ``depth_values`` ``(D,)``.
    ``frames_by_camera``: camera -> RGB frame as float32; ``cameras``:
    camera -> ``(K, E)`` as the cam file holds them."""
    from aa_rmvsnet_tpu_torch.core.cameras import (crop_intrinsics, scale_intrinsics,
                                                   select_views_both_ends)
    from aa_rmvsnet_tpu_torch.core.samplers import inverse_depth_bounded
    from aa_rmvsnet_tpu_torch.core.transforms import (adaptive_scale_factor,
                                                      center_crop_to_multiple, pad_rows,
                                                      scale_image, standardize_image)

    top, bottom = geometry["pad_rows"]
    views = select_views_both_ends(ref, sources, min(geometry["views"], len(sources) + 1))
    imgs, intrinsics = [], []
    for vid in views:
        imgs.append(standardize_image(pad_rows(frames_by_camera[vid], top, bottom), eps=0.0))
        K = cameras[vid][0].copy()
        K[1, 2] += float(top)
        intrinsics.append(K)
    max_h, max_w = geometry["height"], geometry["width"]
    scale = adaptive_scale_factor([im.shape[:2] for im in imgs], max_h, max_w)
    out_imgs, out_projs = [], []
    for img, K, vid in zip(imgs, intrinsics, views):
        if scale != 1.0:
            img = scale_image(img, scale)
            K = scale_intrinsics(K, scale)
        img, start_h, start_w = center_crop_to_multiple(img, max_h, max_w, 8)
        K = crop_intrinsics(K, start_w, start_h)
        proj = cameras[vid][1].copy()
        proj[:3, :4] = K @ proj[:3, :4]
        out_imgs.append(img)
        out_projs.append(proj)
    return {
        "imgs": np.stack(out_imgs).astype(np.float32),
        "proj_matrices": np.stack(out_projs).astype(np.float32),
        "depth_values": inverse_depth_bounded(depth_min, depth_end, geometry["num_depth"]),
    }


def scenes(n: int, seed: int, geometry: dict, traffic: dict, device) -> list[dict]:
    """``n`` distinct scenes as numpy sample dicts with ``scan`` and
    ``ref_view``.

    ``geometry``: ``frame`` (the source frames' ``[height, width]``),
    ``pad_rows``, ``height`` and ``width`` (the loader's ``max_h`` and
    ``max_w``), ``views``, ``num_depth``; ``traffic``: ``focal``,
    ``baseline``, ``neighbours``, ``plane_depth`` (the ``[low, high]``
    range a scene's depth is drawn from), ``depth_min``, ``depth_end`` and
    ``texture_sigma``.  Textures and frames are made on ``device``, the
    loader's steps run on the host."""
    from aa_rmvsnet_tpu_torch.core.cameras import select_views_both_ends

    frame_h, frame_w = geometry["frame"]
    focal, baseline = float(traffic["focal"]), float(traffic["baseline"])
    neighbours = int(traffic["neighbours"])
    low, high = (float(v) for v in traffic["plane_depth"])
    ref = neighbours
    sources = pair_list(ref, neighbours)
    cameras = {c: camera(focal, frame_h, frame_w, (c - ref) * baseline)
               for c in [ref] + sources}
    # The loader reads the frames of the views it selects alone.
    used = select_views_both_ends(ref, sources, min(geometry["views"], len(sources) + 1))
    margin = int(math.ceil(neighbours * baseline * focal / low)) + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    depths = low + (high - low) * torch.rand(n, generator=gen, device=device,
                                             dtype=torch.float64).cpu().numpy()
    out = []
    for i in range(n):
        z = float(depths[i])
        texture = textures(1, frame_h, frame_w + 2 * margin, float(traffic["texture_sigma"]),
                           gen, device)[0]
        shifts = {c: margin + (c - ref) * baseline * focal / z for c in used}
        s = sample(frames(texture, shifts, frame_w), cameras, ref, sources,
                   float(traffic["depth_min"]), float(traffic["depth_end"]), geometry)
        out.append(dict(s, scan=f"scene{i}", ref_view=i))
    return out
