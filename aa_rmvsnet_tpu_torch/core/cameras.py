"""MVSNet-format camera parsing and projection-matrix algebra (copy of
``aa_rmvsnet_tpu/core/cameras.py``).

File formats mirrored from the reference pipeline:

``*_cam.txt`` (reference: datasets/dtu_yao.py:64-79, data_eval_transform.py:57-69,
data_eval_transform_padding.py:60-81)::

    extrinsic
    <4x4 world->camera matrix on lines 1..4>
    <blank>
    intrinsic
    <3x3 K on lines 7..9>
    <blank>
    depth_min depth_interval [num_depth depth_end]

``pair.txt`` (reference: datasets/dtu_yao.py:42-46, fusion.py:59-68)::

    <num_viewpoints>
    <ref_view_id>
    <num_src> id0 score0 id1 score1 ...

The full projection matrix used by the plane-sweep warp is the 4x4
``[[K @ E[:3,:4]], [0,0,0,1]]`` (reference: dtu_yao.py:144-146).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CameraParams:
    """One view's calibration: intrinsics K (3x3) and extrinsics E (4x4 w2c)."""

    intrinsics: np.ndarray
    extrinsics: np.ndarray
    depth_min: float = 0.0
    depth_interval: float = 0.0
    depth_num: float | None = None
    depth_end: float | None = None

    def projection(self) -> np.ndarray:
        return projection_matrix(self.intrinsics, self.extrinsics)


def read_cam_file(
    path,
    interval_scale: float = 1.0,
    intrinsics_scale: float = 1.0,
    cy_offset: float = 0.0,
) -> CameraParams:
    """Parse an MVSNet ``*_cam.txt``.

    ``interval_scale`` multiplies the depth interval (reference CLI flag,
    dtu_yao.py:78).  ``intrinsics_scale`` rescales the first two K rows —
    the reference applies x2 / x4 for image_scale 0.5 / 1.0 on DTU training
    cameras calibrated at quarter resolution (dtu_yao.py:73-76).
    ``cy_offset`` shifts the principal point vertically (the padded TnT
    loader adds +4 for its 8-row pad, data_eval_transform_padding.py:69).
    """
    with open(path) as f:
        lines = [ln.rstrip() for ln in f.readlines()]

    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)

    if intrinsics_scale != 1.0:
        intrinsics[:2, :] *= intrinsics_scale
    if cy_offset:
        intrinsics[1, 2] += cy_offset

    tokens = lines[11].split()
    depth_min = float(tokens[0])
    depth_interval = float(tokens[1]) * interval_scale
    depth_num = float(tokens[2]) if len(tokens) > 2 else None
    depth_end = float(tokens[3]) if len(tokens) > 3 else None

    return CameraParams(
        intrinsics=intrinsics,
        extrinsics=extrinsics,
        depth_min=depth_min,
        depth_interval=depth_interval,
        depth_num=depth_num,
        depth_end=depth_end,
    )


def read_pair_file(path) -> list[tuple[int, list[int]]]:
    """Parse ``pair.txt`` into ``[(ref_view, [src views by descending score])]``."""
    pairs = []
    with open(path) as f:
        num_viewpoints = int(f.readline())
        for _ in range(num_viewpoints):
            ref_view = int(f.readline().strip())
            tokens = f.readline().split()
            src_views = [int(x) for x in tokens[1::2]]
            pairs.append((ref_view, src_views))
    return pairs


def projection_matrix(intrinsics: np.ndarray, extrinsics: np.ndarray) -> np.ndarray:
    """4x4 projection ``[[K @ E[:3,:4]], [0,0,0,1]]`` (reference: dtu_yao.py:144-146)."""
    proj = extrinsics.copy().astype(np.float32)
    proj[:3, :4] = intrinsics @ proj[:3, :4]
    return proj


def scale_intrinsics(intrinsics: np.ndarray, scale: float) -> np.ndarray:
    """Rescale focal lengths and principal point for a resized image.

    Matches the reference's ``scale_camera`` (datasets/preprocess.py:7-17):
    only fx, fy, cx, cy are scaled (not the skew term).
    """
    out = intrinsics.copy()
    out[0, 0] *= scale
    out[1, 1] *= scale
    out[0, 2] *= scale
    out[1, 2] *= scale
    return out


def crop_intrinsics(intrinsics: np.ndarray, start_w: int, start_h: int) -> np.ndarray:
    """Shift the principal point for a crop starting at (start_w, start_h).

    Matches reference ``crop_mvs_input`` (datasets/preprocess.py:64-65).
    """
    out = intrinsics.copy()
    out[0, 2] -= start_w
    out[1, 2] -= start_h
    return out


def select_views_top(ref_view: int, src_views: list[int], nviews: int) -> list[int]:
    """Reference view + top-(nviews-1) source views (dtu_yao.py:113)."""
    return [ref_view] + src_views[: nviews - 1]


def select_views_both_ends(ref_view: int, src_views: list[int], nviews: int) -> list[int]:
    """Padded-TnT selection: sources from both ends of the scored list
    (data_eval_transform_padding.py:111)."""
    head = src_views[: (nviews - 1) // 2]
    tail = src_views[len(src_views) - nviews // 2 :]
    return [ref_view] + head + tail
