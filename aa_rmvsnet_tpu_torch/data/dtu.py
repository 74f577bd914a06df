"""DTU training dataset, Yao Yao's preprocessed layout (copy of
``aa_rmvsnet_tpu/data/dtu.py``; cv2 is imported where it is used).

Sample semantics of the reference loader (datasets/dtu_yao.py): metas are
scan x ref view (pair.txt) x 7 light conditions x optional depth-reversal
duplication; images are PNGs resized by ``image_scale`` and standardised;
cameras come from ``Cameras/train/*_cam.txt`` with intrinsics x2 / x4 for
image_scale 0.5 / 1.0 (the shipped cams are calibrated at quarter
resolution); hypotheses are ``linspace(dmin, dmin + (D-1)*interval, D)``
(optionally inverse or flipped); the GT mask is ``dmin <= depth <= dend``.

Directory layout::

    <root>/Cameras/pair.txt
    <root>/Cameras/train/{vid:08d}_cam.txt
    <root>/Rectified/{scan}_train/rect_{vid+1:03d}_{light}_r5000.png
    <root>/Depths/{scan}_train/depth_map_{vid:04d}.pfm
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..core.cameras import projection_matrix, read_cam_file, read_pair_file
from ..core.pfm import read_pfm
from ..core.samplers import inverse_depth_bounded, linear_depth_train, maybe_flip
from ..core.transforms import standardize_image


def _imread_rgb(path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)


@dataclass
class DTUTrainDataset:
    datapath: str
    listfile: str
    nviews: int = 5
    ndepths: int = 192
    interval_scale: float = 1.06
    image_scale: float = 0.25
    inverse_depth: bool = False
    light_idx: int = -1  # -1 = all 7 lights
    both: bool = True  # duplicate every meta with a flipped depth sweep
    fix_depth_end: float | None = None  # e.g. 935.0 with fix_range

    def __post_init__(self):
        with open(self.listfile) as f:
            scans = [line.strip() for line in f if line.strip()]
        pairs = read_pair_file(os.path.join(self.datapath, "Cameras/pair.txt"))
        lights = range(7) if self.light_idx == -1 else [self.light_idx]
        self.metas = [
            (scan, light, ref, srcs, flip)
            for scan in scans
            for (ref, srcs) in pairs
            for light in lights
            for flip in ((True, False) if self.both else (False,))
        ]

    def __len__(self):
        return len(self.metas)

    def _intrinsics_scale(self) -> float:
        # Shipped DTU train cams are calibrated at 1/4 input resolution.
        return {0.25: 1.0, 0.5: 2.0, 1.0: 4.0}.get(self.image_scale, 1.0)

    def __getitem__(self, idx: int) -> dict:
        import cv2

        scan, light, ref_view, src_views, flip = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, projs = [], []
        depth = mask = depth_values = None
        depth_interval = 0.0
        for i, vid in enumerate(view_ids):
            img = _imread_rgb(os.path.join(
                self.datapath, f"Rectified/{scan}_train/rect_{vid + 1:03d}_{light}_r5000.png"
            ))
            if self.image_scale != 1.0:
                h, w = img.shape[:2]
                img = cv2.resize(
                    img, (int(w * self.image_scale), int(h * self.image_scale)),
                    interpolation=cv2.INTER_LINEAR,
                )
            imgs.append(standardize_image(img, eps=1e-8))

            cam = read_cam_file(
                os.path.join(self.datapath, f"Cameras/train/{vid:08d}_cam.txt"),
                interval_scale=self.interval_scale,
                intrinsics_scale=self._intrinsics_scale(),
            )
            projs.append(projection_matrix(cam.intrinsics, cam.extrinsics))

            if i == 0:
                depth_interval = cam.depth_interval
                depth_end = (
                    self.fix_depth_end if self.fix_depth_end is not None
                    else cam.depth_interval * (self.ndepths - 1) + cam.depth_min
                )
                if self.inverse_depth:
                    depth_values = inverse_depth_bounded(cam.depth_min, depth_end,
                                                         self.ndepths)
                else:
                    depth_values = linear_depth_train(
                        cam.depth_min, cam.depth_interval, self.ndepths,
                        self.fix_depth_end,
                    )
                depth = read_pfm(os.path.join(
                    self.datapath, f"Depths/{scan}_train/depth_map_{vid:04d}.pfm"
                ))[0]
                mask = ((depth >= cam.depth_min) & (depth <= depth_end)).astype(np.float32)

        return {
            "imgs": np.stack(imgs),  # (V, H, W, 3)
            "proj_matrices": np.stack(projs),  # (V, 4, 4)
            "depth_values": maybe_flip(depth_values, flip),  # (D,)
            "depth": depth,  # (H, W)
            "mask": mask,  # (H, W)
            "depth_interval": np.float32(depth_interval),
            "name": f"{scan}/{ref_view}/{light}",
        }
