"""Generic evaluation dataset for MVSNet-format scenes (DTU eval / TnT),
with the optional row-padding variant used for Tanks-and-Temples (copy of
``aa_rmvsnet_tpu/data/eval_dataset.py``; cv2 is imported where it is used).

Mirrors the reference eval loaders' sample semantics
(reference: datasets/data_eval_transform.py, data_eval_transform_padding.py):

- scene layout ``{scan}/images/{vid:08d}.jpg``, ``{scan}/cams/{vid:08d}_cam.txt``,
  ``{scan}/pair.txt``;
- adaptive down-scale so every view fits ``max_h x max_w``, then center-crop
  to a multiple of 8 with intrinsics adjusted;
- depth hypotheses: linear ``arange`` or open inverse-depth; the padding
  variant reads ``depth_end`` from the cam file and uses bounded inverse;
- per-image standardization (no eps, eval flavor);
- padding variant additionally zero-pads +4/+4 rows (cy += 4) and picks
  source views from both ends of the scored pair list.

Samples carry the relative output path template so the inference driver
reproduces the reference's on-disk layout (eval.py:130-147) and the fusion
stage is drop-in compatible.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..core.cameras import (
    read_cam_file,
    read_pair_file,
    scale_intrinsics,
    crop_intrinsics,
    select_views_top,
    select_views_both_ends,
)
from ..core.samplers import linear_depth_eval, inverse_depth_open, inverse_depth_bounded
from ..core.transforms import (
    standardize_image,
    adaptive_scale_factor,
    center_crop_to_multiple,
    pad_rows,
    scale_image,
)


def _imread_rgb(path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)


@dataclass
class EvalDataset:
    datapath: str
    listfile: str | list[str]
    nviews: int = 7
    ndepths: int = 512
    interval_scale: float = 1.0
    inverse_depth: bool = False
    max_h: int = 864
    max_w: int = 1152
    base_image_size: int = 8
    adaptive_scaling: bool = True
    pad_vertical: bool = False  # TnT padding variant

    def __post_init__(self):
        if isinstance(self.listfile, str):
            with open(self.listfile) as f:
                scans = [line.strip() for line in f if line.strip()]
        else:
            scans = list(self.listfile)
        self.metas = [
            (scan, ref, srcs)
            for scan in scans
            for (ref, srcs) in read_pair_file(os.path.join(self.datapath, scan, "pair.txt"))
        ]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict:
        scan, ref_view, src_views = self.metas[idx]
        nviews = min(self.nviews, len(src_views) + 1)
        if self.pad_vertical:
            view_ids = select_views_both_ends(ref_view, src_views, nviews)
        else:
            view_ids = select_views_top(ref_view, src_views, nviews)

        imgs, intrinsics_list, extrinsics_list = [], [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            img = _imread_rgb(os.path.join(self.datapath, scan, f"images/{vid:08d}.jpg"))
            if self.pad_vertical:
                img = pad_rows(img, 4, 4)
            imgs.append(standardize_image(img, eps=0.0))

            cam = read_cam_file(
                os.path.join(self.datapath, scan, f"cams/{vid:08d}_cam.txt"),
                interval_scale=self.interval_scale,
                cy_offset=4.0 if self.pad_vertical else 0.0,
            )
            intrinsics_list.append(cam.intrinsics)
            extrinsics_list.append(cam.extrinsics)

            if i == 0:
                if self.pad_vertical:
                    if cam.depth_end is None:
                        raise ValueError(
                            f"{scan}/{vid}: cam file lacks depth_end (4th token of line 11)"
                        )
                    depth_values = inverse_depth_bounded(
                        cam.depth_min, cam.depth_end, self.ndepths
                    )
                elif self.inverse_depth:
                    depth_values = inverse_depth_open(cam.depth_min, self.ndepths)
                else:
                    depth_values = linear_depth_eval(
                        cam.depth_min, cam.depth_interval, self.ndepths
                    )

        # Adaptive down-scale so all views fit, then aligned center crop.
        scale = 1.0
        if self.adaptive_scaling:
            scale = adaptive_scale_factor(
                [im.shape[:2] for im in imgs], self.max_h, self.max_w
            )
        out_imgs, out_projs = [], []
        for img, K, E in zip(imgs, intrinsics_list, extrinsics_list):
            if scale != 1.0:
                img = scale_image(img, scale)
                K = scale_intrinsics(K, scale)
            img, start_h, start_w = center_crop_to_multiple(
                img, self.max_h, self.max_w, self.base_image_size
            )
            K = crop_intrinsics(K, start_w, start_h)
            proj = E.copy()
            proj[:3, :4] = K @ proj[:3, :4]
            out_imgs.append(img)
            out_projs.append(proj)

        return {
            "imgs": np.stack(out_imgs).astype(np.float32),  # (V, H, W, 3)
            "proj_matrices": np.stack(out_projs).astype(np.float32),
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
            "scan": scan,
            "ref_view": ref_view,
        }
