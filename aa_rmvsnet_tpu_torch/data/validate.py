"""Dataset-root structure validation (``cli eval --dry_check``; copy of
``aa_rmvsnet_tpu/data/validate.py``, with cv2 imported on use through
:func:`..utils.optional.require`).

The real-DTU/TnT quality numbers need a correctly laid-out preprocessed
dataset root (reference env.sh:1-5 hardwires such roots; the loaders then
assume the layout, e.g. datasets/data_eval_transform.py:109-110).  This
check validates a root WITHOUT running the model, so that the moment a
dataset host exists the quality run is one command away instead of an
iteration on loader stack traces.

Checked per scan (the standard preprocessed MVSNet eval layout)::

    <root>/<scan>/pair.txt
    <root>/<scan>/images/%08d.jpg
    <root>/<scan>/cams/%08d_cam.txt

- pair.txt parses and every referenced view id has an image + cam file;
- every cam file parses: 4x4 extrinsics, 3x3 intrinsics, depth_min > 0,
  depth_interval > 0 (and depth_end > depth_min when ``padded`` — the TnT
  padding pipeline requires the 4-token depth line, eval_dataset.py);
- image shapes are consistent within a scan and readable;
- source-view lists are non-empty and reference existing views.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..core.cameras import read_cam_file, read_pair_file
from ..utils.optional import require


@dataclass
class CheckReport:
    scans_checked: int = 0
    views_checked: int = 0
    errors: list[str] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        status = "OK" if self.ok else "FAILED"
        lines = [
            f"dataset check {status}: {self.scans_checked} scan(s), "
            f"{self.views_checked} view(s), {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s)"
        ]
        lines += [f"ERROR: {e}" for e in self.errors]
        lines += [f"WARNING: {w}" for w in self.warnings]
        return "\n".join(lines)


def check_dataset_root(
    datapath: str,
    scans: list[str],
    padded: bool = False,
    max_images_decoded: int = 3,
) -> CheckReport:
    """Validate the eval layout of ``datapath`` for ``scans``.

    ``max_images_decoded`` bounds the per-scan image DECODE cost (every
    image's existence is checked; only a few are decoded for shape/
    readability — dataset roots run to tens of GB).
    """
    cv2 = require("cv2", "the dataset check (cli eval --dry_check)")
    report = CheckReport()
    for scan in scans:
        scan_dir = os.path.join(datapath, scan)
        if not os.path.isdir(scan_dir):
            report.errors.append(f"{scan}: scan directory missing ({scan_dir})")
            continue
        report.scans_checked += 1

        pair_path = os.path.join(scan_dir, "pair.txt")
        if not os.path.exists(pair_path):
            report.errors.append(f"{scan}: pair.txt missing")
            continue
        try:
            pairs = read_pair_file(pair_path)
        except Exception as exc:
            report.errors.append(f"{scan}: pair.txt unparseable: {exc}")
            continue
        if not pairs:
            report.errors.append(f"{scan}: pair.txt lists no views")
            continue

        view_ids = sorted(
            {ref for ref, _ in pairs}
            | {s for _, srcs in pairs for s in srcs}
        )
        for ref, srcs in pairs:
            if not srcs:
                report.warnings.append(f"{scan}: ref view {ref} has no source views")

        shape = None
        decoded = 0
        for vid in view_ids:
            report.views_checked += 1
            img_path = os.path.join(scan_dir, f"images/{vid:08d}.jpg")
            cam_path = os.path.join(scan_dir, f"cams/{vid:08d}_cam.txt")
            if not os.path.exists(img_path):
                report.errors.append(f"{scan}: image missing for view {vid} ({img_path})")
            elif decoded < max_images_decoded:
                decoded += 1
                img = cv2.imread(img_path)
                if img is None:
                    report.errors.append(f"{scan}: image unreadable for view {vid}")
                elif shape is None:
                    shape = img.shape
                elif img.shape != shape:
                    report.errors.append(
                        f"{scan}: inconsistent image shapes "
                        f"({shape} vs {img.shape} at view {vid})"
                    )
            if not os.path.exists(cam_path):
                report.errors.append(f"{scan}: cam file missing for view {vid}")
                continue
            try:
                cam = read_cam_file(cam_path)
            except Exception as exc:
                report.errors.append(f"{scan}: cam file unparseable for view {vid}: {exc}")
                continue
            if cam.extrinsics.shape != (4, 4):
                report.errors.append(f"{scan}/{vid}: extrinsics not 4x4")
            if cam.intrinsics.shape != (3, 3):
                report.errors.append(f"{scan}/{vid}: intrinsics not 3x3")
            elif cam.intrinsics[0, 0] <= 0 or cam.intrinsics[1, 1] <= 0:
                report.errors.append(f"{scan}/{vid}: non-positive focal length")
            if not np.isfinite(cam.extrinsics).all():
                report.errors.append(f"{scan}/{vid}: non-finite extrinsics")
            if cam.depth_min <= 0:
                report.errors.append(f"{scan}/{vid}: depth_min <= 0")
            if cam.depth_interval <= 0:
                report.errors.append(f"{scan}/{vid}: depth_interval <= 0")
            if padded:
                if cam.depth_end is None:
                    report.errors.append(
                        f"{scan}/{vid}: cam file lacks depth_end (4th token of "
                        "the depth line) required by the TnT padding pipeline"
                    )
                elif cam.depth_end <= cam.depth_min:
                    report.errors.append(f"{scan}/{vid}: depth_end <= depth_min")
    return report
