"""Training observability: TensorBoard scalars and images, and array dumps
(port of ``aa_rmvsnet_tpu/utils/logging.py``; reference utils.py:69-99
``save_scalars`` / ``save_images``).  tensorboardX is imported when a
logger is made, so the package imports without it.
"""

from __future__ import annotations

import os

import numpy as np


class TrainLogger:
    """TensorBoard writer plus periodic ``.npz`` dumps for offline analysis."""

    def __init__(self, logdir: str):
        from tensorboardX import SummaryWriter

        self.logdir = logdir
        self.writer = SummaryWriter(logdir)

    def scalars(self, mode: str, scalars: dict, step: int) -> None:
        for key, value in scalars.items():
            self.writer.add_scalar(f"{mode}/{key}", float(value), step)

    def images(self, mode: str, images: dict, step: int) -> None:
        """Log ``(H, W)`` or ``(H, W, 3)`` arrays, min-max normalised per
        image (reference utils.py:81-99)."""
        for key, img in images.items():
            img = np.asarray(img, dtype=np.float32)
            if img.ndim == 2:
                img = img[..., None].repeat(3, -1)
            lo, hi = np.nanmin(img), np.nanmax(img)
            img = (img - lo) / max(hi - lo, 1e-12)
            self.writer.add_image(f"{mode}/{key}", img, step, dataformats="HWC")

    def dump(self, mode: str, arrays: dict, step: int) -> str:
        """``<logdir>/results/<mode>/<step>.npz``, the JAX package's layout."""
        out_dir = os.path.join(self.logdir, "results", mode)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{step}.npz")
        np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
        return path

    def close(self) -> None:
        self.writer.close()
