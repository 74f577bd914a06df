"""Read a PFM file (the maps ``cli eval`` writes) into a float32 array."""

from __future__ import annotations

import numpy as np


def read(path) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        if kind not in (b"Pf", b"PF"):
            raise ValueError(f"{path}: not a PFM file ({kind!r})")
        width, height = (int(v) for v in f.readline().split())
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        channels = 3 if kind == b"PF" else 1
        data = np.frombuffer(f.read(), dtype=dtype, count=width * height * channels)
    shape = (height, width, channels) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32)
