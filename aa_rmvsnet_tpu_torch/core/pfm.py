"""PFM (Portable Float Map) codec (copy of
``aa_rmvsnet_tpu/core/pfm.py``).

Format-compatible with the reference pipeline's PFM reader/writer
(reference: datasets/data_io.py:9-74): bottom-up scanline order on disk
(so arrays are vertically flipped on read/write), a negative scale header
for little-endian data, ``Pf`` for 1-channel and ``PF`` for 3-channel maps.
"""

from __future__ import annotations

import sys

import numpy as np

_HEADER_GRAY = b"Pf"
_HEADER_COLOR = b"PF"


def read_pfm(path) -> tuple[np.ndarray, float]:
    """Read a PFM file.

    Returns ``(data, scale)`` where ``data`` is ``(H, W)`` float for
    grayscale or ``(H, W, 3)`` for color, top-down row order, native
    endianness, and ``scale`` is the (positive) scale header value.
    """
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == _HEADER_COLOR:
            channels = 3
        elif header == _HEADER_GRAY:
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline().split()
        if len(dims) != 2:
            raise ValueError(f"{path}: malformed PFM dimension line {dims!r}")
        width, height = int(dims[0]), int(dims[1])

        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        count = width * height * channels
        data = np.fromfile(f, dtype=endian + "f4", count=count)
        if data.size != count:
            raise ValueError(f"{path}: truncated PFM payload")

    shape = (height, width, 3) if channels == 3 else (height, width)
    # PFM stores scanlines bottom-to-top.
    return np.flipud(data.reshape(shape)).astype(np.float32), scale


def read_pf(path) -> np.ndarray | None:
    """Read a ``Pic98::TPlane<float>`` .PF image (reference: pfm_viewer.py:7-34).

    Text header with ``Typ=Pic98::TPlane<float>``, ``Lines=``/``Columns=``
    fields; payload is little-endian float32 taken from the end of the file.
    Returns None if the header does not match.
    """
    import re

    with open(path, "rb") as f:
        data = f.read()
    if not re.match(rb"Typ=Pic98::TPlane<float>", data):
        return None
    lines = re.search(rb"Lines=(\d+)", data)
    cols = re.search(rb"Columns=(\d+)", data)
    if not (lines and cols):
        return None
    height, width = int(lines.group(1)), int(cols.group(1))
    payload = data[-4 * height * width:]
    return np.frombuffer(payload, dtype="<f4").reshape(height, width).copy()


def save_pfm(path, image: np.ndarray, scale: float = 1.0) -> None:
    """Write ``image`` (``(H, W)``, ``(H, W, 1)`` or ``(H, W, 3)`` float32) as PFM."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError(f"PFM requires float32 data, got {image.dtype}")

    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError(f"PFM image must be HxW, HxWx1 or HxWx3, got {image.shape}")

    flipped = np.flipud(image)
    little = image.dtype.byteorder == "<" or (
        image.dtype.byteorder == "=" and sys.byteorder == "little"
    )
    with open(path, "wb") as f:
        f.write(_HEADER_COLOR + b"\n" if color else _HEADER_GRAY + b"\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale if little else scale:f}\n".encode())
        flipped.tofile(f)
