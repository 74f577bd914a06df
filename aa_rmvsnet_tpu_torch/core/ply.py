"""Binary PLY point-cloud writer (copy of ``aa_rmvsnet_tpu/core/ply.py``;
replaces the reference's plyfile dependency).

Produces the same vertex layout the reference fusion stage emits
(reference: fusion.py:260-273): binary little-endian, one ``vertex``
element with float32 x/y/z and uint8 red/green/blue.
"""

from __future__ import annotations

import numpy as np

_HEADER = """ply
format binary_little_endian 1.0
element vertex {n}
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
end_header
"""


def write_ply(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write ``(N,3)`` float32 positions and ``(N,3)`` uint8 colors to ``path``."""
    xyz = np.ascontiguousarray(xyz, dtype="<f4")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if xyz.shape != rgb.shape or xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"expected matching (N,3) arrays, got {xyz.shape} / {rgb.shape}")

    record = np.empty(
        len(xyz),
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("red", "u1"), ("green", "u1"), ("blue", "u1")],
    )
    record["x"], record["y"], record["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    record["red"], record["green"], record["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]

    with open(path, "wb") as f:
        f.write(_HEADER.format(n=len(xyz)).encode("ascii"))
        record.tofile(f)


def read_ply(path) -> tuple[np.ndarray, np.ndarray]:
    """Read a PLY written by :func:`write_ply`. Returns ``(xyz, rgb)``."""
    with open(path, "rb") as f:
        n = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        if n is None:
            raise ValueError(f"{path}: no vertex element in header")
        record = np.fromfile(
            f,
            dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")],
            count=n,
        )
    xyz = np.stack([record["x"], record["y"], record["z"]], axis=1)
    rgb = np.stack([record["red"], record["green"], record["blue"]], axis=1)
    return xyz, rgb
