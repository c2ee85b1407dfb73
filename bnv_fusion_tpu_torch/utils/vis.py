"""Normal shading and colored point-cloud PLYs: copy of
bnv_fusion_tpu/utils/vis.py:32-60 (numpy only)."""

from __future__ import annotations

import numpy as np


def colorize_normals(normals: np.ndarray) -> np.ndarray:
    """Unit normals [-1,1] -> uint8 RGB ((n*0.5+0.5)*255)."""
    return np.clip((normals * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)


def save_pointcloud_ply(path: str, pts: np.ndarray,
                        colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY of points, with uint8 RGB colors if given."""
    n = len(pts)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(b"property uchar red\nproperty uchar green\n"
                    b"property uchar blue\n")
        f.write(b"end_header\n")
        if colors is None:
            f.write(pts.astype("<f4").tobytes())
        else:
            xyz = pts.astype("<f4").view("u1").reshape(n, 12)
            rgb = colors.astype("u1").reshape(n, 3)
            f.write(np.concatenate([xyz, rgb], axis=1).tobytes())
