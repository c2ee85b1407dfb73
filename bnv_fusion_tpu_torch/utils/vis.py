"""Normal shading, colored point-cloud PLYs, the headless mesh preview and
PNG encoding: copies of bnv_fusion_tpu/utils/vis.py:32-120 (numpy only).
The JAX package writes PNG with cv2; ``encode_png`` writes it with zlib
and struct, so the port needs no cv2."""

from __future__ import annotations

import struct
import zlib

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


def encode_png(rgb_uint8: np.ndarray) -> bytes:
    """[H, W, 3] uint8 RGB -> PNG bytes (8-bit truecolor, no filter)."""
    img = np.ascontiguousarray(rgb_uint8, np.uint8)
    h, w = img.shape[:2]
    if img.shape != (h, w, 3):
        raise ValueError(f"encode_png wants [H, W, 3] uint8, got {img.shape}")
    # each scanline starts with its filter type byte (0: none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def render_mesh_preview(mesh, img_res=(480, 640), eye=None,
                        target=None) -> np.ndarray:
    """Headless software rendering of a mesh (triangles splatted as their
    bounding boxes in a z-buffer, flat normal shading), in place of the
    reference's pangolin/Open3D views.  Returns a uint8 RGB image."""
    from bnv_fusion_tpu_torch.datasets.synth_scene import look_at_pose

    v, f = mesh.vertices, mesh.faces
    if len(f) == 0:
        return np.zeros(img_res + (3,), np.uint8)
    center = 0.5 * (v.min(0) + v.max(0))
    radius = float(np.linalg.norm(v.max(0) - v.min(0))) / 2 + 1e-6
    if eye is None:
        eye = center + np.array([1.2, -1.8, 1.2]) * radius
    if target is None:
        target = center
    T_cw = np.linalg.inv(look_at_pose(np.asarray(eye), np.asarray(target)))
    h, w = img_res
    focal = 0.9 * w

    cam = v @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = np.maximum(cam[:, 2], 1e-6)
    u = cam[:, 0] / z * focal + w / 2
    vv = cam[:, 1] / z * focal + h / 2

    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    light = np.array([0.4, -0.6, 0.7])
    light /= np.linalg.norm(light)
    shade = (0.25 + 0.75 * np.abs(fn @ light))

    img = np.zeros((h, w, 3), np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    tri_u, tri_v, tri_z = u[f], vv[f], z[f].mean(1)
    base = np.array([0.55, 0.65, 0.8])
    for ti in np.argsort(-tri_z):  # far to near: nearer splats overwrite
        u0, u1 = int(tri_u[ti].min()), int(np.ceil(tri_u[ti].max()))
        v0, v1 = int(tri_v[ti].min()), int(np.ceil(tri_v[ti].max()))
        if u1 < 0 or v1 < 0 or u0 >= w or v0 >= h:
            continue
        u0, v0 = max(u0, 0), max(v0, 0)
        u1, v1 = min(u1 + 1, w), min(v1 + 1, h)
        if (u1 - u0) * (v1 - v0) > 64 * 64:
            continue  # degenerate or huge projected triangle
        patch_z = tri_z[ti]
        sel = zbuf[v0:v1, u0:u1] > patch_z
        zbuf[v0:v1, u0:u1][sel] = patch_z
        img[v0:v1, u0:u1][sel] = base * shade[ti]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)
