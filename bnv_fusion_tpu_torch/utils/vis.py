"""Depth colormaps, normal shading, colored point-cloud PLYs, the headless
mesh preview and image writing: copies of bnv_fusion_tpu/utils/vis.py:16-131
(numpy only).  The JAX package writes images with cv2; the port writes them
with ``utils.image_io``."""

from __future__ import annotations

import numpy as np

from bnv_fusion_tpu_torch.utils import image_io


def colorize_depth(depth: np.ndarray, max_depth: float | None = None
                   ) -> np.ndarray:
    """Depth map -> uint8 RGB turbo-like colormap; invalid (<=0) is black."""
    valid = depth > 0
    if max_depth is None:
        max_depth = float(depth[valid].max()) if valid.any() else 1.0
    t = np.clip(depth / max_depth, 0, 1)
    r = np.clip(1.8 * t - 0.2, 0, 1)
    g = np.clip(np.sin(np.pi * t) * 1.1, 0, 1)
    b = np.clip(1.2 - 1.6 * t, 0, 1)
    rgb = np.stack([r, g, b], -1)
    rgb[~valid] = 0
    return (rgb * 255).astype(np.uint8)


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


def save_image(path: str, rgb_uint8: np.ndarray) -> None:
    """uint8 RGB (or grey) to ``path``: JPEG (quality 95, cv2.imwrite's
    default) for .jpg/.jpeg, else PNG."""
    if path.lower().endswith((".jpg", ".jpeg")):
        image_io.write_jpeg(path, rgb_uint8)
    else:
        image_io.write_png(path, rgb_uint8)


def encode_png(rgb_uint8: np.ndarray) -> bytes:
    """[H, W, 3] uint8 RGB -> PNG bytes."""
    img = np.asarray(rgb_uint8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png wants [H, W, 3] uint8, got {img.shape}")
    return image_io.encode_png(img)


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
    tri_u, tri_v, tri_z = u[f], vv[f], z[f].mean(1)
    base = np.array([0.55, 0.65, 0.8])
    # each triangle's pixel box, clipped; off-screen and huge (degenerate)
    # projected triangles are skipped
    u0 = tri_u.min(1).astype(np.int64)
    u1 = np.ceil(tri_u.max(1)).astype(np.int64)
    v0 = tri_v.min(1).astype(np.int64)
    v1 = np.ceil(tri_v.max(1)).astype(np.int64)
    on = ~((u1 < 0) | (v1 < 0) | (u0 >= w) | (v0 >= h))
    u0, v0 = np.maximum(u0, 0), np.maximum(v0, 0)
    u1, v1 = np.minimum(u1 + 1, w), np.minimum(v1 + 1, h)
    on &= (u1 - u0) * (v1 - v0) <= 64 * 64
    # z-buffered splats, far to near, a nearer splat overwriting a farther
    # one: each pixel shows the first triangle in that order with the
    # least depth among those whose box covers it
    order = np.argsort(-tri_z)
    tri = order[on[order]]
    bw, bh = u1[tri] - u0[tri], v1[tri] - v0[tri]
    counts = bw * bh
    owner = np.repeat(np.arange(len(tri)), counts)
    local = np.arange(int(counts.sum())) - np.repeat(
        np.cumsum(counts) - counts, counts)
    pix = ((v0[tri][owner] + local // bw[owner]) * w +
           u0[tri][owner] + local % bw[owner])
    first = np.lexsort((owner, tri_z[tri][owner], pix))
    pix, owner = pix[first], owner[first]
    keep = np.ones(len(pix), bool)
    keep[1:] = pix[1:] != pix[:-1]
    img.reshape(-1, 3)[pix[keep]] = base * shade[tri[owner[keep]], None]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def mesh_with_normal_colors(mesh) -> np.ndarray:
    """Per-vertex normal-shaded colors for quick mesh inspection."""
    v, f = mesh.vertices, mesh.faces
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    vn = np.zeros_like(v)
    np.add.at(vn, f[:, 0], fn)
    np.add.at(vn, f[:, 1], fn)
    np.add.at(vn, f[:, 2], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    return colorize_normals(vn)
