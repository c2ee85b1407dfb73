"""Geometry: back-projection, normals, camera rays, pixel neighbourhoods.

Counterpart of bnv_fusion_tpu/geometry.py:19-217 on torch tensors.  Every
function keeps the input's device; shapes are those of the JAX package.
"""

from __future__ import annotations

import torch


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [4,4] rigid transform to [..., 3] points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def rotate_vectors(T: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation part of a [4,4] transform to [..., 3] vectors."""
    return vec @ T[:3, :3].T


def depth_to_xyz(depth: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Back-project a [H, W] depth map to a camera-frame [H, W, 3] xyz map
    (pinhole model, pixel centers at integer coordinates)."""
    h, w = depth.shape
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    u = (torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :] - cx) / fx
    v = (torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None] - cy) / fy
    return torch.stack([u * depth, v * depth, depth], dim=-1)


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy/jnp.gradient with unit spacing: central differences inside,
    one-sided at the borders."""
    n = x.shape[dim]
    if n < 2:
        return torch.zeros_like(x)
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2
    first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def normals_from_depth(depth: torch.Tensor, intr: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Camera-frame unit normals from a depth map via central differences,
    oriented toward the camera (-z hemisphere)."""
    xyz = depth_to_xyz(depth, intr)
    if mask is not None:
        xyz = torch.where(mask[..., None], xyz, torch.zeros((), dtype=xyz.dtype,
                                                             device=xyz.device))
    du = _gradient(xyz, 1)
    dv = _gradient(xyz, 0)
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-8)
    flip = torch.sum(n * xyz, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def lift_pixels(uv: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Lift [N, 2] pixel coords (x=u, y=v) to z=1 camera-frame rays [N, 3],
    skew term included."""
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    sk = intr[0, 1]
    x, y = uv[..., 0], uv[..., 1]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx
    y_lift = (y - cy) / fy
    return torch.stack([x_lift, y_lift, torch.ones_like(x)], dim=-1)


def get_camera_rays(uv: torch.Tensor, T_wc: torch.Tensor, intr: torch.Tensor):
    """Pixel coords -> (unit world-space ray dirs [N,3], camera center [3])."""
    cam_loc = T_wc[:3, 3]
    pts_world = transform_points(T_wc, lift_pixels(uv, intr))
    dirs = pts_world - cam_loc
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-8)
    return dirs, cam_loc


def gather_pixel_neighborhoods(xyz_map: torch.Tensor, mask: torch.Tensor,
                               uv: torch.Tensor, kernel_size: int = 3):
    """k x k window of world points around each integer pixel [N, 2] (x=u,
    y=v), clamped at borders -> ([N, k*k, 3] points, [N, k*k] bool mask).
    The window order matches the JAX package (du varies fastest)."""
    h, w = mask.shape
    half = kernel_size // 2
    offs = torch.arange(-half, half + 1, device=uv.device)
    dv, du = torch.meshgrid(offs, offs, indexing="ij")
    du = du.reshape(-1)
    dv = dv.reshape(-1)
    u = torch.clamp(uv[:, None, 0] + du[None, :], 0, w - 1)
    v = torch.clamp(uv[:, None, 1] + dv[None, :], 0, h - 1)
    return xyz_map[v, u], mask[v, u]
