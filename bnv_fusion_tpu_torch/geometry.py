"""Geometry: back-projection, normals, camera rays, pixel neighbourhoods.

Counterpart of bnv_fusion_tpu/geometry.py:19-217 on torch tensors.  Every
function keeps the input's device; shapes are those of the JAX package.
``DepthNoiseSimulator`` (geometry.py:148-175) is host numpy, copied as is so
that one seed gives the same noisy depth in both packages.
"""

from __future__ import annotations

import numpy as np
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


class DepthNoiseSimulator:
    """Parametric Kinect-style depth noise: axial sigma(z) = a + b (z - z0)^2
    plus lateral jitter of the sampling position by ~1 pixel (host numpy)."""

    def __init__(self, seed: int = 0, a: float = 0.0012, b: float = 0.0019,
                 z0: float = 0.4, lateral_px: float = 0.8):
        self.rng = np.random.RandomState(seed)
        self.a, self.b, self.z0 = a, b, z0
        self.lateral_px = lateral_px

    def simulate(self, depth: np.ndarray) -> np.ndarray:
        h, w = depth.shape
        valid = depth > 0
        sigma = self.a + self.b * np.square(depth - self.z0)
        noisy = depth + self.rng.randn(h, w) * sigma
        du = np.clip(np.round(self.rng.randn(h, w) * self.lateral_px), -2, 2)
        dv = np.clip(np.round(self.rng.randn(h, w) * self.lateral_px), -2, 2)
        uu, vv = np.meshgrid(np.arange(w), np.arange(h))
        su = np.clip(uu + du, 0, w - 1).astype(np.int64)
        sv = np.clip(vv + dv, 0, h - 1).astype(np.int64)
        noisy = noisy[sv, su]
        return np.where(valid, np.maximum(noisy, 0.0), 0.0).astype(np.float32)
