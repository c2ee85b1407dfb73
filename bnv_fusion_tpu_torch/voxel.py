"""Voxel-grid index math: world ranges, flat ids, corner neighbours, trilinear.

Counterpart of bnv_fusion_tpu/voxel.py:17-209.  ``get_world_range``,
``get_frustrum_range`` and ``voxel_traversal`` are host numpy (setup and
tooling helpers); the rest run on tensors of any device.
"""

from __future__ import annotations

import numpy as np
import torch


def get_world_range(dimensions: np.ndarray, voxel_size: float):
    """Scene bounds -> (min_coords, max_coords, n_xyz): pad each side by one
    voxel, snap max to an integer number of voxels."""
    dimensions = np.asarray(dimensions, dtype=np.float64)
    min_ = -dimensions / 2 - voxel_size
    max_ = dimensions / 2 + voxel_size
    n_xyz = np.ceil((max_ - min_) / voxel_size).astype(np.int64)
    max_ = min_ + voxel_size * n_xyz
    return (min_.astype(np.float32), max_.astype(np.float32),
            n_xyz.astype(np.int32))


def position_to_coords(pts, min_coords, voxel_size):
    """World position -> continuous voxel coords."""
    return (pts - min_coords) / voxel_size


def coords_to_position(coords, min_coords, voxel_size):
    """Continuous voxel coords -> world position."""
    return coords * voxel_size + min_coords


def flatten_coords(coords: torch.Tensor, n_xyz) -> torch.Tensor:
    """Integer [..., 3] voxel coords -> flat id (prod(n_xyz) < 2**31)."""
    ny, nz = int(n_xyz[1]), int(n_xyz[2])
    return coords[..., 0] * (ny * nz) + coords[..., 1] * nz + coords[..., 2]


def unflatten_ids(flat_id: torch.Tensor, n_xyz) -> torch.Tensor:
    """Flat id -> integer [..., 3] voxel coords."""
    ny, nz = int(n_xyz[1]), int(n_xyz[2])
    x = torch.div(flat_id, ny * nz, rounding_mode="floor")
    rest = flat_id % (ny * nz)
    y = torch.div(rest, nz, rounding_mode="floor")
    return torch.stack([x, y, rest % nz], dim=-1)


# Corner order of the reference's get_neighbors: (f,f,f),(c,f,f),(f,c,f),
# (f,f,c),(c,c,f),(c,f,c),(f,c,c),(c,c,c) with f=floor, c=ceil.  Ceil, not
# floor+1: at exactly-integer coordinates corners collapse into duplicates.
_CORNER_PATTERN = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
     [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int32)


def corner_pattern(device) -> torch.Tensor:
    return torch.as_tensor(_CORNER_PATTERN, device=device)


def corner_neighbors(coords: torch.Tensor) -> torch.Tensor:
    """Continuous [..., 3] voxel coords -> [..., 8, 3] int32 corner coords."""
    f = torch.floor(coords)
    c = torch.ceil(coords)
    pattern = corner_pattern(coords.device).bool()
    corners = torch.where(pattern, c[..., None, :], f[..., None, :])
    return corners.to(torch.int32)


def trilinear_weights(coords: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """Normalized trilinear blend weights [..., 8]: prod(1 - |coords -
    corner|) over the axes, normalized to sum 1 over the corners (duplicate
    corners at integer coordinates included)."""
    local = coords[..., None, :] - corners.to(coords.dtype)
    w = torch.prod(1.0 - torch.abs(local), dim=-1)
    denom = torch.sum(w, dim=-1, keepdim=True)
    return w / torch.clamp(denom, min=1e-12)


def local_offsets(coords: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """Offsets (voxel units, in [-1, 1]) of a point from each corner."""
    return coords[..., None, :] - corners.to(coords.dtype)


def grid_transform(src: torch.Tensor, src_min, src_voxel, dst_min,
                   dst_voxel, dst_shape) -> torch.Tensor:
    """Resample a dense volume [X, Y, Z] onto another grid by trilinear
    interpolation, clamped at the source's edges.  ``*_min`` and
    ``*_voxel`` are scalars or per-axis [3] values."""
    dev = src.device

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    dx, dy, dz = (int(v) for v in dst_shape)
    ii, jj, kk = torch.meshgrid(
        torch.arange(dx, dtype=torch.float32, device=dev),
        torch.arange(dy, dtype=torch.float32, device=dev),
        torch.arange(dz, dtype=torch.float32, device=dev), indexing="ij")
    world = torch.stack([ii, jj, kk], dim=-1) * vec(dst_voxel) + vec(dst_min)
    c = (world - vec(src_min)) / vec(src_voxel)
    hi = torch.as_tensor([s - 1 for s in src.shape], device=dev)
    c = torch.minimum(torch.clamp(c, min=0.0), hi.to(torch.float32))
    f = torch.floor(c).long()
    t = c - f
    f1 = torch.minimum(f + 1, hi)
    out = torch.zeros((dx, dy, dz), dtype=src.dtype, device=dev)
    for bx in (0, 1):
        for by in (0, 1):
            for bz in (0, 1):
                ix = f1[..., 0] if bx else f[..., 0]
                iy = f1[..., 1] if by else f[..., 1]
                iz = f1[..., 2] if bz else f[..., 2]
                wgt = ((t[..., 0] if bx else 1 - t[..., 0]) *
                       (t[..., 1] if by else 1 - t[..., 1]) *
                       (t[..., 2] if bz else 1 - t[..., 2]))
                out = out + wgt * src[ix, iy, iz]
    return out


def get_frustrum_range(intr: np.ndarray, img_h: int, img_w: int,
                       max_depth: float, voxel_size: float):
    """Axis-aligned bounds + resolution of a camera frustum out to
    ``max_depth`` (camera frame, float64)."""
    corners_px = np.array([[0, 0], [img_w - 1, 0], [0, img_h - 1],
                           [img_w - 1, img_h - 1]], np.float64)
    x = (corners_px[:, 0] - intr[0, 2]) / intr[0, 0] * max_depth
    y = (corners_px[:, 1] - intr[1, 2]) / intr[1, 1] * max_depth
    pts = np.stack([x, y, np.full(4, max_depth)], -1)
    min_ = np.minimum(pts.min(0), 0)
    max_ = np.maximum(pts.max(0), 0)
    min_[2], max_[2] = 0.0, max_depth
    resolution = np.ceil((max_ - min_) / voxel_size)
    return min_, max_, resolution


def depth_to_tsdf(depth: torch.Tensor, intr: torch.Tensor, T_wc: torch.Tensor,
                  query_pts_w: torch.Tensor, truncated_dist: float
                  ) -> torch.Tensor:
    """Projective TSDF of world query points [N, 3] against one depth map:
    nearest pixel of each point's projection, clip(depth - z) to
    +-truncated_dist; points outside the image, behind the camera or on
    unobserved pixels get +truncated_dist.  Returns [N]."""
    T_cw = torch.linalg.inv(T_wc)
    cam = query_pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    u = torch.round(cam[..., 0] * intr[0, 0] / safe_z + intr[0, 2]).long()
    v = torch.round(cam[..., 1] * intr[1, 1] / safe_z + intr[1, 2]).long()
    h, w = depth.shape
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 0)
    d = torch.where(inside, depth[torch.clamp(v, 0, h - 1),
                                  torch.clamp(u, 0, w - 1)],
                    torch.zeros_like(z))
    sdf = torch.clamp(d - z, -truncated_dist, truncated_dist)
    return torch.where(inside & (d > 0), sdf,
                       torch.full_like(sdf, truncated_dist))


def voxel_traversal(origin: np.ndarray, direction: np.ndarray,
                    max_dist: float, n_xyz: np.ndarray) -> np.ndarray:
    """Amanatides-Woo DDA: the integer voxels a ray crosses, in order, until
    it leaves the grid or passes ``max_dist`` (host numpy).  ``origin`` is
    in voxel coords; returns [K, 3] int64."""
    origin = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    voxel_ = np.floor(origin).astype(np.int64)
    step = np.where(d >= 0, 1, -1).astype(np.int64)
    next_bound = voxel_ + (step > 0)
    with np.errstate(divide="ignore"):
        t_max = np.where(d != 0, (next_bound - origin) / d, np.inf)
        t_delta = np.where(d != 0, np.abs(1.0 / d), np.inf)
    visited = []
    t = 0.0
    n_xyz = np.asarray(n_xyz)
    while t <= max_dist:
        if np.all(voxel_ >= 0) and np.all(voxel_ < n_xyz):
            visited.append(voxel_.copy())
        elif visited:
            break  # left the volume after having entered it
        axis = int(np.argmin(t_max))
        t = t_max[axis]
        voxel_[axis] += step[axis]
        t_max[axis] += t_delta[axis]
    return (np.asarray(visited, np.int64) if visited
            else np.zeros((0, 3), np.int64))


def is_active(coords: torch.Tensor, active_flags: torch.Tensor,
              n_xyz) -> torch.Tensor:
    """Whether integer [..., 3] voxel coords lie inside the grid and are
    flagged in the bool volume ``active_flags``."""
    hi = torch.as_tensor([int(v) for v in n_xyz], device=coords.device)
    inside = torch.all((coords >= 0) & (coords < hi), dim=-1)
    c = torch.minimum(torch.clamp(coords, min=0), hi - 1).long()
    return inside & active_flags[c[..., 0], c[..., 1], c[..., 2]]
