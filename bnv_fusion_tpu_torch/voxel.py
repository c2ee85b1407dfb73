"""Voxel-grid index math: world ranges, flat ids, corner neighbours, trilinear.

Counterpart of bnv_fusion_tpu/voxel.py:17-98 and ``grid_transform``
(:139-164).  ``get_world_range`` is host numpy (a setup helper); the rest
run on tensors of any device.
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
