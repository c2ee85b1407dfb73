"""Dense TSDF prior volume: classic projective TSDF fusion.

Counterpart of bnv_fusion_tpu/tsdf.py:31-172, :176-235 (the per-frame
supervision grids the refiner's noisy-depth prior accumulates) and
:530-617 (dense layout only; the block-major volume is ROADMAP Queue 1
item 13).  The volume starts at ``-trunc_margin`` (the reference's weak
negative prior), stores normalized TSDF values (callers rescale by
``voxel_size * 5``) and looks depth up at the rounded pixel.  A volume made
``with_color`` also keeps a running-mean RGB (0-255 floats) with the sdf's
weights, which ``sample_color`` reads at mesh vertices.  ``integrate``
updates the volume IN PLACE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from bnv_fusion_tpu_torch import voxel as vx


@dataclass
class TSDFVolume:
    sdf: torch.Tensor      # [X, Y, Z] float32, normalized units
    weight: torch.Tensor   # [X, Y, Z] float32
    origin: torch.Tensor   # [3] float32 world position of voxel (0,0,0)
    color: Optional[torch.Tensor] = None  # [X, Y, Z, 3] float32 RGB mean


def create_tsdf_volume(dimensions: np.ndarray, voxel_size: float = 0.025,
                       device: torch.device | str = "cpu",
                       with_color: bool = False
                       ) -> Tuple[TSDFVolume, float]:
    """Build the prior volume over the scene bounds (with a zero RGB
    volume when ``with_color``). Returns (volume, trunc_margin)."""
    min_c, max_c, _ = vx.get_world_range(np.asarray(dimensions), voxel_size)
    vol_dim = tuple(int(v) for v in np.ceil((max_c - min_c) / voxel_size))
    trunc = 5.0 * voxel_size
    vol = TSDFVolume(
        sdf=torch.full(vol_dim, -trunc, dtype=torch.float32, device=device),
        weight=torch.zeros(vol_dim, dtype=torch.float32, device=device),
        origin=torch.as_tensor(min_c, dtype=torch.float32, device=device),
        color=(torch.zeros(vol_dim + (3,), dtype=torch.float32, device=device)
               if with_color else None))
    return vol, trunc


def _integrate_into(sdf: torch.Tensor, weight: torch.Tensor,
                    origin: torch.Tensor, depth: torch.Tensor,
                    intr: torch.Tensor, T_wc: torch.Tensor, voxel_size: float,
                    obs_weight: float, color: Optional[torch.Tensor] = None,
                    rgb: Optional[torch.Tensor] = None) -> None:
    """The update of one frame on [X, Y, Z] views (written in place); the
    RGB mean too when both ``color`` and ``rgb`` are given."""
    trunc = 5.0 * voxel_size
    dx, dy, dz = sdf.shape
    dev = sdf.device
    ii, jj, kk = torch.meshgrid(
        torch.arange(dx, dtype=torch.float32, device=dev),
        torch.arange(dy, dtype=torch.float32, device=dev),
        torch.arange(dz, dtype=torch.float32, device=dev), indexing="ij")
    world = torch.stack([ii, jj, kk], dim=-1) * voxel_size + origin

    T_cw = torch.linalg.inv(T_wc)
    cam = world @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = cam[..., 2]
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    safe_z = torch.where(torch.abs(z) > 1e-8, z,
                         torch.full((), 1e-8, device=dev))
    px = torch.round(cam[..., 0] * fx / safe_z + cx)
    py = torch.round(cam[..., 1] * fy / safe_z + cy)

    h, w = depth.shape
    in_view = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)
    flat = (torch.clamp(py, 0, h - 1) * w + torch.clamp(px, 0, w - 1)).long()
    depth_val = torch.where(in_view, depth.reshape(-1)[flat],
                            torch.zeros((), device=dev))

    depth_diff = depth_val - z
    valid = (depth_val > 0) & (depth_diff >= -trunc)
    dist = torch.clamp(depth_diff / trunc, max=1.0)
    w_new = weight + obs_weight
    sdf_new = (weight * sdf + obs_weight * dist) / w_new
    if color is not None and rgb is not None:
        rgb_val = torch.where(valid[..., None],
                              rgb.reshape(-1, 3).to(torch.float32)[flat],
                              torch.zeros((), device=dev))
        col_new = (weight[..., None] * color + obs_weight * rgb_val) / \
            w_new[..., None]
        color.copy_(torch.where(valid[..., None], col_new, color))
    sdf.copy_(torch.where(valid, sdf_new, sdf))
    weight.copy_(torch.where(valid, w_new, weight))


def integrate(vol: TSDFVolume, depth: torch.Tensor, intr: torch.Tensor,
              T_wc: torch.Tensor, voxel_size: float,
              obs_weight: float = 1.0,
              rgb: Optional[torch.Tensor] = None) -> TSDFVolume:
    """Fuse one depth frame into the whole volume, in place; ``rgb``
    ([H, W, 3], 0-255) goes into the colour mean of a volume made
    ``with_color`` (and is ignored by one without)."""
    _integrate_into(vol.sdf, vol.weight, vol.origin, depth, intr, T_wc,
                    voxel_size, float(obs_weight), vol.color, rgb)
    return vol


def prepare_sdf_delta(vol: TSDFVolume, voxel_size: float,
                      truncated_dist: float, sdf_delta_weight: float
                      ) -> torch.Tensor:
    """The prior as the additive decode term: metric units (x voxel_size*5),
    clipped to +-truncated_dist, times sdf_delta_weight."""
    metric = vol.sdf * (voxel_size * 5.0)
    return torch.clamp(metric, -truncated_dist, truncated_dist) * \
        sdf_delta_weight


def sample_color(vol: TSDFVolume, pts_w: torch.Tensor, voxel_size: float
                 ) -> torch.Tensor:
    """Trilinear sample of the colour volume at world points [N, 3] ->
    [N, 3] uint8 (coordinates clipped to the grid, rounded half to
    even)."""
    if vol.color is None:
        raise ValueError("TSDF volume was created without color")
    dev = vol.color.device
    c = (pts_w.to(dev) - vol.origin) / voxel_size
    dims = torch.as_tensor(vol.sdf.shape, dtype=torch.float32, device=dev)
    c = torch.minimum(torch.clamp(c, min=0.0), dims - 1.0)
    f = torch.floor(c).long()
    t = c - f
    hi = torch.as_tensor([s - 1 for s in vol.sdf.shape], device=dev)
    f1 = torch.minimum(f + 1, hi)
    out = torch.zeros(pts_w.shape[:-1] + (3,), dtype=torch.float32,
                      device=dev)
    for bx in (0, 1):
        for by in (0, 1):
            for bz in (0, 1):
                ix = f1[..., 0] if bx else f[..., 0]
                iy = f1[..., 1] if by else f[..., 1]
                iz = f1[..., 2] if bz else f[..., 2]
                w = ((t[..., 0] if bx else 1 - t[..., 0]) *
                     (t[..., 1] if by else 1 - t[..., 1]) *
                     (t[..., 2] if bz else 1 - t[..., 2]))
                out = out + w[..., None] * vol.color[ix, iy, iz]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def depth_to_tsdf_grid(depth: torch.Tensor, T_wc: torch.Tensor,
                       intr: torch.Tensor, min_coords: torch.Tensor,
                       volume_resolution: Tuple[int, int, int],
                       voxel_size: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's dense world-grid TSDF + weights at the model voxel size:
    voxel centers projected into the frame, depth nearest-sampled with
    grid_sample(align_corners=True) semantics, sdf = clip(depth - z,
    +-5 voxels); valid = observed & in front & sdf > -2 voxels; weight 1 on
    valid, sdf 0 elsewhere."""
    h, w = depth.shape
    dev = depth.device
    dx, dy, dz = (int(v) for v in volume_resolution)
    ii, jj, kk = torch.meshgrid(
        torch.arange(dx, dtype=torch.float32, device=dev),
        torch.arange(dy, dtype=torch.float32, device=dev),
        torch.arange(dz, dtype=torch.float32, device=dev), indexing="ij")
    world = (torch.stack([ii, jj, kk], dim=-1) + 0.5) * voxel_size + \
        min_coords
    T_cw = torch.linalg.inv(T_wc)
    cam = world @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-8, z,
                         torch.full((), 1e-8, device=dev))
    px = cam[..., 0] * intr[0, 0] / safe_z + intr[0, 2]
    py = cam[..., 1] * intr[1, 1] / safe_z + intr[1, 2]
    ix = torch.round(px * (w - 1) / w).long()
    iy = torch.round(py * (h - 1) / h).long()
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    zero = torch.zeros((), device=dev)
    d = torch.where(inside, depth[torch.clamp(iy, 0, h - 1),
                                  torch.clamp(ix, 0, w - 1)], zero)
    sdf = torch.clamp(d - z, -5.0 * voxel_size, 5.0 * voxel_size)
    valid = (torch.abs(d) > 1e-5) & (z > 0) & (sdf > -2.0 * voxel_size)
    return torch.where(valid, sdf, zero), valid.to(torch.float32)


def accumulate_tsdf_window(depths, T_wcs, intrs, min_coords,
                           volume_resolution, voxel_size: float,
                           device: torch.device | str = "cpu"):
    """Mean of per-frame TSDF grids over the frames that observe each voxel;
    never-observed voxels get +5 voxels.  Inputs are host arrays or tensors;
    returns (sdf, observation count) on ``device``."""
    res = tuple(int(v) for v in volume_resolution)
    sdf_sum = torch.zeros(res, dtype=torch.float32, device=device)
    w_sum = torch.zeros(res, dtype=torch.float32, device=device)

    def dev_t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mn = dev_t(min_coords)
    for depth, T_wc, intr in zip(depths, T_wcs, intrs):
        s, w = depth_to_tsdf_grid(dev_t(depth), dev_t(T_wc), dev_t(intr), mn,
                                  res, voxel_size)
        sdf_sum = sdf_sum + s
        w_sum = w_sum + w
    n = len(depths)
    sdf = sdf_sum / torch.clamp(w_sum, 1.0, float(n))
    sdf = torch.where(w_sum == 0, torch.full((), 5.0 * voxel_size,
                                             device=sdf.device), sdf)
    return sdf, w_sum


def frustum_window_shape(intr: np.ndarray, img_hw, max_depth: float,
                         voxel_size: float, vol_shape) -> Tuple[int, int, int]:
    """Static voxel extent of the camera frustum's minimal enclosing sphere
    (+2 voxels), capped at the volume shape: a window of this extent placed
    over the frustum covers every voxel one frame can update."""
    h, w = img_hw
    zmax = max_depth + 5.0 * voxel_size
    xs = (np.array([-0.5, w - 0.5]) - intr[0, 2]) / intr[0, 0] * zmax
    ys = (np.array([-0.5, h - 0.5]) - intr[1, 2]) / intr[1, 1] * zmax
    r2_sq = float(max(abs(x) for x in xs)) ** 2 + \
        float(max(abs(y) for y in ys)) ** 2
    c = (r2_sq + zmax * zmax) / (2.0 * zmax)
    radius = c if c <= zmax else np.sqrt(r2_sq)
    n = int(np.ceil(2.0 * radius / voxel_size)) + 2
    return tuple(min(n, int(s)) for s in vol_shape)


def _frustum_start(vol: TSDFVolume, depth_hw, intr: torch.Tensor,
                   T_wc: torch.Tensor, voxel_size: float, max_depth: float,
                   window) -> Tuple[int, int, int]:
    """Window origin (voxel coords) on the frustum's enclosing-sphere
    center, clamped inside the grid."""
    h, w = depth_hw
    dev = vol.sdf.device
    zmax = max_depth + 5.0 * voxel_size
    xs = (torch.as_tensor([-0.5, w - 0.5], device=dev) - intr[0, 2]) / \
        intr[0, 0] * zmax
    ys = (torch.as_tensor([-0.5, h - 0.5], device=dev) - intr[1, 2]) / \
        intr[1, 1] * zmax
    r2_sq = torch.maximum(xs[0].abs(), xs[1].abs()) ** 2 + \
        torch.maximum(ys[0].abs(), ys[1].abs()) ** 2
    c = (r2_sq + zmax * zmax) / (2.0 * zmax)
    center_cam = torch.as_tensor([0.0, 0.0, 1.0], device=dev) * \
        torch.clamp(c, max=zmax)
    center_w = center_cam @ T_wc[:3, :3].T + T_wc[:3, 3]
    wnd = torch.as_tensor(window, dtype=torch.float32, device=dev)
    lo = (center_w - vol.origin) / voxel_size - wnd / 2.0
    dims = torch.as_tensor(vol.sdf.shape, device=dev)
    start = torch.clamp(torch.floor(lo).long(), min=0)
    start = torch.minimum(start, dims - wnd.long())
    return tuple(int(v) for v in start.tolist())


def integrate_windowed(vol: TSDFVolume, depth: torch.Tensor,
                       intr: torch.Tensor, T_wc: torch.Tensor,
                       voxel_size: float, window: Tuple[int, int, int],
                       max_depth: float, obs_weight: float = 1.0,
                       rgb: Optional[torch.Tensor] = None) -> TSDFVolume:
    """``integrate`` restricted to the frustum window, in place — identical
    results (voxels outside the window cannot receive updates)."""
    s0, s1, s2 = _frustum_start(vol, depth.shape, intr, T_wc, voxel_size,
                                max_depth, window)
    w0, w1, w2 = window
    sl = (slice(s0, s0 + w0), slice(s1, s1 + w1), slice(s2, s2 + w2))
    origin = vol.origin + torch.as_tensor(
        [s0, s1, s2], dtype=torch.float32, device=vol.sdf.device) * voxel_size
    _integrate_into(vol.sdf[sl], vol.weight[sl], origin, depth, intr, T_wc,
                    voxel_size, float(obs_weight),
                    None if vol.color is None else vol.color[sl], rgb)
    return vol
