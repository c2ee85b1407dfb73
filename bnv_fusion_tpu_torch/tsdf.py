"""TSDF prior volume: classic projective TSDF fusion, dense or block-major.

Counterpart of bnv_fusion_tpu/tsdf.py (whole): the dense [X, Y, Z] volume
with ``integrate``, the merged K-frame ``integrate_batch`` and the frustum
window, the per-frame supervision grids the refiner's noisy-depth prior
accumulates, and the block-major volume of big scenes (``TSDFVolumeBM``,
[n_blocks, 64] bricks of 4^3 voxels) whose ``integrate_blocks`` updates
only the bricks that meet the camera frustum.  The volume starts at
``-trunc_margin`` (the reference's weak negative prior), stores normalized
TSDF values (callers rescale by ``voxel_size * 5``) and looks depth up at
the rounded pixel.  A volume made ``with_color`` also keeps a running-mean
RGB (0-255 floats) with the sdf's weights, which ``sample_color`` reads at
mesh vertices.  ``as_dense`` views either layout as the dense one.  Every
integrate updates the volume IN PLACE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from bnv_fusion_tpu_torch import voxel as vx
from bnv_fusion_tpu_torch.utils import profiling


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


def integrate_batch(vol: TSDFVolume, depths: torch.Tensor,
                    intrs: torch.Tensor, T_wcs: torch.Tensor,
                    voxel_size: float, obs_weight: float = 1.0,
                    rgbs: Optional[torch.Tensor] = None) -> TSDFVolume:
    """Fuse K frames [K, ...] with ONE volume update, in place.  The
    per-frame running mean is associative: folding frames i..j equals one
    update with W = sum(valid_k * obs_weight) and D = sum(valid_k *
    obs_weight * dist_k) (and C for the colour)."""
    trunc = 5.0 * voxel_size
    dx, dy, dz = vol.sdf.shape
    dev = vol.sdf.device
    zero = torch.zeros((), device=dev)
    ii, jj, kk = torch.meshgrid(
        torch.arange(dx, dtype=torch.float32, device=dev),
        torch.arange(dy, dtype=torch.float32, device=dev),
        torch.arange(dz, dtype=torch.float32, device=dev), indexing="ij")
    world = torch.stack([ii, jj, kk], dim=-1) * voxel_size + vol.origin
    W = D = C = None
    for k in range(depths.shape[0]):
        depth, intr = depths[k], intrs[k]
        T_cw = torch.linalg.inv(T_wcs[k])
        cam = world @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = cam[..., 2]
        safe_z = torch.where(torch.abs(z) > 1e-8, z,
                             torch.full((), 1e-8, device=dev))
        px = torch.round(cam[..., 0] * intr[0, 0] / safe_z + intr[0, 2])
        py = torch.round(cam[..., 1] * intr[1, 1] / safe_z + intr[1, 2])
        h, w = depth.shape
        in_view = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)
        flat = (torch.clamp(py, 0, h - 1) * w +
                torch.clamp(px, 0, w - 1)).long()
        depth_val = torch.where(in_view, depth.reshape(-1)[flat], zero)
        depth_diff = depth_val - z
        valid = (depth_val > 0) & (depth_diff >= -trunc)
        dist = torch.clamp(depth_diff / trunc, max=1.0)
        wv = valid.to(torch.float32) * obs_weight
        W = wv if W is None else W + wv
        D = wv * dist if D is None else D + wv * dist
        if rgbs is not None:
            rgb_val = torch.where(valid[..., None],
                                  rgbs[k].reshape(-1, 3).to(torch.float32)
                                  [flat], zero)
            c = wv[..., None] * rgb_val
            C = c if C is None else C + c
    touched = W > 0
    w_new = vol.weight + W
    sdf_new = (vol.weight * vol.sdf + D) / torch.clamp(w_new, min=1e-12)
    if vol.color is not None and C is not None:
        col_new = (vol.weight[..., None] * vol.color + C) / \
            torch.clamp(w_new, min=1e-12)[..., None]
        vol.color.copy_(torch.where(touched[..., None], col_new, vol.color))
    vol.sdf.copy_(torch.where(touched, sdf_new, vol.sdf))
    vol.weight.copy_(torch.where(touched, w_new, vol.weight))
    return vol


def prepare_sdf_delta(vol, voxel_size: float, truncated_dist: float,
                      sdf_delta_weight: float) -> torch.Tensor:
    """The prior (either layout) as the additive dense decode term: metric
    units (x voxel_size*5), clipped to +-truncated_dist, times
    sdf_delta_weight."""
    metric = as_dense(vol).sdf * (voxel_size * 5.0)
    return torch.clamp(metric, -truncated_dist, truncated_dist) * \
        sdf_delta_weight


def sample_color(vol, pts_w: torch.Tensor, voxel_size: float
                 ) -> torch.Tensor:
    """Trilinear sample of the colour volume (either layout) at world points
    [N, 3] -> [N, 3] uint8 (coordinates clipped to the grid, rounded half
    to even)."""
    if vol.color is None:
        raise ValueError("TSDF volume was created without color")
    vol = as_dense(vol)
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


# ---------------------------------------------------------------------------
# block-major volume: frustum-exact sparse updates for big scenes
# ---------------------------------------------------------------------------

TSDF_BLOCK = 4
_BS = TSDF_BLOCK ** 3   # 64 voxels per block
# model.tsdf_layout=auto holds the prior block-major from this many voxels
BLOCKS_FROM_VOXELS = 8_000_000


def is_block_major(layout: str, dimensions: np.ndarray,
                   voxel_size: float) -> bool:
    """Whether the pipeline holds a prior of ``voxel_size`` over
    ``dimensions`` block-major: under ``model.tsdf_layout`` blocks, or under
    auto from ``BLOCKS_FROM_VOXELS`` voxels of its grid."""
    min_c, max_c, _ = vx.get_world_range(dimensions, voxel_size)
    n = int(np.prod(np.ceil((max_c - min_c) / voxel_size)))
    return layout == "blocks" or (layout == "auto" and
                                  n >= BLOCKS_FROM_VOXELS)


@dataclass
class TSDFVolumeBM:
    """The prior stored BLOCK-MAJOR: [n_blocks, 64] bricks of 4^3 voxels
    over the block grid ``nb_xyz`` (the last bricks of each axis padded past
    ``vol_dim``).  ``integrate_blocks`` updates only the bricks that meet
    the frustum; ``as_dense`` / ``bm_to_dense`` give the dense view."""

    sdf: torch.Tensor      # [NB, 64] float32, normalized units
    weight: torch.Tensor   # [NB, 64] float32
    origin: torch.Tensor   # [3] float32
    overflow: torch.Tensor  # 0-d int64: active blocks beyond max_blocks
    vol_dim: Tuple[int, int, int]
    nb_xyz: Tuple[int, int, int]
    color: Optional[torch.Tensor] = None   # [NB, 64, 3]


def create_tsdf_volume_bm(dimensions: np.ndarray, voxel_size: float = 0.025,
                          device: torch.device | str = "cpu",
                          with_color: bool = False
                          ) -> Tuple[TSDFVolumeBM, float]:
    """Block-major twin of ``create_tsdf_volume`` (same bounds and init).
    Returns (volume, trunc_margin)."""
    min_c, max_c, _ = vx.get_world_range(np.asarray(dimensions), voxel_size)
    vol_dim = tuple(int(v) for v in np.ceil((max_c - min_c) / voxel_size))
    nb = tuple((d + TSDF_BLOCK - 1) // TSDF_BLOCK for d in vol_dim)
    n_blocks = nb[0] * nb[1] * nb[2]
    trunc = 5.0 * voxel_size
    vol = TSDFVolumeBM(
        sdf=torch.full((n_blocks, _BS), -trunc, dtype=torch.float32,
                       device=device),
        weight=torch.zeros((n_blocks, _BS), dtype=torch.float32,
                           device=device),
        origin=torch.as_tensor(min_c, dtype=torch.float32, device=device),
        overflow=torch.zeros((), dtype=torch.int64, device=device),
        vol_dim=vol_dim, nb_xyz=nb,
        color=(torch.zeros((n_blocks, _BS, 3), dtype=torch.float32,
                           device=device) if with_color else None))
    return vol, trunc


def bm_to_dense(vol: TSDFVolumeBM, field: str = "sdf") -> torch.Tensor:
    """[NB, 64, ...] bricks -> a dense [X, Y, Z, ...] copy cropped to
    ``vol_dim``."""
    nbx, nby, nbz = vol.nb_xyz
    x = getattr(vol, field)
    tail = tuple(x.shape[2:])
    x = x.reshape((nbx, nby, nbz) + (TSDF_BLOCK,) * 3 + tail)
    perm = (0, 3, 1, 4, 2, 5) + tuple(range(6, 6 + len(tail)))
    x = x.permute(perm).reshape(
        (nbx * TSDF_BLOCK, nby * TSDF_BLOCK, nbz * TSDF_BLOCK) + tail)
    dx, dy, dz = vol.vol_dim
    return x[:dx, :dy, :dz].contiguous()


def dense_to_bm(vol: TSDFVolumeBM, dense: torch.Tensor) -> torch.Tensor:
    """Dense [X, Y, Z, ...] -> [NB, 64, ...] bricks (zero-padded to the
    block grid)."""
    nbx, nby, nbz = vol.nb_xyz
    dx, dy, dz = vol.vol_dim
    tail = tuple(dense.shape[3:])
    x = torch.zeros((nbx * TSDF_BLOCK, nby * TSDF_BLOCK, nbz * TSDF_BLOCK)
                    + tail, dtype=dense.dtype, device=dense.device)
    x[:dx, :dy, :dz] = dense
    x = x.reshape((nbx, TSDF_BLOCK, nby, TSDF_BLOCK, nbz, TSDF_BLOCK) + tail)
    perm = (0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + len(tail)))
    return x.permute(perm).reshape((nbx * nby * nbz, _BS) + tail)


def as_dense(vol):
    """Either layout as the dense ``TSDFVolume`` (a block-major volume is
    converted to new tensors; a dense one passes through)."""
    if isinstance(vol, TSDFVolumeBM):
        return TSDFVolume(
            sdf=bm_to_dense(vol, "sdf"), weight=bm_to_dense(vol, "weight"),
            origin=vol.origin,
            color=(bm_to_dense(vol, "color") if vol.color is not None
                   else None))
    return vol


def frustum_max_blocks(intr: np.ndarray, img_hw, max_depth: float,
                       voxel_size: float, nb_xyz) -> int:
    """Static bound on the 4^3 blocks one frame's frustum can meet (its
    pyramid volume plus a dilation of its surface by 2.5 blocks, + 64,
    x 1.3), capped at the block-grid size."""
    h, w = img_hw
    zmax = max_depth + 5.0 * voxel_size
    xs = (np.array([-0.5, w - 0.5]) - intr[0, 2]) / intr[0, 0]
    ys = (np.array([-0.5, h - 0.5]) - intr[1, 2]) / intr[1, 1]
    bx = voxel_size * TSDF_BLOCK
    wx = (xs[1] - xs[0]) * zmax
    wy = (ys[1] - ys[0]) * zmax
    vol_m3 = wx * wy * zmax / 3.0
    area_m2 = wx * wy + (xs[1] - xs[0] + ys[1] - ys[0]) * zmax * zmax
    n = (vol_m3 / bx ** 3) + 2.5 * (area_m2 / bx ** 2) + 64
    total = int(np.prod(nb_xyz))
    return min(int(np.ceil(n * 1.3)), total)


def frustum_blocks(vol: TSDFVolumeBM, img_hw, intr: torch.Tensor,
                   T_cw: torch.Tensor, voxel_size: float,
                   max_depth: float) -> torch.Tensor:
    """[n_blocks] bool: the bricks whose bounding sphere passes every side
    plane of the frustum (signed centre distance >= -radius, the planes
    widened by half a pixel for the rounded sampling) and the depth range.
    A brick it drops cannot receive an update.  (A pixel-margin test
    instead admits arbitrarily oblique far blocks and overran the block
    budget at the 790M-voxel scene in the JAX package.)"""
    nbx, nby, nbz = vol.nb_xyz
    h, w = img_hw
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    bid = torch.arange(nbx * nby * nbz, device=vol.sdf.device)
    bxyz = torch.stack([bid // (nby * nbz), (bid // nbz) % nby, bid % nbz],
                       dim=-1)
    half = 0.5 * voxel_size * (TSDF_BLOCK - 1)
    centers = bxyz.to(torch.float32) * TSDF_BLOCK * voxel_size + \
        vol.origin + half
    radius = voxel_size * TSDF_BLOCK * np.sqrt(3.0) / 2.0
    c_cam = centers @ T_cw[:3, :3].T + T_cw[:3, 3]
    x, y, z = c_cam[:, 0], c_cam[:, 1], c_cam[:, 2]
    zmax = max_depth + 5.0 * voxel_size
    in_z = (z + radius > 0) & (z - radius < zmax)
    xlo = (-0.5 - cx) / fx
    xhi = (w - 0.5 - cx) / fx
    ylo = (-0.5 - cy) / fy
    yhi = (h - 0.5 - cy) / fy
    return in_z & (
        ((x - xlo * z) >= -radius * torch.sqrt(1.0 + xlo * xlo)) &
        ((xhi * z - x) >= -radius * torch.sqrt(1.0 + xhi * xhi)) &
        ((y - ylo * z) >= -radius * torch.sqrt(1.0 + ylo * ylo)) &
        ((yhi * z - y) >= -radius * torch.sqrt(1.0 + yhi * yhi)))


def integrate_blocks(vol: TSDFVolumeBM, depth: torch.Tensor,
                     intr: torch.Tensor, T_wc: torch.Tensor,
                     voxel_size: float, max_blocks: int, max_depth: float,
                     obs_weight: float = 1.0,
                     rgb: Optional[torch.Tensor] = None) -> TSDFVolumeBM:
    """Fuse one frame into the bricks that meet its frustum
    (``frustum_blocks``), in place.  The per-voxel math is ``integrate``'s,
    and a brick the cull drops cannot receive an update, so the result is
    exact.  The active bricks, in ascending id, are compacted to
    ``max_blocks``; the excess is dropped and counted in ``vol.overflow``.
    Inside a profiler capture the cull, the compaction and the brick update
    are the spans ``fuse.prior.cull``, ``.compact`` and ``.bricks``, and
    ``max_blocks`` (the rows the update runs over, pads included) is the
    count ``fuse.prior.budget``; the active count is left out, since
    reading it would wait on the device."""
    trunc = 5.0 * voxel_size
    nbx, nby, nbz = vol.nb_xyz
    n_blocks = nbx * nby * nbz
    dev = vol.sdf.device
    h, w = depth.shape
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    profiling.count("fuse.prior.budget", max_blocks)
    with profiling.span("fuse.prior.cull"):
        T_cw = torch.linalg.inv(T_wc)
        active = frustum_blocks(vol, (h, w), intr, T_cw, voxel_size,
                                max_depth)

    # compact to max_blocks (ascending id; the pad entries sort last)
    with profiling.span("fuse.prior.compact"):
        bid = torch.arange(n_blocks, device=dev)
        n_active = active.sum()
        ids = torch.sort(torch.where(active, bid, n_blocks)).values[
            :max_blocks]
        a = ids.shape[0]
        pos = torch.arange(a, device=dev)
        n_in = torch.clamp(n_active, max=a)
        amask = pos < n_in
        ids_safe = torch.clamp(ids, max=n_blocks - 1)

    # the per-voxel update on the gathered bricks (integrate's math)
    with profiling.span("fuse.prior.bricks"):
        abxyz = torch.stack([ids_safe // (nby * nbz),
                             (ids_safe // nbz) % nby,
                             ids_safe % nbz], dim=-1)                # [A, 3]
        li = torch.arange(_BS, device=dev)
        lxyz = torch.stack([li // 16, (li // 4) % 4, li % 4], dim=-1)
        world = (abxyz[:, None, :] * TSDF_BLOCK + lxyz[None]).to(
            torch.float32) * voxel_size + vol.origin             # [A, 64, 3]
        cam = world @ T_cw[:3, :3].T + T_cw[:3, 3]
        zv = cam[..., 2]
        safe_zv = torch.where(torch.abs(zv) > 1e-8, zv,
                              torch.full((), 1e-8, device=dev))
        pxi = torch.round(cam[..., 0] * fx / safe_zv + cx)
        pyi = torch.round(cam[..., 1] * fy / safe_zv + cy)
        in_view = (pxi >= 0) & (pxi < w) & (pyi >= 0) & (pyi < h) & (zv > 0)
        flat = (torch.clamp(pyi, 0, h - 1) * w +
                torch.clamp(pxi, 0, w - 1)).long()
        zero = torch.zeros((), device=dev)
        depth_val = torch.where(in_view, depth.reshape(-1)[flat], zero)
        depth_diff = depth_val - zv
        valid = (depth_val > 0) & (depth_diff >= -trunc) & amask[:, None]
        dist = torch.clamp(depth_diff / trunc, max=1.0)

        sdf_rows = vol.sdf[ids_safe]
        w_rows = vol.weight[ids_safe]
        w_new = w_rows + obs_weight
        sdf_new = (w_rows * sdf_rows + obs_weight * dist) / w_new
        out = [torch.where(valid, sdf_new, sdf_rows),
               torch.where(valid, w_new, w_rows)]
        if vol.color is not None and rgb is not None:
            rgb_val = torch.where(valid[..., None],
                                  rgb.reshape(-1, 3).to(torch.float32)[flat],
                                  zero)
            c_rows = vol.color[ids_safe]
            # the running mean with the sdf's weights (w_rows the old weight)
            out.append(torch.where(
                valid[..., None],
                (w_rows[..., None] * c_rows + obs_weight * rgb_val) /
                torch.clamp(w_new, min=1e-12)[..., None], c_rows))

        # The pad entries all point at the last brick.  They write what the
        # real entry of that brick writes where it is active, and its
        # unchanged rows where it is not, so every write to it agrees: the
        # pads are dropped without reading n_active on the host.
        last = torch.clamp(n_in - 1, min=0)
        last_is_real = (n_in > 0) & (ids_safe[last] == n_blocks - 1)
        src = torch.where(amask | ~last_is_real, pos, last)
        vol.sdf[ids_safe] = out[0][src]
        vol.weight[ids_safe] = out[1][src]
        if len(out) > 2:
            vol.color[ids_safe] = out[2][src]
        vol.overflow += torch.clamp(n_active - max_blocks, min=0)
    return vol
