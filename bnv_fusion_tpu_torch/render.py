"""Differentiable SDF rendering along camera rays + the fusion loss.

Counterpart of bnv_fusion_tpu/render.py:21-283.  Randomness is explicit: the
sampling functions take their uniforms as tensors, drawn by
``draw_sampling_uniforms`` from a ``torch.Generator`` (or injected by a test
from the JAX package's draws).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bnv_fusion_tpu_torch import fusion, geometry, voxel


class Rays(NamedTuple):
    """One batch of supervision rays."""

    uv: torch.Tensor              # [N, 2] float32 pixel coords
    gt_pts: torch.Tensor          # [N, 3] world surface points
    mask: torch.Tensor            # [N] float32 validity
    neighbor_pts: torch.Tensor    # [N, K, 3] pixel-window world points
    neighbor_masks: torch.Tensor  # [N, K] float32
    T_wc: torch.Tensor            # [4, 4]
    intr: torch.Tensor            # [3, 3]


def _linspace01(n: int, device) -> torch.Tensor:
    """linspace(0, 1, n) with the values jnp.linspace gives (i * step, last
    element exactly 1)."""
    step = np.float32(1.0 / (n - 1)) if n > 1 else np.float32(0.0)
    out = torch.arange(n, dtype=torch.float32, device=device) * float(step)
    if n > 1:
        out[-1] = 1.0
    return out


def stratified_sampling(n_samples: int, distances: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """Stratified distances in [0, d] per ray: [N, 1] -> [N, S, 1]; ``t``
    [N, S] uniforms jitter each sample inside its mid-point interval."""
    ticks = _linspace01(n_samples, distances.device)[None, :] * distances
    mids = 0.5 * (ticks[:, 1:] + ticks[:, :-1])
    upper = torch.cat([mids, ticks[:, -1:]], dim=-1)
    lower = torch.cat([ticks[:, :1], mids], dim=-1)
    return (lower + (upper - lower) * t)[..., None]


def draw_sampling_uniforms(generator: torch.Generator, n_rays: int,
                           n_fine: int, n_coarse: int,
                           device: torch.device | str = "cpu"):
    """The (fine, coarse) jitter uniforms hierarchical_sampling consumes,
    drawn from ``generator`` on its own device and moved to ``device``."""
    t_fine = torch.rand((n_rays, n_fine), generator=generator)
    t_coarse = torch.rand((n_rays, n_coarse), generator=generator)
    return t_fine.to(device), t_coarse.to(device)


def hierarchical_sampling(n_fine: int, n_coarse: int, depths: torch.Tensor,
                          surface: torch.Tensor, ray_dirs: torch.Tensor,
                          cam_loc: torch.Tensor, offset_distance: float,
                          ts: Tuple[torch.Tensor, torch.Tensor]):
    """Fine samples in a +-offset band around the surface + coarse samples
    from the camera, merged sorted.  depths [N], surface [N, 3]; ``ts`` =
    (fine [N, n_fine], coarse [N, n_coarse]) uniforms.  Returns (pts
    [N, S, 3], dists [N, S, 1])."""
    t_fine, t_coarse = ts
    negative_offset = torch.where(depths - offset_distance < 0, depths,
                                  torch.full_like(depths, offset_distance))
    start_pts = surface - negative_offset[:, None] * ray_dirs
    start_depths = torch.linalg.norm(start_pts - cam_loc[None, :], dim=-1)
    fine = stratified_sampling(
        n_fine, torch.full_like(depths, 2.0 * offset_distance)[:, None], t_fine)
    fine = fine + start_depths[:, None, None]
    coarse = stratified_sampling(n_coarse, depths[:, None], t_coarse)
    dists = torch.sort(torch.cat([fine, coarse], dim=1), dim=1).values
    pts = cam_loc[None, None, :] + dists * ray_dirs[:, None, :]
    return pts, dists


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling along rays: bins [N, B], weights
    [N, B-1] -> samples [N, n_samples].  ``u`` [N, n_samples] uniforms;
    None = deterministic linspace(0, 1)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    n = cdf.shape[0]
    if u is None:
        u = _linspace01(n_samples, cdf.device).expand(n, n_samples)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bins_lo = torch.gather(bins, -1, torch.clamp(below, max=nb))
    bins_hi = torch.gather(bins, -1, torch.clamp(above, max=nb))
    denom = torch.where(cdf_hi - cdf_lo < 1e-5, torch.ones_like(cdf_hi),
                        cdf_hi - cdf_lo)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


def _sample_along_rays(rays: Rays, ts, truncated_units: int,
                       truncated_dist: float, ray_max_dist: float,
                       n_fine: int, n_coarse: int):
    """The rays' sample points [N, S, 3] (0 counts keep the reference
    formula: fine = 2 * truncated_units, coarse = 5 * ray_max_dist) and the
    camera centre."""
    ray_dirs, cam_loc = geometry.get_camera_rays(rays.uv, rays.T_wc, rays.intr)
    gt_depths = torch.linalg.norm(rays.gt_pts - cam_loc[None, :], dim=-1)
    pts, _ = hierarchical_sampling(
        n_fine or truncated_units * 2, n_coarse or int(ray_max_dist * 5),
        gt_depths, rays.gt_pts, ray_dirs, cam_loc,
        offset_distance=truncated_dist, ts=ts)
    return pts, cam_loc


def prepare_render(table, rays: Rays, bound_min, voxel_size: float,
                   truncated_units: int, truncated_dist: float,
                   ray_max_dist: float, sdf_delta: Optional[torch.Tensor],
                   n_xyz, ts: Tuple[torch.Tensor, torch.Tensor],
                   n_fine: int = 0, n_coarse: int = 0,
                   weights: Optional[torch.Tensor] = None, rows=None):
    """Feature-independent half of rendering: sampling + decode prep.
    ``n_fine`` / ``n_coarse`` = 0 keep the reference formula (fine =
    2 * truncated_units, coarse = 5 * ray_max_dist).  ``rows`` is the
    corner-row hook of a region-sharded table (``fusion.decode_prepare``).
    Returns (prep, pts, cam_loc)."""
    pts, cam_loc = _sample_along_rays(rays, ts, truncated_units,
                                      truncated_dist, ray_max_dist, n_fine,
                                      n_coarse)
    n, s = pts.shape[:2]
    prep = fusion.decode_prepare(table, pts.reshape(n * s, 3), bound_min,
                                 voxel_size, sdf_delta=sdf_delta, n_xyz=n_xyz,
                                 weights=weights, rows=rows)
    return prep, pts, cam_loc


def compute_sdf_loss(rays: Rays, pred_sdf: torch.Tensor,
                     pred_pts: torch.Tensor, cam_loc: torch.Tensor,
                     truncated_dist: float, per_ray: bool = False,
                     reduce: str = "mean"):
    """Neighbourhood-corrected truncated L1 SDF loss, masked mean over
    rays.  ``per_ray`` also returns each ray's summed error [N] (the
    error-guided sampler's input).  ``reduce="sum"`` returns (summed error,
    valid-ray count) instead: the ray-sharded DP step all-reduces both, so
    the global masked mean matches one device's."""
    gt_depths = torch.linalg.norm(rays.gt_pts - cam_loc[None, :], dim=-1,
                                  keepdim=True)
    depths = torch.linalg.norm(pred_pts - cam_loc[None, None, :], dim=-1)
    gt_sdf = torch.clamp(gt_depths - depths, -truncated_dist, truncated_dist)
    valid_map = gt_sdf > max(-truncated_dist * 0.5, -0.05)
    d = torch.linalg.norm(
        rays.neighbor_pts[:, None, :, :] - pred_pts[:, :, None, :], dim=-1)
    d = torch.where(rays.neighbor_masks[:, None, :] > 0, d,
                    torch.full((), 1e4, device=d.device))
    nearest = torch.amin(d, dim=-1)
    sign = torch.where(gt_sdf > 0, 1.0, -1.0)
    gt_nearest_signed = torch.clamp(nearest * sign, -truncated_dist,
                                    truncated_dist)
    num_valid = torch.sum(rays.mask) + 1e-4
    l1 = torch.abs(pred_sdf - gt_nearest_signed) * valid_map
    ray_err = torch.sum(l1, dim=-1) * rays.mask
    if reduce == "sum":
        return torch.sum(ray_err), torch.sum(rays.mask)
    loss = torch.sum(ray_err) / num_valid
    if per_ray:
        return loss, ray_err
    return loss


def eval_render_loss(gathered_feats: torch.Tensor, prep, params: Dict[str, Any],
                     rays: Rays, pts: torch.Tensor, cam_loc: torch.Tensor,
                     voxel_size: float, min_pts_in_grid: int,
                     truncated_dist: float,
                     compute_dtype: torch.dtype = torch.float32,
                     per_ray: bool = False, reduce: str = "mean"):
    """Differentiable tail: gathered feature rows -> chunk loss (with
    ``per_ray`` and ``reduce`` as in ``compute_sdf_loss``)."""
    n, s = pts.shape[:2]
    pred = fusion.decode_eval(gathered_feats, prep, params, voxel_size,
                              min_pts_in_grid,
                              compute_dtype=compute_dtype).reshape(n, s)
    return compute_sdf_loss(rays, pred, pts, cam_loc, truncated_dist,
                            per_ray=per_ray, reduce=reduce)


def composite_occupancy(pts: torch.Tensor, occupied_prob: torch.Tensor,
                        dists: torch.Tensor):
    """Expected surface point from per-sample occupancy along rays, by
    front-to-back compositing of pass-through probabilities (counterpart of
    bnv_fusion_tpu/render.py:130-145).  pts [N, S, 3], occupied_prob
    [N, S], dists [N, S, 1] (unused, as there).  Returns (expected_pts
    [N, 3], depth_prob [N, S], background_prob [N])."""
    del dists
    passthrough = torch.cumprod(1.0 - occupied_prob, dim=-1)
    passthrough = torch.cat([torch.ones_like(passthrough[..., :1]),
                             passthrough], dim=-1)
    depth_prob = passthrough[..., :-1] * occupied_prob
    expected = torch.sum(depth_prob[..., None] * pts, dim=-2)
    return expected, depth_prob, passthrough[..., -1]


def render_rays_sdf(features: torch.Tensor, table, params: Dict[str, Any],
                    rays: Rays, ts: Tuple[torch.Tensor, torch.Tensor],
                    bound_min, voxel_size: float, min_pts_in_grid: int,
                    truncated_units: int, truncated_dist: float,
                    ray_max_dist: float, sdf_delta: Optional[torch.Tensor],
                    n_xyz, compute_dtype: torch.dtype = torch.float32,
                    decode_layout: str = "rows", n_fine: int = 0,
                    n_coarse: int = 0):
    """Sample the rays (jitter ``ts``, as in ``prepare_render``) and decode
    their SDF through ``fusion.decode_points`` in ``decode_layout``.
    Returns (pred_sdf [N, S], pts [N, S, 3], cam_loc [3], the samples'
    corner coords [N*S, 8, 3] for the count_optim bump)."""
    pts, cam_loc = _sample_along_rays(rays, ts, truncated_units,
                                      truncated_dist, ray_max_dist, n_fine,
                                      n_coarse)
    n, s = pts.shape[:2]
    flat_pts = pts.reshape(n * s, 3)
    corners = voxel.corner_neighbors(
        voxel.position_to_coords(flat_pts, bound_min, voxel_size))
    pred = fusion.decode_points(
        features, table, params, flat_pts, bound_min, voxel_size,
        min_pts_in_grid, sdf_delta=sdf_delta, n_xyz=n_xyz,
        compute_dtype=compute_dtype, layout=decode_layout)
    return pred.reshape(n, s), pts, cam_loc, corners


def calculate_loss(features: torch.Tensor, table, params: Dict[str, Any],
                   rays: Rays, ts: Tuple[torch.Tensor, torch.Tensor],
                   bound_min, voxel_size: float, min_pts_in_grid: int,
                   truncated_units: int, truncated_dist: float,
                   ray_max_dist: float, sdf_delta: Optional[torch.Tensor],
                   n_xyz, compute_dtype: torch.dtype = torch.float32,
                   per_ray: bool = False, decode_layout: str = "rows"):
    """Loss of one ray chunk and the corner coords to weight-bump; with
    ``per_ray`` the second value is (corners, per-ray errors)."""
    pred_sdf, pts, cam_loc, corners = render_rays_sdf(
        features, table, params, rays, ts, bound_min, voxel_size,
        min_pts_in_grid, truncated_units, truncated_dist, ray_max_dist,
        sdf_delta, n_xyz, compute_dtype, decode_layout=decode_layout)
    if per_ray:
        loss, ray_err = compute_sdf_loss(rays, pred_sdf, pts, cam_loc,
                                         truncated_dist, per_ray=True)
        return loss, (corners, ray_err)
    return compute_sdf_loss(rays, pred_sdf, pts, cam_loc,
                            truncated_dist), corners
