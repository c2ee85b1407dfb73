"""Global-level fusion: render-loss optimization of the sparse volume latents.

Counterpart of bnv_fusion_tpu/optimize.py:38-258 and the early-stop rule
of bnv_fusion_tpu/pipeline.py:995-1059.  One step samples rays
from a depth frame, splits them into chunks, differentiates each chunk's
loss with respect to the GATHERED latent rows (sparse cotangents, via
``torch.autograd``), bumps the decode-mask weights of the touched voxels
(count_optim), sort-reduces the cotangents into one gradient and applies one
Adam update — optax.adam exactly (b1 0.9, b2 0.999, eps 1e-8, bias
corrected), scaled by ``lr_scale``.

Chunk schedules: ``parallel_chunks=True`` runs every chunk against the
iteration-start weights and sums their bumps; False threads the bumped
weights through the chunks in order (the reference's sequential schedule).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bnv_fusion_tpu_torch import fusion, geometry, render, sampler


@dataclass
class OptimState:
    features: torch.Tensor   # [C, F] the trainable latents
    weights: torch.Tensor    # [C] decode-mask weights (bumped, not trained)
    mu: torch.Tensor         # Adam first moment [C, F]
    nu: torch.Tensor         # Adam second moment [C, F]
    count: int = 0           # Adam step count


def init_optim_state(table) -> OptimState:
    """Fresh Adam state over copies of the table's features and weights."""
    return OptimState(features=table.features.clone(),
                      weights=table.weights.clone(),
                      mu=torch.zeros_like(table.features),
                      nu=torch.zeros_like(table.features))


def build_rays_from_frame(depth: torch.Tensor, T_wc: torch.Tensor,
                          intr: torch.Tensor, max_depth: float, n_rays: int,
                          neighbor_kernel: int = 3,
                          pixel_ids: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> render.Rays:
    """Rays from one depth frame: back-project, take ``pixel_ids`` (or draw
    ``n_rays`` distinct pixels from ``generator``), gather the
    neighbour window."""
    h, w = depth.shape
    dev = depth.device
    mask = (depth > 0) & (depth < max_depth)
    xyz_cam = geometry.depth_to_xyz(depth, intr)
    xyz_w = geometry.transform_points(T_wc, xyz_cam.reshape(-1, 3))
    xyz_map_w = xyz_w.reshape(h, w, 3)
    if pixel_ids is None:
        pixel_ids = torch.randperm(h * w, generator=generator)[:n_rays]
    idx = pixel_ids.to(dev).long()
    uv = torch.stack([(idx % w).to(torch.float32),
                      torch.div(idx, w, rounding_mode="floor")
                      .to(torch.float32)], dim=-1)
    neighbor_pts, neighbor_masks = geometry.gather_pixel_neighborhoods(
        xyz_map_w, mask, uv.long(), neighbor_kernel)
    return render.Rays(uv=uv, gt_pts=xyz_w[idx],
                       mask=mask.reshape(-1)[idx].to(torch.float32),
                       neighbor_pts=neighbor_pts,
                       neighbor_masks=neighbor_masks.to(torch.float32),
                       T_wc=T_wc, intr=intr)


def _adam_update(state: OptimState, grads: torch.Tensor, lr: float,
                 lr_scale: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
    """optax.adam(lr) in float32 arithmetic, then * lr_scale; in place."""
    state.count += 1
    state.mu = (1 - b1) * grads + b1 * state.mu
    state.nu = (1 - b2) * (grads * grads) + b2 * state.nu
    f32 = np.float32
    bc1 = float(f32(1) - f32(b1) ** f32(state.count))
    bc2 = float(f32(1) - f32(b2) ** f32(state.count))
    upd = (state.mu / bc1) / (torch.sqrt(state.nu / bc2) + eps)
    upd = upd * (-lr)
    state.features = state.features + upd * lr_scale


def make_optimize_step(params: Dict[str, Any], voxel_size: float,
                       min_pts_in_grid: int, truncated_units: int,
                       truncated_dist: float, ray_max_dist: float,
                       n_rays: int, train_ray_splits: int, lr: float = 1e-3,
                       compute_dtype: torch.dtype = torch.float32,
                       neighbor_kernel: int = 3, error_guided: bool = False,
                       decode_layout: str = "rows",
                       parallel_chunks: bool = False,
                       n_fine: int = 0, n_coarse: int = 0,
                       grad_scatter: str = "sortreduce", rows=None):
    """Build ``step(state, table, depth, T_wc, intr, bound_min, n_xyz,
    sdf_delta, generator=None, pixel_ids=None, uniforms=None, lr_scale=1.0,
    error_map=None, pixel_generator=None) -> (state, loss)``.

    The step updates ``state`` in place.  ``pixel_ids`` [n_rays] and
    ``uniforms`` (one (fine, coarse) pair per chunk) replace the draws from
    ``generator``.  ``compute_dtype`` rounds the decoder's operands in the
    loss (``model.optim_dtype``); the latents and the Adam state stay
    float32.  With ``error_guided`` the step takes the frame's patch error
    map, draws the pixels with ``sampler.sample_pixels`` from
    ``pixel_generator`` (a generator on the map's device) unless
    ``pixel_ids`` are given, and returns ``(state, loss, new_map)``: the
    map updated with every chunk's per-ray errors, in chunk order.
    ``decode_layout`` is accepted and unused, as in the JAX package's
    single-device step: the loss always decodes in the rows layout.
    ``rows`` is the corner-row hook of a region-sharded table
    (``parallel.spatial.OwnerRows``): the chunks' corner
    rows come assembled over the ranks, and the count_optim bump and the
    gradient rows go to the corners this rank's shard holds."""
    del decode_layout
    if n_rays % train_ray_splits:
        raise ValueError("n_rays must be a multiple of train_ray_splits")
    n_chunks = n_rays // train_ray_splits
    nf = n_fine or truncated_units * 2
    nc = n_coarse or int(ray_max_dist * 5)

    def step(state: OptimState, table, depth, T_wc, intr, bound_min, n_xyz,
             sdf_delta, generator: Optional[torch.Generator] = None,
             pixel_ids: Optional[torch.Tensor] = None,
             uniforms: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
             lr_scale: float = 1.0, error_map: Optional[torch.Tensor] = None,
             pixel_generator: Optional[torch.Generator] = None):
        dev = depth.device
        if error_guided and pixel_ids is None:
            pixel_ids = sampler.sample_pixels(
                pixel_generator or generator, error_map, depth.shape, n_rays)
        rays = build_rays_from_frame(depth, T_wc, intr, ray_max_dist, n_rays,
                                     neighbor_kernel=neighbor_kernel,
                                     pixel_ids=pixel_ids, generator=generator)
        if uniforms is None:
            uniforms = [render.draw_sampling_uniforms(
                generator, train_ray_splits, nf, nc, dev)
                for _ in range(n_chunks)]
        cap = state.features.shape[0]
        w0 = state.weights
        weights = w0
        bump_sum = torch.zeros_like(w0)
        losses, ray_errs, gidx_all, grows_all = [], [], [], []
        for c in range(n_chunks):
            sl = slice(c * train_ray_splits, (c + 1) * train_ray_splits)
            chunk = render.Rays(
                uv=rays.uv[sl], gt_pts=rays.gt_pts[sl], mask=rays.mask[sl],
                neighbor_pts=rays.neighbor_pts[sl],
                neighbor_masks=rays.neighbor_masks[sl], T_wc=T_wc, intr=intr)
            w_in = w0 if parallel_chunks else weights
            prep, pts, cam_loc = render.prepare_render(
                table, chunk, bound_min, voxel_size, truncated_units,
                truncated_dist, ray_max_dist, sdf_delta, n_xyz,
                ts=uniforms[c], n_fine=n_fine, n_coarse=n_coarse,
                weights=w_in, rows=rows)
            gfeats = fusion.corner_rows(state.features, prep,
                                        rows).detach().requires_grad_(True)
            with torch.enable_grad():
                out = render.eval_render_loss(
                    gfeats, prep, params, chunk, pts, cam_loc, voxel_size,
                    min_pts_in_grid, truncated_dist,
                    compute_dtype=compute_dtype, per_ray=error_guided)
                loss = out[0] if error_guided else out
                (g_rows,) = torch.autograd.grad(loss, gfeats)
            if error_guided:
                ray_errs.append(out[1].detach())
            held = prep.found if rows is None else prep.owned
            bumped = fusion.bump_optim_weights(w_in, prep.slots, held)
            if parallel_chunks:
                bump_sum = bump_sum + (bumped - w0)
            else:
                weights = bumped
            losses.append(loss.detach())
            gidx_all.append(torch.where(held, prep.slots, cap))
            grows_all.append(g_rows)
        state.weights = w0 + bump_sum if parallel_chunks else weights
        grads = fusion.scatter_add_rows(torch.cat(gidx_all),
                                        torch.cat(grows_all), cap,
                                        method=grad_scatter)
        _adam_update(state, grads, lr, float(lr_scale))
        loss = torch.stack(losses).mean()
        if error_guided:
            return state, loss, sampler.update_error_map(
                error_map, depth.shape, pixel_ids, torch.cat(ray_errs))
        return state, loss

    return step


class EarlyStop:
    """``trainer.optim_early_stop``'s rule over launch groups (counterpart
    of bnv_fusion_tpu/pipeline.py:1046-1059): ``update`` takes one full
    group's losses (device tensors or floats) and returns True once the
    loop should stop.  A group's mean is read one group late: it waits
    until the next group is queued, so the read does not stall the queue,
    and the last group is never judged.  The best mean improves only below
    best * (1 - rel); ``patience`` judged groups in a row without that end
    the loop."""

    def __init__(self, rel: float, patience: int):
        self.rel, self.patience = float(rel), int(patience)
        self.best, self.stale = float("inf"), 0
        self._pending: List[Any] = []

    def update(self, group_losses) -> bool:
        self._pending.append(group_losses)
        if len(self._pending) < 2:
            return False
        val = float(torch.stack([torch.as_tensor(x, dtype=torch.float32)
                                 for x in self._pending.pop(0)]).mean())
        if val < self.best * (1.0 - self.rel):
            self.best, self.stale = val, 0
        else:
            self.stale += 1
        return self.stale >= self.patience
