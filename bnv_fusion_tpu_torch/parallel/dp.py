"""Data-parallel fusion, optimization and pretraining over a ``DPGroup``.

Counterpart of bnv_fusion_tpu/parallel/dp.py:36-375.  The JAX package runs
these steps as ``shard_map`` over a 1-D mesh in one process; here every rank
(one process each) calls the same step on the same replicated inputs, takes
its contiguous shard of the sharded axis (``DPGroup.shard``, how ``P(axis)``
splits it), and meets the other ranks in ``DPGroup``'s collectives.  Every
rank keeps the full replicated table.  The updates after a collective are
deterministic functions of identical inputs (stable sorts, integer
cumsums, scatters without duplicate indices), so the replicas stay
bit-identical.  The gradient sort-reduce (``fusion.scatter_add_rows``) may
fall back to ``index_add_``, whose CUDA atomics sum in no fixed order, but
it runs before the gradient all-reduce, whose result every rank receives
alike.

* ``make_sharded_fuse_frame``: points sharded; each rank runs the
  cell-keyed sort-reduce on its shard, the compacted partials (key, count,
  feature sum; [U] rows each) are all-gathered, merged by one stable sort,
  and folded into the table once per replica.
* ``make_sharded_optimize_iter``: one iteration of the single-device
  optimize step with the rays of each chunk sharded; per-chunk error sums
  and valid counts are summed across ranks into the global masked mean,
  the count_optim bumps take the MAX, and the gradient is summed once per
  iteration before the replicated Adam update.
* ``make_sharded_optimize_step``: the older per-chunk step on
  ``render.calculate_loss``.
* ``make_sharded_pretrain_step``: the patch batch sharded; gradients, loss
  and logs averaged across ranks, one optimizer step per replica.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import torch

from bnv_fusion_tpu_torch import fusion, optimize, render
from bnv_fusion_tpu_torch import tables as tbl
from bnv_fusion_tpu_torch.parallel.mesh import DPGroup


def make_sharded_fuse_frame(group: DPGroup, params: Dict[str, Any],
                            voxel_size: float, min_pts_in_grid: int,
                            example_table, max_unique: int = 1 << 17,
                            max_unique_cells: Optional[int] = None,
                            compute_dtype: torch.dtype = torch.float32):
    """The fuse step with points sharded over ``group``:
    ``step(table, pts_w [N, 3], normals [N, 3], valid [N], bound_min,
    bound_max) -> FrameStats``, updating ``table`` in place; N must divide
    by the group's size.  Each rank's shard goes through
    ``fusion._cellsort_reduce`` (the per-frame cumsum front); the compacted
    partials are all-gathered ([D, U] keys and counts, [D, U, F] sums) and
    merged by one stable sort on the key, counts through an exact int
    cumsum and feature sums as windowed adds of at most D entries (a voxel
    appears at most once per rank), in the JAX package's order.  min_pts
    applies to the merged count.  Slot-map tables (dense, blocks) only."""
    if not hasattr(example_table, "n_voxels"):
        raise ValueError(
            "sharded fusion requires a slot-map table (dense/blocks) — the "
            "same routing as the single-chip sort-reduce fast path")
    n_dev = group.size

    def step(table, pts_w, normals, valid, bound_min, bound_max
             ) -> fusion.FrameStats:
        fdim, n_vox = table.feat_dims, table.n_voxels
        dev = pts_w.device
        sl = group.shard(pts_w.shape[0])
        (flat_u, cnt_u, sum_u, umask, n_unique, u, cells_dropped,
         n_valid) = fusion._cellsort_reduce(
            params, pts_w[sl], normals[sl], valid[sl], bound_min, bound_max,
            voxel_size, max_unique, max_unique_cells, table.n_xyz, n_vox,
            fdim, compute_dtype=compute_dtype)

        key = torch.where(umask, flat_u, n_vox)
        m3 = n_dev * u
        ck = group.all_gather(key).reshape(m3)
        cc = group.all_gather(cnt_u).reshape(m3).to(torch.int64)
        cs = group.all_gather(sum_u).reshape(m3, fdim)
        order = torch.argsort(ck, stable=True)
        ck_s, cc_s, cs_s = ck[order], cc[order], cs[order]

        ev = ck_s < n_vox
        ccum = torch.cumsum(cc_s, 0)                        # exact ints
        is_end = fusion._append(ck_s != fusion._prepend(ck_s, -1), True) & ev
        n_uni = is_end.sum().to(torch.int32)
        ub = min(max_unique, m3)
        end = torch.clamp(fusion._compact_ends(is_end, ub), max=m3 - 1)
        bmask = torch.arange(ub, device=dev) < torch.clamp(n_uni, max=ub)
        pend = fusion._prepend(end, -1)
        flat_b = ck_s[end]
        clo = torch.where(pend >= 0, ccum[pend.clamp(min=0)], 0)
        cnt_b = (ccum[end] - clo).to(torch.float32)
        seg_len = end - pend
        zero = torch.zeros((), device=dev)
        S = torch.zeros((ub, fdim), dtype=torch.float32, device=dev)
        for i in range(n_dev):
            take = torch.clamp(end - i, min=0)
            S = S + torch.where((i < seg_len)[:, None], cs_s[take], zero)

        dropped = group.all_reduce(
            (torch.clamp(n_unique - u, min=0) + cells_dropped).to(torch.int64))
        stats = fusion._integrate_unique(
            table, flat_b, cnt_b, S, bmask, n_uni, ub, min_pts_in_grid,
            extra_overflow=dropped)
        return stats._replace(n_valid_pts=group.all_reduce(n_valid))

    return step


def _chunk(rays: render.Rays, sl) -> render.Rays:
    """The rows ``sl`` of a ray batch (pose and intrinsics shared)."""
    return render.Rays(uv=rays.uv[sl], gt_pts=rays.gt_pts[sl],
                       mask=rays.mask[sl], neighbor_pts=rays.neighbor_pts[sl],
                       neighbor_masks=rays.neighbor_masks[sl],
                       T_wc=rays.T_wc, intr=rays.intr)


def _bump(slots: torch.Tensor, found: torch.Tensor, cap: int) -> torch.Tensor:
    """1.0 on every slot touched (the amax scatter of the count_optim bump;
    duplicate indices write the same value), [cap]."""
    bump = torch.zeros((cap + 1,), dtype=torch.float32, device=slots.device)
    bump[torch.where(found, slots, cap)] = 1.0
    return bump[:cap]


def make_sharded_optimize_iter(group: DPGroup, params: Dict[str, Any],
                               voxel_size: float, min_pts_in_grid: int,
                               truncated_units: int, truncated_dist: float,
                               ray_max_dist: float, n_rays: int,
                               train_ray_splits: int, example_table=None,
                               lr: float = 1e-3, neighbor_kernel: int = 3,
                               n_fine: int = 0, n_coarse: int = 0,
                               compute_dtype: torch.dtype = torch.float32,
                               grad_scatter: str = "sortreduce"):
    """Ray-DP version of ``optimize.make_optimize_step``'s iteration (its
    sequential chunk schedule): ``step(state, table, depth, T_wc, intr,
    bound_min, n_xyz, sdf_delta, generator=None, pixel_ids=None,
    uniforms=None, lr_scale=1.0) -> (state, loss)``, updating ``state`` in
    place; ``NeuralMap.optimize`` takes it when
    ``trainer.optimize_devices`` > 1.  Every rank builds the full ray set
    and every chunk's uniforms from the same generator state (or takes the
    injected ``pixel_ids`` / ``uniforms``) and keeps its row shard of each
    chunk, so ``train_ray_splits`` must divide by the group's size.  Per
    chunk the summed error and the valid count are all-reduced, the row
    cotangents divided by the global denominator, and the bump's MAX over
    the ranks added in chunk order; the gradient is sort-reduced locally and
    summed once per iteration, then one replicated Adam update at
    ``lr * lr_scale``.  Differs from the single-device step in float
    reduction order only.  ``example_table`` is accepted for the JAX
    package's signature (its shard specs) and unused."""
    del example_table
    if n_rays % train_ray_splits:
        raise ValueError("n_rays must be a multiple of train_ray_splits")
    if train_ray_splits % group.size:
        raise ValueError(
            f"train_ray_splits={train_ray_splits} must divide over the "
            f"{group.size}-device mesh")
    n_chunks = n_rays // train_ray_splits
    nf = n_fine or truncated_units * 2
    nc = n_coarse or int(ray_max_dist * 5)
    rows = group.shard(train_ray_splits)

    def step(state: optimize.OptimState, table, depth, T_wc, intr, bound_min,
             n_xyz, sdf_delta, generator: Optional[torch.Generator] = None,
             pixel_ids: Optional[torch.Tensor] = None,
             uniforms: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
             lr_scale: float = 1.0):
        dev = depth.device
        rays = optimize.build_rays_from_frame(
            depth, T_wc, intr, ray_max_dist, n_rays,
            neighbor_kernel=neighbor_kernel, pixel_ids=pixel_ids,
            generator=generator)
        if uniforms is None:
            uniforms = [render.draw_sampling_uniforms(
                generator, train_ray_splits, nf, nc, dev)
                for _ in range(n_chunks)]
        cap = state.features.shape[0]
        weights = state.weights
        losses, gidx_all, grows_all = [], [], []
        for c in range(n_chunks):
            lo = c * train_ray_splits
            chunk = _chunk(rays, slice(lo + rows.start, lo + rows.stop))
            ts = (uniforms[c][0][rows], uniforms[c][1][rows])
            prep, pts, cam_loc = render.prepare_render(
                table, chunk, bound_min, voxel_size, truncated_units,
                truncated_dist, ray_max_dist, sdf_delta, n_xyz, ts=ts,
                n_fine=n_fine, n_coarse=n_coarse, weights=weights)
            gfeats = state.features[prep.slots].detach().requires_grad_(True)
            with torch.enable_grad():
                err_sum, n_valid = render.eval_render_loss(
                    gfeats, prep, params, chunk, pts, cam_loc, voxel_size,
                    min_pts_in_grid, truncated_dist,
                    compute_dtype=compute_dtype, reduce="sum")
                (g_rows,) = torch.autograd.grad(err_sum, gfeats)
            tot = group.all_reduce(torch.stack([err_sum.detach(), n_valid]))
            denom = tot[1] + 1e-4
            losses.append(tot[0] / denom)
            weights = weights + group.all_reduce(
                _bump(prep.slots, prep.found, cap), "max")
            gidx_all.append(torch.where(prep.found, prep.slots, cap))
            grows_all.append(g_rows / denom)
        state.weights = weights
        grads = fusion.scatter_add_rows(torch.cat(gidx_all),
                                        torch.cat(grows_all), cap,
                                        method=grad_scatter)
        optimize._adam_update(state, group.all_reduce(grads), lr,
                              float(lr_scale))
        return state, torch.stack(losses).mean()

    return step


def make_sharded_optimize_step(group: DPGroup, params: Dict[str, Any],
                               voxel_size: float, min_pts_in_grid: int,
                               truncated_units: int, truncated_dist: float,
                               ray_max_dist: float, example_table=None,
                               lr: float = 1e-3):
    """The older global-fusion step with rays sharded over ``group``:
    ``step(state, table, rays, bound_min, n_xyz, sdf_delta, generator=None,
    uniforms=None) -> (state, loss)``, updating ``state`` in place.  Each
    rank takes its contiguous shard of the rays (whose count must divide by
    the group's size), computes ``render.calculate_loss`` on it against
    ``state.weights`` with the jitter drawn from ``generator`` (which the
    caller seeds per rank: the counterpart of ``fold_in(key,
    axis_index)``) or the injected per-rank ``uniforms``; the dense
    gradients are summed, the loss averaged, the bumps of the corners
    looked up combined by MAX, and one replicated Adam step (at ``lr``)
    applied.  ``example_table`` is accepted for the JAX package's signature
    and unused."""
    del example_table
    nf = truncated_units * 2
    nc = int(ray_max_dist * 5)

    def step(state: optimize.OptimState, table, rays: render.Rays, bound_min,
             n_xyz, sdf_delta, generator: Optional[torch.Generator] = None,
             uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        local = _chunk(rays, group.shard(rays.uv.shape[0]))
        if uniforms is None:
            uniforms = render.draw_sampling_uniforms(
                generator, local.uv.shape[0], nf, nc, local.uv.device)
        t = copy.copy(table)
        t.weights = state.weights
        feats = state.features.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, corners = render.calculate_loss(
                feats, t, params, local, uniforms, bound_min, voxel_size,
                min_pts_in_grid, truncated_units, truncated_dist,
                ray_max_dist, sdf_delta, n_xyz)
            (g,) = torch.autograd.grad(loss, feats)
        slots, found = tbl.lookup(t, corners.reshape(-1, 3))
        cap = state.features.shape[0]
        state.weights = state.weights + group.all_reduce(
            _bump(slots, found, cap), "max")
        optimize._adam_update(state, group.all_reduce(g), lr, 1.0)
        return state, group.mean(loss.detach())

    return step


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def make_sharded_pretrain_step(group: DPGroup, optimizer: torch.optim.Optimizer,
                               reg_weight: float = 1e-3):
    """The embedding-pretraining step with the patch batch sharded over
    ``group``: ``step(params, input_pts [B, N, 6], n_keep [B], training_pts
    [B, Q, 3], gt_sdf [B, Q]) -> (loss, logs)`` on the global batch.  Each
    rank takes its contiguous shard (B must divide by the group's size),
    runs the loss forward and backward, averages the gradients (one
    all-reduce of all of them), the loss and the logs across ranks, and
    takes one step of ``optimizer`` (the trainer's, over ``params``'
    leaves) per replica.  The loss is a mean over equal shards, so the
    average of the shard means is the global mean."""
    # imported here: models -> parallel would otherwise be cyclic
    from bnv_fusion_tpu_torch.models.local_point_fusion import pretrain_loss

    def step(params, input_pts, n_keep, training_pts, gt_sdf):
        sl = group.shard(input_pts.shape[0])
        optimizer.zero_grad(set_to_none=True)
        loss, logs = pretrain_loss(params, input_pts[sl], n_keep[sl],
                                   training_pts[sl], gt_sdf[sl], reg_weight)
        loss.backward()
        leaves = list(_leaves(params))
        flat = group.mean(torch.cat([p.grad.reshape(-1) for p in leaves]))
        off = 0
        for p in leaves:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()
        optimizer.step()
        names = sorted(logs)
        vals = group.mean(torch.stack([loss.detach()] +
                                      [logs[k].detach() for k in names]))
        return vals[0], {k: vals[i + 1] for i, k in enumerate(names)}

    return step
