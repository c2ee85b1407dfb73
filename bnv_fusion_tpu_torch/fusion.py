"""Local-level fusion (cell-keyed sort-reduce) and SDF decode through the
sparse volume.

Counterpart of bnv_fusion_tpu/fusion.py:45-1251.  Local fusion on the
slot-map tables (dense, blocks): a frame's oriented points are sorted by
containing cell, encoded by the PointNet MLP, reduced per (cell,
floor/ceil code) group, scattered to the 8 corner voxels, reduced again per
voxel, and folded into the table with the reference's running mean
(weight = clip(count / 32, 1), voxels under min_pts_in_grid points
dropped).  ``fuse_frames_merged`` folds K frames into one table update;
``fuse_frame_sorted`` (``fuse_algorithm: corner``) sorts the 8N (corner,
feature) entries in one stage instead.  The hash table (unbounded scenes)
takes capacity-sized scatter accumulators instead.  Tables are updated IN
PLACE.  All sorts are stable, like ``lax.sort``.  ``compute_dtype``
(``model.fuse_dtype``) is the encoder's operand precision
(``nn.mlp_apply``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from bnv_fusion_tpu_torch import nn as bnn
from bnv_fusion_tpu_torch import table as _hash
from bnv_fusion_tpu_torch import tables as tbl
from bnv_fusion_tpu_torch import voxel
from bnv_fusion_tpu_torch.kernels import (fused_corner_decode,
                                          fused_encode_sorted,
                                          seg_reduce_sorted,
                                          seg_reduce_sorted_torch)
from bnv_fusion_tpu_torch.utils import profiling


class FrameStats(NamedTuple):
    """Per-frame fusion statistics (device scalars, or [K] for a batch)."""

    n_avg_pts: torch.Tensor
    n_touched: torch.Tensor
    n_valid_pts: torch.Tensor


def _prepend(x: torch.Tensor, value) -> torch.Tensor:
    """[value, x[..., :-1]] along the last axis."""
    pad = torch.full(x.shape[:-1] + (1,), value, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def _append(x: torch.Tensor, value) -> torch.Tensor:
    """[x[..., 1:], value] along the last axis."""
    pad = torch.full(x.shape[:-1] + (1,), value, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., 1:], pad], dim=-1)


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """cumsum over dim 0 of [M, C], scanned along the innermost dim of a
    [C, M] copy: CUDA's outer-dim scan runs one thread per column, which
    took 346 ms for one [280k, 8] gradient scatter on the H100."""
    return torch.cumsum(x.T.contiguous(), dim=1).T


def _compact_ends(is_end: torch.Tensor, width: int) -> torch.Tensor:
    """Positions of the first ``width`` True entries of [..., M] in order,
    padded with M (a sort, like the JAX path; no host sync)."""
    m = is_end.shape[-1]
    idx = torch.arange(m, device=is_end.device).expand_as(is_end)
    return torch.sort(torch.where(is_end, idx, m), dim=-1).values[..., :width]


# ---------------------------------------------------------------------------
# local fusion
# ---------------------------------------------------------------------------

def _cell_keys(pts_w, valid, bound_min, bound_max, voxel_size: float, n_xyz,
               n_vox: int):
    """Bound mask + (cell, mcode) keys of points [..., N, 3]; invalid entries
    get (n_vox, 8).  Returns (inside, cell, mcode, coords)."""
    nx, ny, nz = (int(v) for v in n_xyz)
    inside = torch.all((pts_w > bound_min + voxel_size) &
                       (pts_w < bound_max - voxel_size), dim=-1) & valid
    coords = voxel.position_to_coords(pts_w, bound_min, voxel_size)
    fl = torch.floor(coords)
    mi = (torch.ceil(coords) > fl).to(torch.int32)
    # clamp first: float->int of out-of-range or NaN values is undefined
    fi = torch.nan_to_num(fl, nan=-1.0).clamp(-1, 2 ** 30).to(torch.int32)
    nmax = torch.as_tensor([nx, ny, nz], dtype=torch.int32, device=pts_w.device)
    inside = inside & torch.all(fi >= 0, dim=-1) & \
        torch.all(fi + mi < nmax, dim=-1)
    fi = torch.where(inside[..., None], fi, 0)
    cell = fi[..., 0] * (ny * nz) + fi[..., 1] * nz + fi[..., 2]
    mcode = mi[..., 0] * 4 + mi[..., 1] * 2 + mi[..., 2]
    cell = torch.where(inside, cell, n_vox)
    mcode = torch.where(inside, mcode, 8)
    return inside, cell, mcode, coords


def _cellsort_sort1(pts_w, normals, valid, bound_min, bound_max,
                    voxel_size: float, n_xyz, n_vox: int):
    """Stage-1 front over [..., N] points: bound mask + cell keys + a stable
    sort by (cell, mcode).  Returns (cell_s, mcode_s, coords_s, normals_s,
    n_valid).

    The sort's permutation moves every operand.  The JAX package's
    ``fuse_sort1_gather`` formulation (sort the combined key with its row
    index, gather only the float payloads) gives identical bits and took
    1% longer on the H100 (PERF.md), so it has no counterpart here."""
    inside, cell, mcode, coords = _cell_keys(pts_w, valid, bound_min,
                                             bound_max, voxel_size, n_xyz, n_vox)
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    coords_z = torch.where(inside[..., None], coords, zero)
    normals_z = torch.where(inside[..., None], normals, zero)
    order = torch.argsort(cell.long() * 16 + mcode.long(), dim=-1, stable=True)
    o3 = order[..., None].expand(order.shape + (3,))
    return (torch.gather(cell, -1, order), torch.gather(mcode, -1, order),
            torch.gather(coords_z, -2, o3), torch.gather(normals_z, -2, o3),
            inside.to(torch.float32).sum(-1))


def frame_width_counts(pts_w, valid, bound_min, bound_max, voxel_size: float,
                       n_xyz, n_vox: int):
    """Occupancy of frames [..., N]: (#unique (cell, mcode) groups, #unique
    corner voxels) per frame, int32 [...] — the exact quantities the static
    widths ``max_unique_cells_per_frame`` / ``max_unique_per_frame`` bound.

    Runs the fuse front's key math (``_cell_keys``), then counts uniques by
    sort and boundary: no encoder, no payloads."""
    inside, cell, mcode, _ = _cell_keys(pts_w, valid, bound_min, bound_max,
                                        voxel_size, n_xyz, n_vox)
    key_s = torch.sort(cell.long() * 16 + mcode.long(), dim=-1).values
    new_g = (key_s != _prepend(key_s, -1)) & (key_s < n_vox * 16)
    ck = _corner_keys(cell, mcode, inside, n_xyz, n_vox).flatten(-2)
    ck_s = torch.sort(ck, dim=-1).values
    new_c = (ck_s != _prepend(ck_s, -1)) & (ck_s < n_vox)
    return (new_g.sum(-1).to(torch.int32), new_c.sum(-1).to(torch.int32))


def _corner_keys(cell_u, mcode_u, gmask, n_xyz, n_vox: int):
    """Per cell group [..., U] -> the 8 corner voxel flat ids [..., U, 8]
    (cell + pattern * degeneracy, matching voxel.corner_neighbors)."""
    _, ny, nz = (int(v) for v in n_xyz)
    pattern = voxel.corner_pattern(cell_u.device)                # [8, 3]
    moff = torch.stack([(mcode_u >> 2) & 1, (mcode_u >> 1) & 1, mcode_u & 1],
                       dim=-1)                                   # [..., U, 3]
    offs = pattern * moff[..., None, :]                          # [..., U, 8, 3]
    ckey = cell_u[..., None] + offs[..., 0] * (ny * nz) + offs[..., 1] * nz + \
        offs[..., 2]
    return torch.where(gmask[..., None], ckey, n_vox)


def _cellsort_reduce(params, pts_w, normals, valid, bound_min, bound_max,
                     voxel_size: float, max_unique: int,
                     max_unique_cells: Optional[int], n_xyz, n_vox: int,
                     fdim: int, compute_dtype: torch.dtype = torch.float32):
    """One frame's points -> per-unique-voxel (flat id, count, feature sum)
    padded to width ``max_unique``, through the mean-centered cumsum
    reductions of the JAX package's per-frame path.

    Returns (flat_u, cnt_u, sum_u, umask, n_unique, u, cells_dropped,
    n_valid_pts)."""
    n = pts_w.shape[0]
    dev = pts_w.device
    u_cell = min(max_unique_cells if max_unique_cells else max_unique, n)

    with profiling.span("fuse.sort1"):
        cell_s, mcode_s, coords_s, normals_s, n_inside = _cellsort_sort1(
            pts_w, normals, valid, bound_min, bound_max, voxel_size, n_xyz,
            n_vox)
        entry_valid = cell_s < n_vox

    with profiling.span("fuse.encode"):
        corners_s = voxel.corner_neighbors(coords_s)
        rel = voxel.local_offsets(coords_s, corners_s)
        pn_in = torch.cat([rel, normals_s[:, None, :].expand_as(rel)], dim=-1)
        feats = bnn.encoder_apply(params, pn_in, compute_dtype)  # [N, 8, F]
        f8 = torch.where(entry_valid[:, None, None], feats,
                         torch.zeros((), device=dev)).reshape(n, 8 * fdim)

    with profiling.span("fuse.reduce1"):
        boundary = (cell_s != _prepend(cell_s, -1)) | \
            (mcode_s != _prepend(mcode_s, -1))
        ch_mean = torch.mean(f8, dim=0, keepdim=True)
        cum = _cumsum_rows(f8 - ch_mean)
        is_end = _append(boundary, True) & entry_valid
        n_groups = is_end.sum().to(torch.int32)

        end_pos = torch.clamp(_compact_ends(is_end, u_cell), max=n - 1)
        gmask = torch.arange(u_cell, device=dev) < \
            torch.clamp(n_groups, max=u_cell)
        prev_end = _prepend(end_pos, -1)
        cell_u = cell_s[end_pos]
        mcode_u = mcode_s[end_pos]
        gcnt = (end_pos - prev_end).to(torch.int32)
        cum_lo = torch.where((prev_end >= 0)[:, None],
                             cum[prev_end.clamp(min=0)],
                             torch.zeros((), device=dev))
        gsum = cum[end_pos] - cum_lo + \
            ch_mean * gcnt.to(torch.float32)[:, None]
        cells_dropped = torch.clamp(n_groups - u_cell, min=0)

    # ---- stage 2: merge per-cell partials into corner voxel totals ----
    with profiling.span("fuse.corners"):
        m2 = u_cell * 8
        ck = _corner_keys(cell_u, mcode_u, gmask, n_xyz, n_vox).reshape(m2)
        f2 = torch.where(gmask[:, None, None], gsum.reshape(u_cell, 8, fdim),
                         torch.zeros((), device=dev)).reshape(m2, fdim)
        c2 = torch.where(gmask[:, None], gcnt[:, None].expand(u_cell, 8),
                         0).reshape(m2)
    with profiling.span("fuse.sort2"):
        order = torch.argsort(ck, stable=True)
        ck_s, f2_s, c2_s = ck[order], f2[order], c2[order]

    with profiling.span("fuse.reduce2"):
        ev2 = ck_s < n_vox
        mean2 = torch.mean(f2_s, dim=0, keepdim=True)
        cum2 = _cumsum_rows(f2_s - mean2)
        ccum2 = torch.cumsum(c2_s, dim=0)                        # exact ints
        is_end2 = _append(ck_s != _prepend(ck_s, -1), True) & ev2
        n_unique = is_end2.sum().to(torch.int32)

        u = min(max_unique, m2)
        end2 = torch.clamp(_compact_ends(is_end2, u), max=m2 - 1)
        umask = torch.arange(u, device=dev) < torch.clamp(n_unique, max=u)
        pend2 = _prepend(end2, -1)
        flat_u = ck_s[end2]
        seg_n = (end2 - pend2).to(torch.float32)
        clo = torch.where(pend2 >= 0, ccum2[pend2.clamp(min=0)], 0)
        cnt_u = (ccum2[end2] - clo).to(torch.float32)
        flo = torch.where((pend2 >= 0)[:, None], cum2[pend2.clamp(min=0)],
                          torch.zeros((), device=dev))
        sum_u = cum2[end2] - flo + mean2 * seg_n[:, None]
    return (flat_u, cnt_u, sum_u, umask, n_unique, u, cells_dropped, n_inside)


def _integrate_unique(table, flat_u, cnt_u, sum_u, umask, n_unique, u: int,
                      min_pts_in_grid: int, extra_overflow=0) -> FrameStats:
    """Shared fuse tail, in place: insert deduplicated voxels + the
    reference's running-mean update (weight = clip(count/32, 1), voxels under
    min_pts dropped)."""
    with profiling.span("fuse.table"):
        slots, ok = tbl.insert_unique_flat(
            table, torch.where(umask, flat_u, -1), umask)
        dropped = torch.clamp(n_unique - u, min=0)

        mean_u = sum_u / torch.clamp(cnt_u, min=1.0)[:, None]
        new_w = torch.clamp(cnt_u / 32.0, max=1.0)
        keep = umask & ok & (cnt_u >= min_pts_in_grid)
        zero = torch.zeros((), device=sum_u.device)
        old_w = torch.where(keep, table.weights[slots], zero)
        old_f = torch.where(keep[:, None], table.features[slots], zero)
        upd_w = old_w + new_w
        upd_f = (old_f * old_w[:, None] + mean_u * new_w[:, None]) / \
            torch.clamp(upd_w, min=1e-12)[:, None]
        old_h = torch.where(keep, table.num_hits[slots], zero)

        ks = slots[keep]
        table.features[ks] = upd_f[keep]
        table.weights[ks] = upd_w[keep]
        table.num_hits[ks] = old_h[keep] + 1.0
        table.overflow = table.overflow + dropped + extra_overflow

        nf = torch.clamp(n_unique.to(torch.float32), min=1.0)
        return FrameStats(
            n_avg_pts=torch.sum(torch.where(umask, cnt_u, zero)) / nf,
            n_touched=n_unique.to(torch.float32),
            n_valid_pts=torch.zeros((), device=sum_u.device))


def fuse_frame_cellsort(table, params: Dict[str, Any], pts_w, normals, valid,
                        bound_min, bound_max, voxel_size: float,
                        min_pts_in_grid: int, max_unique: int = 1 << 17,
                        max_unique_cells: Optional[int] = None,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> FrameStats:
    """Integrate one frame's oriented points [N, 3] (+ normals, validity)
    into a dense table, in place, by the two-stage cell-keyed sort-reduce."""
    (flat_u, cnt_u, sum_u, umask, n_unique, u, cells_dropped,
     n_valid) = _cellsort_reduce(params, pts_w, normals, valid, bound_min,
                                 bound_max, voxel_size, max_unique,
                                 max_unique_cells, table.n_xyz,
                                 table.n_voxels, table.feat_dims,
                                 compute_dtype=compute_dtype)
    stats = _integrate_unique(table, flat_u, cnt_u, sum_u, umask, n_unique, u,
                              min_pts_in_grid, extra_overflow=cells_dropped)
    return stats._replace(n_valid_pts=n_valid)


def _cellsort_reduce_batched(params, pts_w, normals, valid, bound_min,
                             bound_max, voxel_size: float, max_unique: int,
                             max_unique_cells: Optional[int], n_xyz,
                             n_vox: int, fdim: int, plain: bool = False,
                             sort_bf16: bool = False,
                             compute_dtype: torch.dtype = torch.float32):
    """K-frame batched reduce front: the encoder goes through
    ``fused_encode_sorted`` (one CUDA kernel launch for the K frames on
    CUDA tensors) and both segment reductions through ``seg_reduce_sorted``
    (the CUDA kernel on CUDA tensors; with ``plain`` the plain PyTorch
    version on any device).  Inputs are [K, N, ...]; returns the per-frame
    tuple of ``_cellsort_reduce`` stacked over K.

    ``sort_bf16`` rounds the stage-2 per-cell partial sums to bfloat16
    (round to nearest even) before the corner merge, as the JAX package's
    bf16-packed stage-2 sort does."""
    seg = seg_reduce_sorted_torch if plain else seg_reduce_sorted
    kf, n = pts_w.shape[:2]
    dev = pts_w.device
    u_cell = min(max_unique_cells if max_unique_cells else max_unique, n)

    with profiling.span("fuse.sort1"):
        cell_s, mcode_s, coords_s, normals_s, n_valid = _cellsort_sort1(
            pts_w, normals, valid, bound_min, bound_max, voxel_size, n_xyz,
            n_vox)
        entry_valid = cell_s < n_vox                             # [K, N]
    with profiling.span("fuse.encode"):
        f8fm = fused_encode_sorted(params, coords_s, normals_s, entry_valid,
                                   compute_dtype)

    with profiling.span("fuse.reduce1"):
        cnts1 = entry_valid.to(torch.int32)[:, None, :].contiguous()
        cell_u, mcode_u, gcnt_i, gsum, n_groups = seg(
            cell_s.contiguous(), cnts1, f8fm, u=u_cell, sent=int(n_vox),
            keys2=mcode_s.contiguous())
        del f8fm
        gmask = torch.arange(u_cell, device=dev)[None, :] < \
            torch.clamp(n_groups, max=u_cell)[:, None]           # [K, u_cell]
        gcnt = gcnt_i[..., 0]
        cells_dropped = torch.clamp(n_groups - u_cell, min=0)

    # ---- stage 2: scatter per-cell partials to the 8 corner voxel ids ----
    with profiling.span("fuse.corners"):
        m2 = u_cell * 8
        ck = _corner_keys(cell_u, mcode_u, gmask, n_xyz,
                          n_vox).reshape(kf, m2)
        # gsum channels are (f*8 + p) -> per-feature [K, F, u_cell * 8]
        # planes
        g3 = torch.where(gmask[:, :, None, None],
                         gsum.reshape(kf, u_cell, fdim, 8),
                         torch.zeros((), device=dev))
        fch = g3.permute(0, 2, 1, 3).reshape(kf, fdim, m2)
        c2 = torch.where(gmask[:, :, None],
                         gcnt[:, :, None].expand(kf, u_cell, 8),
                         0).reshape(kf, m2)
        if sort_bf16:
            fch = fch.to(torch.bfloat16).to(torch.float32)
    with profiling.span("fuse.sort2"):
        order = torch.argsort(ck, dim=-1, stable=True)
        ck_s = torch.gather(ck, -1, order).contiguous()
        f2_s = torch.gather(fch, -1, order[:, None, :].expand(kf, fdim, m2))
        c2_s = torch.gather(c2, -1, order)[:, None, :].contiguous()

    with profiling.span("fuse.reduce2"):
        u = min(max_unique, m2)
        flat_u, _, cnt_i, sum_u, n_unique = seg(
            ck_s, c2_s, f2_s.contiguous(), u=u, sent=int(n_vox))
        umask = torch.arange(u, device=dev)[None, :] < \
            torch.clamp(n_unique, max=u)[:, None]
        cnt_u = cnt_i[..., 0].to(torch.float32)
    return (flat_u, cnt_u, sum_u, umask, n_unique, u, cells_dropped, n_valid)


def fuse_frames_merged(table, params: Dict[str, Any], pts_w, normals, valid,
                       bound_min, bound_max, voxel_size: float,
                       min_pts_in_grid: int, max_unique: int = 1 << 17,
                       max_unique_cells: Optional[int] = None,
                       max_unique_batch: Optional[int] = None,
                       seg_kernel: bool | str = False,
                       sort_bf16: bool = False,
                       compute_dtype: torch.dtype = torch.float32,
                       front_chunks: int = 1) -> FrameStats:
    """Fuse K frames [K, N, ...] with ONE table update, in place.

    ``seg_kernel``: True = the batched front with ``seg_reduce_sorted`` (the
    CUDA kernel on CUDA tensors); "interpret" = the batched front with the
    plain seg-reduce; False = the per-frame cumsum front of
    ``_cellsort_reduce``.  The batched front encodes through
    ``fused_encode_sorted``.  ``front_chunks`` > 1 runs the front over
    K/front_chunks-frame sub-batches (the seg-reduce launches once per
    sub-batch), which bounds the front's memory; the merge and the table
    update still span all K frames, and the front is frame-independent, so
    the result is bit-identical.  The per-frame running mean is
    associative, so the K frames' per-voxel contributions are merged (exact
    int32 weight sums, feature sums of at most K entries) and applied once.

    Returns FrameStats with [K]-shaped leaves."""
    kf = pts_w.shape[0]
    fdim = table.feat_dims
    n_xyz, n_vox = table.n_xyz, table.n_voxels
    dev = pts_w.device

    def front_batch(p, nr, v):
        if seg_kernel:
            out = _cellsort_reduce_batched(
                params, p, nr, v, bound_min, bound_max, voxel_size,
                max_unique, max_unique_cells, n_xyz, n_vox, fdim,
                plain=(seg_kernel == "interpret"), sort_bf16=sort_bf16,
                compute_dtype=compute_dtype)
            return out[5], [out[i] for i in (0, 1, 2, 3, 4, 6, 7)]
        outs = [_cellsort_reduce(params, p[k], nr[k], v[k], bound_min,
                                 bound_max, voxel_size, max_unique,
                                 max_unique_cells, n_xyz, n_vox, fdim,
                                 compute_dtype=compute_dtype)
                for k in range(p.shape[0])]
        return outs[0][5], [torch.stack([o[i] for o in outs])
                            for i in (0, 1, 2, 3, 4, 6, 7)]

    if kf % front_chunks:
        raise ValueError(f"front_chunks={front_chunks} must divide the "
                         f"batch size {kf}")
    kc = kf // front_chunks
    parts = []
    for c in range(0, kf, kc):
        u, leaves = front_batch(pts_w[c:c + kc], normals[c:c + kc],
                                valid[c:c + kc])
        parts.append(leaves)
    (flat_u, cnt_u, sum_u, umask, n_unique, cells_dropped, n_valid) = (
        torch.cat(x) if len(parts) > 1 else x[0] for x in zip(*parts))
    del parts

    zero = torch.zeros((), device=dev)
    with profiling.span("fuse.merge"):
        mean_u = sum_u / torch.clamp(cnt_u, min=1.0)[..., None]
        nw = torch.clamp(cnt_u / 32.0, max=1.0)
        keep = umask & (cnt_u >= min_pts_in_grid)

        m3 = kf * u
        key = torch.where(umask, flat_u, n_vox).reshape(m3)
        # nw = min(cnt/32, 1) is an integer number of 1/32 units: its sums
        # ride integers exactly
        nw32 = torch.where(keep, torch.clamp(cnt_u, max=32.0), zero) \
            .to(torch.int64).reshape(m3)
        h32 = keep.to(torch.int64).reshape(m3)
        s_z = torch.where(keep[..., None], mean_u * nw[..., None],
                          zero).reshape(m3, fdim)

        order = torch.argsort(key, stable=True)
        key_s, nw_s, h_s, s_s = key[order], nw32[order], h32[order], \
            s_z[order]
        ev = key_s < n_vox
        wcum = torch.cumsum(nw_s, 0)
        hcum = torch.cumsum(h_s, 0)
        is_end = _append(key_s != _prepend(key_s, -1), True) & ev
        n_uniq_b = is_end.sum()

        ub = min(max_unique_batch if max_unique_batch else 2 * max_unique, m3)
        end = torch.clamp(_compact_ends(is_end, ub), max=m3 - 1)
        bmask = torch.arange(ub, device=dev) < torch.clamp(n_uniq_b, max=ub)
        pend = _prepend(end, -1)
        flat_b = key_s[end]
        wlo = torch.where(pend >= 0, wcum[pend.clamp(min=0)], 0)
        W = (wcum[end] - wlo).to(torch.float32) / 32.0
        hlo = torch.where(pend >= 0, hcum[pend.clamp(min=0)], 0)
        H = (hcum[end] - hlo).to(torch.float32)
        # a voxel appears at most once per frame: every merge segment has
        # <= K entries, summed by K shifted gathers in the JAX package's
        # order
        seg_len = end - pend
        S = torch.zeros((ub, fdim), dtype=torch.float32, device=dev)
        for i in range(kf):
            take = torch.clamp(end - i, min=0)
            S = S + torch.where((i < seg_len)[:, None], s_s[take], zero)

    with profiling.span("fuse.table"):
        slots, ok = tbl.insert_unique_flat(
            table, torch.where(bmask, flat_b, -1), bmask)
        dropped = torch.clamp(n_uniq_b - ub, min=0)
        keep_b = bmask & ok & (W > 0)
        old_w = torch.where(keep_b, table.weights[slots], zero)
        old_f = torch.where(keep_b[:, None], table.features[slots], zero)
        old_h = torch.where(keep_b, table.num_hits[slots], zero)
        upd_w = old_w + W
        upd_f = (old_f * old_w[:, None] + S) / \
            torch.clamp(upd_w, min=1e-12)[:, None]
        ks = slots[keep_b]
        table.features[ks] = upd_f[keep_b]
        table.weights[ks] = upd_w[keep_b]
        table.num_hits[ks] = (old_h + H)[keep_b]
        per_frame_dropped = torch.clamp(n_unique.long() - u, min=0).sum()
        table.overflow = table.overflow + dropped + \
            cells_dropped.long().sum() + per_frame_dropped

        nf = torch.clamp(n_unique.to(torch.float32), min=1.0)
        return FrameStats(
            n_avg_pts=torch.sum(torch.where(umask, cnt_u, zero), dim=1) / nf,
            n_touched=n_unique.to(torch.float32),
            n_valid_pts=n_valid)


def encode_corner_features(params: Dict[str, Any], pts_w, normals, valid,
                           bound_min, bound_max, voxel_size: float,
                           compute_dtype: torch.dtype = torch.float32):
    """Bound mask, corner expansion and PointNet features of points [N, 3].

    Returns (corner coords [N, 8, 3] int32, feats [N, 8, F], valid8 [N, 8])."""
    inside = torch.all((pts_w > bound_min + voxel_size) &
                       (pts_w < bound_max - voxel_size), dim=-1)
    valid = valid & inside
    coords = voxel.position_to_coords(pts_w, bound_min, voxel_size)
    corners = voxel.corner_neighbors(coords)                     # [N, 8, 3]
    rel = voxel.local_offsets(coords, corners)
    pn_in = torch.cat([rel, normals[:, None, :].expand_as(rel)], dim=-1)
    feats = bnn.encoder_apply(params, pn_in, compute_dtype)      # [N, 8, F]
    return corners, feats, valid[:, None].expand(corners.shape[:2])


def fuse_frame(table, params: Dict[str, Any], pts_w, normals, valid,
               bound_min, bound_max, voxel_size: float, min_pts_in_grid: int,
               compute_dtype: torch.dtype = torch.float32,
               max_unique: int = 1 << 19, algorithm: str = "cell",
               max_unique_cells: Optional[int] = None) -> FrameStats:
    """Integrate one frame's oriented points into the table, in place.  On
    the slot-map tables (dense, blocks) ``algorithm="cell"`` takes the
    two-stage cell-keyed sort-reduce (``fuse_frame_cellsort``), anything
    else the one-stage corner-keyed sort (``fuse_frame_sorted``); both fuse
    the same voxel set and weights.  The hash table takes
    ``_fuse_frame_hash``."""
    if isinstance(table, _hash.SparseVoxelTable):
        return _fuse_frame_hash(table, params, pts_w, normals, valid,
                                bound_min, bound_max, voxel_size,
                                min_pts_in_grid, compute_dtype)
    if algorithm == "cell":
        return fuse_frame_cellsort(
            table, params, pts_w, normals, valid, bound_min, bound_max,
            voxel_size, min_pts_in_grid, max_unique=max_unique,
            max_unique_cells=max_unique_cells, compute_dtype=compute_dtype)
    return fuse_frame_sorted(table, params, pts_w, normals, valid, bound_min,
                             bound_max, voxel_size, min_pts_in_grid,
                             compute_dtype=compute_dtype,
                             max_unique=max_unique)


def _fuse_frame_hash(table, params: Dict[str, Any], pts_w, normals, valid,
                     bound_min, bound_max, voxel_size: float,
                     min_pts_in_grid: int,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> FrameStats:
    """``fuse_frame`` on a hash table, in place: insert the 8N corner keys,
    then per-slot feature sums and counts by two capacity-sized scatter-adds
    (rows that did not land go to a spare row) and the reference's running
    mean (weight = clip(count / 32, 1), slots under min_pts dropped)."""
    n = pts_w.shape[0]
    cap = table.capacity
    fdim = table.feat_dims
    dev = pts_w.device
    corners, feats, valid8 = encode_corner_features(
        params, pts_w, normals, valid, bound_min, bound_max, voxel_size,
        compute_dtype)
    slots, ok = tbl.insert(table, corners.reshape(n * 8, 3),
                           valid8.reshape(n * 8))
    idx = torch.where(ok, slots, cap)
    feat_sum = torch.zeros((cap + 1, fdim), dtype=torch.float32, device=dev) \
        .index_add_(0, idx, feats.reshape(n * 8, fdim))[:cap]
    cnt = torch.zeros((cap + 1,), dtype=torch.float32, device=dev) \
        .index_add_(0, idx, torch.ones((n * 8,), device=dev))[:cap]

    touched = cnt > 0
    mean_feats = feat_sum / torch.clamp(cnt, min=1.0)[:, None]
    new_w = torch.clamp(cnt / 32.0, max=1.0)
    keep = touched & (cnt >= min_pts_in_grid)
    old_w = table.weights
    upd_w = old_w + new_w
    upd_f = (table.features * old_w[:, None] + mean_feats * new_w[:, None]) / \
        torch.clamp(upd_w, min=1e-12)[:, None]
    table.features = torch.where(keep[:, None], upd_f, table.features)
    table.weights = torch.where(keep, upd_w, table.weights)
    # num_hits: frames that contributed a real (>= min_pts) observation
    table.num_hits = torch.where(keep, table.num_hits + 1.0, table.num_hits)

    n_touched = touched.to(torch.float32).sum()
    return FrameStats(n_avg_pts=cnt.sum() / torch.clamp(n_touched, min=1.0),
                      n_touched=n_touched,
                      n_valid_pts=valid8[:, 0].to(torch.float32).sum())


def fuse_frame_sorted(table, params: Dict[str, Any], pts_w, normals, valid,
                      bound_min, bound_max, voxel_size: float,
                      min_pts_in_grid: int,
                      compute_dtype: torch.dtype = torch.float32,
                      max_unique: int = 1 << 19) -> FrameStats:
    """One-stage corner-keyed fusion of one frame (``fuse_algorithm:
    corner``), in place: the 8N (corner voxel, feature) entries are sorted
    by voxel id, summed per voxel by a mean-centered cumsum and a
    difference at the segment ends, compacted to width ``max_unique`` and
    folded into the table by the shared running-mean tail.  With a
    bfloat16 ``compute_dtype`` the sorted features are rounded to bfloat16
    before the per-voxel sum, as the JAX package's bf16 sort payload is."""
    n = pts_w.shape[0]
    m = n * 8
    fdim = table.feat_dims
    _, ny, nz = table.n_xyz
    n_vox = table.n_voxels
    dev = pts_w.device

    corners, feats, valid8 = encode_corner_features(
        params, pts_w, normals, valid, bound_min, bound_max, voxel_size,
        compute_dtype)
    keys = corners.reshape(m, 3)
    nmax = torch.as_tensor(table.n_xyz, dtype=keys.dtype, device=dev)
    inside = torch.all((keys >= 0) & (keys < nmax), dim=-1) & \
        valid8.reshape(m)
    flat = keys[:, 0].long() * (ny * nz) + keys[:, 1].long() * nz + \
        keys[:, 2].long()
    flat = torch.where(inside, flat, n_vox)               # invalid sort last
    # zero the invalid entries: masked points may carry NaN features
    f8 = bnn.round_to(torch.where(inside[:, None], feats.reshape(m, fdim),
                                  torch.zeros((), device=dev)), compute_dtype)
    order = torch.argsort(flat, stable=True)
    flat_s, feats_s = flat[order], f8[order]

    entry_valid = flat_s < n_vox
    # centered by the batch mean, so the cumsum is a near-zero-mean walk
    # and the end-start difference stays at f32 roundoff
    ch_mean = torch.mean(feats_s, dim=0, keepdim=True)
    cum = _cumsum_rows(feats_s - ch_mean)                        # [M, F]
    is_end = _append(flat_s != _prepend(flat_s, -1), True) & entry_valid
    n_unique = is_end.sum().to(torch.int32)

    u = min(max_unique, m)
    end_pos = torch.clamp(_compact_ends(is_end, u), max=m - 1)
    umask = torch.arange(u, device=dev) < torch.clamp(n_unique, max=u)
    prev_end = _prepend(end_pos, -1)
    flat_u = flat_s[end_pos]
    cnt_u = (end_pos - prev_end).to(torch.float32)
    cum_lo = torch.where((prev_end >= 0)[:, None], cum[prev_end.clamp(min=0)],
                         torch.zeros((), device=dev))
    sum_u = cum[end_pos] - cum_lo + ch_mean * cnt_u[:, None]     # [U, F]

    stats = _integrate_unique(table, flat_u, cnt_u, sum_u, umask, n_unique, u,
                              min_pts_in_grid)
    return stats._replace(n_valid_pts=valid8[:, 0].to(torch.float32).sum())


def make_fuse_frame_fn(voxel_size: float, min_pts_in_grid: int,
                       compute_dtype: torch.dtype = torch.float32):
    """The per-frame fusion step ``step(table, params, pts_w, normals,
    valid, bound_min, bound_max) -> FrameStats`` (in place; PyTorch runs
    eagerly, so there is nothing to compile or donate)."""
    def step(table, params, pts_w, normals, valid, bound_min, bound_max):
        return fuse_frame(table, params, pts_w, normals, valid, bound_min,
                          bound_max, voxel_size, min_pts_in_grid,
                          compute_dtype=compute_dtype)

    return step


# ---------------------------------------------------------------------------
# SDF decode through the sparse volume
# ---------------------------------------------------------------------------

class DecodePrep(NamedTuple):
    """Feature-independent precomputation of a decode batch."""

    slots: torch.Tensor      # [8M] gather rows into features/weights
    found: torch.Tensor      # [8M]
    tw: torch.Tensor         # [M, 8] trilinear blend weights
    local: torch.Tensor      # [M, 8, 3] corner-local offsets
    w: torch.Tensor          # [M, 8] decode-mask weights
    delta: Optional[torch.Tensor]   # [M, 8] prior samples
    # [8M] the corners whose rows this rank holds, under a corner-row hook
    # (``rows``, parallel.spatial.OwnerRows); None = ``found``
    owned: Optional[torch.Tensor] = None


def _sample_delta_nearest(sdf_delta: torch.Tensor, corners: torch.Tensor,
                          n_xyz) -> torch.Tensor:
    """Nearest-neighbour sample of the dense prior at fine-grid corner
    coords (grid_sample nearest, align_corners=True, zero padding, over
    coords normalized by n_xyz - 1)."""
    dx, dy, dz = sdf_delta.shape
    dev = corners.device
    dims = torch.as_tensor([dx, dy, dz], dtype=torch.float32, device=dev)
    nxf = torch.as_tensor([float(v) for v in n_xyz], dtype=torch.float32,
                          device=dev)
    u = corners.to(torch.float32) / (nxf - 1.0)
    idx = torch.round(u * (dims - 1.0)).to(torch.int64)
    dimi = torch.as_tensor([dx, dy, dz], dtype=torch.int64, device=dev)
    inside = torch.all((idx >= 0) & (idx < dimi), dim=-1)
    idx = torch.minimum(torch.clamp(idx, min=0), dimi - 1)
    flat = idx[..., 0] * (dy * dz) + idx[..., 1] * dz + idx[..., 2]
    vals = sdf_delta.reshape(-1)[flat.reshape(-1)].reshape(flat.shape)
    return torch.where(inside, vals, torch.zeros((), device=dev))


def decode_prepare(table, pts: torch.Tensor, bound_min, voxel_size: float,
                   sdf_delta: Optional[torch.Tensor] = None, n_xyz=None,
                   is_coords: bool = False,
                   weights: Optional[torch.Tensor] = None,
                   rows=None) -> DecodePrep:
    """Everything decode_points computes except the feature-dependent part.
    ``weights`` overrides ``table.weights`` (the optimizer's bumped copy).
    ``rows`` (``parallel.spatial.OwnerRows``) replaces the table's lookup
    by its owner-assembled one: ``slots`` are then this rank's, ``owned``
    marks the corners it holds, and ``found`` and ``w`` are assembled over
    the ranks."""
    coords = pts if is_coords else voxel.position_to_coords(pts, bound_min,
                                                            voxel_size)
    corners = voxel.corner_neighbors(coords)
    tw = voxel.trilinear_weights(coords, corners)
    local = voxel.local_offsets(coords, corners)
    m = coords.shape[0]
    wsrc = table.weights if weights is None else weights
    owned = None
    if rows is None:
        slots, found = tbl.lookup(table, corners.reshape(m * 8, 3))
        w = torch.where(found, wsrc[slots], torch.zeros((), device=pts.device))
    else:
        slots, owned, found, w = rows.lookup(table, corners.reshape(m * 8, 3),
                                             wsrc)
    delta = (None if sdf_delta is None
             else _sample_delta_nearest(sdf_delta, corners, n_xyz))
    return DecodePrep(slots=slots, found=found, tw=tw, local=local,
                      w=w.reshape(m, 8), delta=delta, owned=owned)


def corner_rows(rows_src: torch.Tensor, prep: DecodePrep,
                rows=None) -> torch.Tensor:
    """``rows_src`` (features) at the batch's corners, [8M, F]: one gather,
    or through the corner-row hook ``rows`` (assembled over the ranks)."""
    if rows is None:
        return rows_src[prep.slots]
    return rows.gather(rows_src, prep.slots, prep.owned)


def decode_eval(gathered_feats: torch.Tensor, prep: DecodePrep,
                params: Dict[str, Any], voxel_size: float,
                min_pts_in_grid: int,
                masked_fill: Optional[float] = None,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Feature-dependent tail of decode_points; differentiable w.r.t.
    ``gathered_feats`` (= features[prep.slots]).  ``compute_dtype`` rounds
    the decoder's operands (``nn.mlp_apply``)."""
    m = prep.tw.shape[0]
    zero = torch.zeros((), device=gathered_feats.device)
    feats = torch.where(prep.found[:, None], gathered_feats,
                        zero).reshape(m, 8, -1)
    alpha = bnn.decoder_apply(params, prep.local, feats,
                              compute_dtype=compute_dtype)[..., 0]
    sdf = torch.sum(alpha * voxel_size * prep.tw, dim=-1)
    mask = torch.amin(prep.w, dim=-1) >= min_pts_in_grid
    fill = voxel_size if masked_fill is None else masked_fill
    sdf = torch.where(mask, sdf, torch.full((), fill, device=sdf.device))
    if prep.delta is not None:
        sdf = sdf + torch.sum(prep.delta * prep.tw, dim=-1)
    return sdf


def decode_points(features: torch.Tensor, table, params: Dict[str, Any],
                  pts: torch.Tensor, bound_min, voxel_size: float,
                  min_pts_in_grid: int,
                  sdf_delta: Optional[torch.Tensor] = None, n_xyz=None,
                  is_coords: bool = False, use_fused_kernel: bool = False,
                  masked_fill: Optional[float] = None,
                  layout: str = "rows",
                  packed_decoder: Optional[torch.Tensor] = None,
                  compute_dtype: torch.dtype = torch.float32,
                  rows=None) -> torch.Tensor:
    """SDF at world points (or voxel coords) [M, 3] via 8-corner decode +
    blend: corners under min_pts weight mask the point (+voxel_size, or
    ``masked_fill``), the nearest-sampled prior is added.  With
    ``use_fused_kernel`` the PE + MLP + blend run in ``fused_corner_decode``
    (forward only), on ``packed_decoder`` (its ``packed``) where given.
    ``layout="fm"`` takes ``decode_points_fm`` on the slot-map tables
    unless the fused kernel is on, as in the JAX package (the kernel has its
    own layout; a hash table decodes in the rows layout).  ``rows`` is the
    corner-row hook of a region-sharded table (``decode_prepare``)."""
    if layout not in ("rows", "fm"):
        raise ValueError(f"unknown decode layout {layout!r} (rows | fm)")
    if layout == "fm" and not use_fused_kernel and \
            not isinstance(table, _hash.SparseVoxelTable):
        return decode_points_fm(features, table, params, pts, bound_min,
                                voxel_size, min_pts_in_grid,
                                sdf_delta=sdf_delta, n_xyz=n_xyz,
                                is_coords=is_coords,
                                compute_dtype=compute_dtype,
                                masked_fill=masked_fill, rows=rows)
    prep = decode_prepare(table, pts, bound_min, voxel_size,
                          sdf_delta=sdf_delta, n_xyz=n_xyz,
                          is_coords=is_coords, rows=rows)
    if not use_fused_kernel:
        return decode_eval(corner_rows(features, prep, rows), prep, params,
                           voxel_size, min_pts_in_grid,
                           masked_fill=masked_fill,
                           compute_dtype=compute_dtype)
    m = prep.tw.shape[0]
    feats = torch.where(prep.found[:, None], corner_rows(features, prep, rows),
                        torch.zeros((), device=features.device))
    sdf = fused_corner_decode(params, prep.local.contiguous(),
                              feats.reshape(m, 8, -1).contiguous(),
                              prep.tw.contiguous(), voxel_size,
                              packed=packed_decoder)
    mask = torch.amin(prep.w, dim=-1) >= min_pts_in_grid
    fill = voxel_size if masked_fill is None else masked_fill
    sdf = torch.where(mask, sdf, torch.full((), fill, device=sdf.device))
    if prep.delta is not None:
        sdf = sdf + torch.sum(prep.delta * prep.tw, dim=-1)
    return sdf


def decode_points_fm(features: torch.Tensor, table, params: Dict[str, Any],
                     pts: torch.Tensor, bound_min, voxel_size: float,
                     min_pts_in_grid: int,
                     sdf_delta: Optional[torch.Tensor] = None, n_xyz=None,
                     is_coords: bool = False,
                     compute_dtype: torch.dtype = torch.float32,
                     masked_fill: Optional[float] = None,
                     rows=None) -> torch.Tensor:
    """``decode_points`` with feature-major internals (counterpart of
    bnv_fusion_tpu/fusion.py:1029-1128): coordinates [3, M], corners
    [8, 3, M], decoder activations [C, 8M] with the corner-major point
    order k * M + i, so the decoder is W^T @ X on wide operands.  The
    corners are where(pattern, ceil, floor) of the coordinates, blended
    with normalized trilinear weights; differentiable w.r.t. ``features``
    and ``pts`` (w.r.t. ``pts`` only under ``rows``, the corner-row hook of
    a region-sharded table).  Slot-map tables (dense, blocks) only."""
    m = pts.shape[0]
    dev = pts.device
    zero = torch.zeros((), device=dev)
    ptsT = pts.T                                            # [3, M]
    if is_coords:
        coordsT = ptsT
    else:
        bmin = torch.as_tensor(bound_min, dtype=pts.dtype, device=dev)
        coordsT = (ptsT - bmin[:, None]) / voxel_size
    fl, ce = torch.floor(coordsT), torch.ceil(coordsT)
    patb = voxel.corner_pattern(dev).bool()[:, :, None]     # [8, 3, 1]
    corT = torch.where(patb, ce[None], fl[None])            # [8, 3, M]
    localT = coordsT[None] - corT                           # [8, 3, M]
    w8 = torch.prod(1.0 - torch.abs(localT), dim=1)         # [8, M]
    tw = w8 / torch.clamp(torch.sum(w8, dim=0, keepdim=True), min=1e-12)

    cor_i = corT.detach().to(torch.int32)
    if rows is None:
        nx = table.n_xyz
        inside = ((cor_i[:, 0] >= 0) & (cor_i[:, 0] < nx[0]) &
                  (cor_i[:, 1] >= 0) & (cor_i[:, 1] < nx[1]) &
                  (cor_i[:, 2] >= 0) & (cor_i[:, 2] < nx[2]))   # [8, M]
        slots, found = tbl.lookup_coords3(table, cor_i[:, 0], cor_i[:, 1],
                                          cor_i[:, 2], inside)
        flat_slots = slots.reshape(8 * m)                   # corner-major
        foundf = found.reshape(8 * m)
        w = torch.where(foundf, table.weights[flat_slots], zero).reshape(8, m)
        gathered = features[flat_slots]
    else:
        flat_slots, owned, foundf, w = rows.lookup(
            table, cor_i.permute(0, 2, 1).reshape(8 * m, 3), table.weights)
        w = w.reshape(8, m)
        gathered = rows.gather(features, flat_slots, owned)
    featsT = torch.where(foundf[None, :], gathered.T, zero)

    # PE channel order [xyz, sin(xyz), cos(xyz)], points in flat_slots' order
    local_c = localT.transpose(0, 1).reshape(3, 8 * m)
    pe = torch.cat([local_c, torch.sin(local_c), torch.cos(local_c)], dim=0)
    x = torch.cat([pe, featsT.to(pe.dtype)], dim=0)          # [9 + F, 8M]

    dec = params["decoder"]
    n_hidden = sum(1 for k in dec if k.startswith("w") and k != "w_out")
    h = bnn.round_to(x, compute_dtype)
    for i in range(n_hidden):
        h = bnn.round_to(dec[f"w{i}"], compute_dtype).T @ h + \
            dec[f"b{i}"][:, None]
        h = bnn.round_to(torch.relu(h), compute_dtype)
    alpha = bnn.round_to(dec["w_out"], compute_dtype).T @ h + \
        dec["b_out"][:, None]                               # [1, 8M]
    sdf = torch.sum(alpha.reshape(8, m) * voxel_size * tw, dim=0)

    mask = torch.amin(w, dim=0) >= min_pts_in_grid
    fill = voxel_size if masked_fill is None else masked_fill
    sdf = torch.where(mask, sdf, torch.full((), fill, device=dev))
    if sdf_delta is not None:
        delta = _sample_delta_nearest(sdf_delta, cor_i.permute(0, 2, 1), n_xyz)
        sdf = sdf + torch.sum(delta * tw, dim=0)
    return sdf


def sdf_gradient(features: torch.Tensor, table, params: Dict[str, Any],
                 pts: torch.Tensor, bound_min, voxel_size: float,
                 min_pts_in_grid: int, normalize: bool = True,
                 **decode_kwargs) -> torch.Tensor:
    """SDF spatial gradients (surface normals) [M, 3] at world points: one
    ``torch.autograd.grad`` of ``decode_points(...).sum()`` w.r.t. the
    points (counterpart of bnv_fusion_tpu/fusion.py:1208-1228), divided by
    ``||g|| + 1e-5`` when ``normalize``.  The fused decode kernel has no
    backward, so ``use_fused_kernel=True`` raises."""
    if decode_kwargs.get("use_fused_kernel"):
        raise ValueError("sdf_gradient needs the decode's backward, and the "
                         "fused decode kernel is forward only: call it with "
                         "use_fused_kernel=False")
    p = pts.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        s = decode_points(features.detach(), table, params, p, bound_min,
                          voxel_size, min_pts_in_grid, **decode_kwargs).sum()
        (g,) = torch.autograd.grad(s, p)
    if normalize:
        g = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-5)
    return g


# ---------------------------------------------------------------------------
# optimization helpers
# ---------------------------------------------------------------------------

def scatter_add_rows(gidx: torch.Tensor, rows: torch.Tensor, capacity: int,
                     method: str = "sortreduce",
                     unique_budget: Optional[int] = None) -> torch.Tensor:
    """Accumulate [N, F] rows into a fresh [capacity, F] array by index;
    ``gidx == capacity`` marks dropped rows.

    "scatter" adds every row by index; "sortreduce" sorts rows by index,
    takes per-channel cumsums, differences them at the compacted segment
    ends and adds the unique rows once (falling back to "scatter" when the
    segments exceed ``unique_budget``, default N // 4)."""
    n, fdim = rows.shape
    dev = rows.device
    if method == "scatter":
        out = torch.zeros((capacity + 1, fdim), dtype=rows.dtype, device=dev)
        return out.index_add_(0, gidx, rows)[:capacity]
    if method != "sortreduce":
        raise ValueError(f"unknown grad_scatter method {method!r}")
    ub = min(unique_budget or max(n // 4, 1 << 14), n)
    order = torch.argsort(gidx, stable=True)
    k = gidx[order]
    csum = _cumsum_rows(rows[order])
    is_end = _append(k, -1) != k
    is_end[-1] = True
    is_end = is_end & (k < capacity)
    if int(is_end.sum()) > ub:
        return scatter_add_rows(gidx, rows, capacity, method="scatter")
    endpos = _compact_ends(is_end, ub)
    valid = endpos < n
    ec = torch.clamp(endpos, max=n - 1)
    prev = _prepend(ec, -1)
    sums = csum[ec] - torch.where((prev >= 0)[:, None], csum[prev.clamp(min=0)],
                                  torch.zeros((), device=dev))
    out = torch.zeros((capacity + 1, fdim), dtype=rows.dtype, device=dev)
    return out.index_add_(0, torch.where(valid, k[ec], capacity), sums)[:capacity]


def bump_optim_weights(weights: torch.Tensor, slots: torch.Tensor,
                       found: torch.Tensor) -> torch.Tensor:
    """+1 weight on every slot touched (once per call, duplicates collapse),
    as the reference's count_optim.  Returns the new weights."""
    cap = weights.shape[0]
    bump = torch.zeros((cap + 1,), dtype=weights.dtype, device=weights.device)
    bump[torch.where(found, slots, cap)] = 1.0
    return weights + bump[:cap]
