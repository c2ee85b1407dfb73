"""Region sharding: the voxel map split across ranks by scene region.

Counterpart of bnv_fusion_tpu/parallel/spatial.py:1-270.  Data parallelism
(``parallel/dp.py``) keeps the whole table on every rank; this layout
(``model.table_layout=spatial``) splits it, so the map's memory per rank
scales as 1/D: the scene size one card's memory bounds grows with D.

Scheme, over a ``DPGroup`` of D ranks (one process each):

* rank r owns the slab of flat voxel ids [r * n_vox/D, (r+1) * n_vox/D): it
  holds that slab's slot map ([n_vox/D] int32) and its own value rows
  ([capacity/D, F] plus weights and hits).  Slot ids are shard-local, as in
  the JAX package (``SpatialTable``);
* fuse (``make_spatial_fuse_frame``, JAX :90-225): each rank runs the
  cell-keyed sort-reduce on its shard of the frame's points, the compacted
  partials are all-gathered, the keys outside the rank's slab are masked to
  its sentinel, one stable sort and windowed adds merge them in the JAX
  package's order, and the slab-local allocation and running-mean update
  (``fusion._integrate_unique`` on the slab) run per rank;
* decode, mesh and optimize (JAX :228-270 and pipeline.py:823-848): the
  queries are the same on every rank; each rank looks up the corners its
  slab owns, writes their rows and zeros elsewhere, and one all-reduce
  (SUM) assembles the 8-corner neighbourhoods (``OwnerRows``).  Each corner
  has exactly one owner, so the sum adds one value to zeros: exact.  The
  decode then runs as on one device, so the loss is the same on every rank;
  its row cotangents are too, and each rank scatters into its shard only
  the rows of the corners it owns, so the backward needs no collective
  (``optimize.make_optimize_step(..., rows=OwnerRows(group))``; every
  rank must draw the same rays and uniforms, and Adam runs per shard).
  The JAX package gets the same from XLA's partitioner on a view whose
  slot map holds global rows; torch has no partitioner, so the collectives
  are explicit here, every one through ``DPGroup`` (``traffic``);
* the host view (``spatial_active_entries``) all-gathers each rank's
  (global key, feature, weight, hits), and ``load_spatial_entries`` puts a
  saved entry into the shard that owns its key.  (The JAX package's
  ``NeuralMap.load_volume`` rebuilds an unsharded table with global slot
  ids there, which its spatial readers then offset again: every feature
  reads back wrong, ROADMAP Queue 3.)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bnv_fusion_tpu_torch import fusion
from bnv_fusion_tpu_torch import table_dense as tbd
from bnv_fusion_tpu_torch.parallel.mesh import DPGroup


def _local(name: str) -> property:
    def get(self):
        return getattr(self.local, name)

    def put(self, value):
        setattr(self.local, name, value)

    return property(get, put, doc=f"the shard's ``{name}``")


class SpatialTable:
    """This rank's shard of a region-sharded dense map.

    ``n_xyz`` is the whole grid, ``lo`` the first flat id of the rank's
    slab and ``nv_shard`` its length.  ``local`` is a ``DenseIndexedTable``
    over the slab as a 1 x 1 x nv_shard grid, so its flat ids (and its
    ``slot_flat``) are slab-local and its slots shard-local, with
    ``capacity / D`` rows; ``slot_map``, ``features``, ``weights``,
    ``num_hits``, ``n_alloc`` and ``overflow`` are the shard's (read and
    written through).  ``n_voxels`` is the whole grid's count."""

    slot_map = _local("slot_map")
    slot_flat = _local("slot_flat")
    features = _local("features")
    weights = _local("weights")
    num_hits = _local("num_hits")
    n_alloc = _local("n_alloc")
    overflow = _local("overflow")

    def __init__(self, group: DPGroup, n_xyz, capacity: int, feat_dims: int,
                 device: torch.device | str):
        d = group.size
        self.n_xyz = tuple(int(v) for v in n_xyz)
        n_vox = int(np.prod(self.n_xyz, dtype=np.int64))
        if n_vox % d or capacity % d:
            raise ValueError("n_vox and capacity must divide the mesh size")
        if n_vox >= 2 ** 31:
            raise ValueError(f"voxel grid {list(self.n_xyz)} has {n_vox} "
                             "cells; flat ids exceed int32")
        self.n_shards = d
        self.nv_shard = n_vox // d
        self.lo = group.rank * self.nv_shard
        self.local = tbd.create_dense_table((1, 1, self.nv_shard),
                                            capacity // d, feat_dims, device)

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def capacity(self) -> int:
        """The rows of this shard (capacity / D)."""
        return self.local.capacity

    @property
    def feat_dims(self) -> int:
        return self.local.feat_dims

    @property
    def n_voxels(self) -> int:
        return self.nv_shard * self.n_shards

    def nbytes(self) -> int:
        """Bytes of the shard's slot map and value rows."""
        t = self.local
        return sum(x.numel() * x.element_size() for x in (
            t.slot_map, t.slot_flat, t.features, t.weights, t.num_hits))


def create_spatial_table(group: DPGroup, n_xyz, capacity: int,
                         feat_dims: int,
                         device: Optional[torch.device | str] = None
                         ) -> SpatialTable:
    """This rank's empty shard of a map over ``n_xyz`` sharded over
    ``group``; ``capacity`` is the whole map's slot budget (divided across
    the shards).  n_vox and capacity must divide by the group's size.
    ``device`` defaults to the group's."""
    return SpatialTable(group, n_xyz, capacity, feat_dims,
                        group.device if device is None else device)


def _keys_of(flat: np.ndarray, n_xyz) -> np.ndarray:
    _, ny, nz = n_xyz
    return np.stack([flat // (ny * nz), (flat // nz) % ny, flat % nz],
                    axis=-1).astype(np.int32)


def spatial_active_entries(group: DPGroup, table: SpatialTable,
                           with_features: bool = True):
    """Host numpy (keys [n, 3] int32, features [n, F] or None, weights,
    num_hits) of every shard's allocated entries, sorted by flat voxel id,
    the same on every rank: each rank's count is all-gathered first, then
    its (global flat id) and (features, weight, hits) rows padded to the
    largest count."""
    t = table.local
    n = t.n_alloc.reshape(1).to(torch.int64)
    counts = group.all_gather(n).reshape(-1).cpu().numpy()
    width = max(int(counts.max()), 1)
    dev = t.features.device
    flat = torch.full((width,), -1, dtype=torch.int64, device=dev)
    k = int(counts[group.rank])
    flat[:k] = t.slot_flat[:k].to(torch.int64) + table.lo
    cols = ([t.features[:k]] if with_features else []) + \
        [t.weights[:k, None], t.num_hits[:k, None]]
    rows = torch.zeros((width, sum(c.shape[1] for c in cols)),
                       dtype=torch.float32, device=dev)
    rows[:k] = torch.cat(cols, dim=1)
    flat_all = group.all_gather(flat).cpu().numpy()
    rows_all = group.all_gather(rows).cpu().numpy()
    take = np.arange(width)[None, :] < counts[:, None]
    flat_v, rows_v = flat_all[take], rows_all[take]
    order = np.argsort(flat_v, kind="stable")
    flat_v, rows_v = flat_v[order], rows_v[order]
    feats = rows_v[:, :-2] if with_features else None
    return (_keys_of(flat_v, table.n_xyz), feats,
            np.ascontiguousarray(rows_v[:, -2]),
            np.ascontiguousarray(rows_v[:, -1]))


def load_spatial_entries(group: DPGroup, like: SpatialTable, coords,
                         features, weights, num_hits) -> SpatialTable:
    """A fresh shard like ``like`` holding the saved (unique) entries whose
    keys its slab owns, in row order; every rank reads the same entries and
    keeps its own.  Raises as ``table_dense.load_entries`` does, and when
    one shard's entries exceed its capacity / D rows."""
    coords = np.asarray(coords).astype(np.int64).reshape(-1, 3)
    nx, ny, nz = like.n_xyz
    inside = np.all((coords >= 0) & (coords < np.asarray(like.n_xyz)),
                    axis=-1)
    flat = coords[:, 0] * (ny * nz) + coords[:, 1] * nz + coords[:, 2]
    if not inside.all() or len(np.unique(flat)) != len(flat):
        raise ValueError("load_entries: coordinates must be unique and inside "
                         "the grid")
    table = create_spatial_table(group, like.n_xyz,
                                 like.capacity * like.n_shards,
                                 like.feat_dims, like.device)
    mine = np.nonzero((flat >= table.lo) &
                      (flat < table.lo + table.nv_shard))[0]
    if len(mine) > table.capacity:
        raise ValueError(f"load_entries: {len(mine)} entries of shard "
                         f"{group.rank} exceed its capacity "
                         f"{table.capacity}")
    t, dev = table.local, table.device
    lflat = torch.as_tensor(flat[mine] - table.lo, device=dev)
    slots, _ = tbd.insert_unique_flat(
        t, lflat, torch.ones(len(mine), dtype=torch.bool, device=dev))

    def rows(a, shape):
        return torch.as_tensor(np.asarray(a, np.float32).reshape(shape)[mine],
                               device=dev)

    t.features[slots] = rows(features, (len(flat), -1))
    t.weights[slots] = rows(weights, (-1,))
    t.num_hits[slots] = rows(num_hits, (-1,))
    return table


def make_spatial_fuse_frame(group: DPGroup, params: Dict[str, Any],
                            voxel_size: float, min_pts_in_grid: int,
                            max_unique: int = 1 << 17,
                            max_unique_cells: Optional[int] = None,
                            compute_dtype: torch.dtype = torch.float32):
    """The fuse step over a region-sharded map: ``step(table, pts_w [N, 3],
    normals [N, 3], valid [N], bound_min, bound_max) -> FrameStats``,
    updating this rank's shard in place; N must divide by the group's size.

    Each rank's point shard goes through ``fusion._cellsort_reduce``, and
    only the compacted partials cross ([D, U] keys and counts, [D, U, F]
    sums), as in the DP fuse.  Keys outside the rank's slab are masked to
    its sentinel (nv_shard), one stable sort and windowed adds of at most D
    entries (a voxel appears at most once per rank) merge the rest, and the
    slab-local ids go through ``fusion._integrate_unique`` on the shard.
    Each shard's ``overflow`` counts its merge's drops plus the drops of
    its own point shard's front; the stats are summed over the ranks."""
    n_dev = group.size

    def step(table: SpatialTable, pts_w, normals, valid, bound_min,
             bound_max) -> fusion.FrameStats:
        fdim, n_vox, nv = table.feat_dims, table.n_voxels, table.nv_shard
        dev = pts_w.device
        sl = group.shard(pts_w.shape[0])
        (flat_u, cnt_u, sum_u, umask, n_uni_shard, u, cells_dropped,
         n_valid) = fusion._cellsort_reduce(
            params, pts_w[sl], normals[sl], valid[sl], bound_min, bound_max,
            voxel_size, max_unique, max_unique_cells, table.n_xyz, n_vox,
            fdim, compute_dtype=compute_dtype)

        key = torch.where(umask, flat_u, n_vox)
        m3 = n_dev * u
        ka = group.all_gather(key).reshape(m3)
        cnt_all = group.all_gather(cnt_u).reshape(m3)
        sum_all = group.all_gather(sum_u).reshape(m3, fdim)
        # ownership filter -> slab-local flat ids; non-owned = sentinel
        local = ka - table.lo
        owned = (local >= 0) & (local < nv) & (ka < n_vox)
        zero = torch.zeros((), device=dev)
        lk = torch.where(owned, local, nv)
        cc = torch.where(owned, cnt_all, zero).to(torch.int64)
        cs = torch.where(owned[:, None], sum_all, zero)
        order = torch.argsort(lk, stable=True)
        lk_s, cc_s, cs_s = lk[order], cc[order], cs[order]

        ev = lk_s < nv
        ccum = torch.cumsum(cc_s, 0)                        # exact ints
        is_end = fusion._append(lk_s != fusion._prepend(lk_s, -1), True) & ev
        n_uni = is_end.sum().to(torch.int32)
        ub = min(max_unique, m3)
        end = torch.clamp(fusion._compact_ends(is_end, ub), max=m3 - 1)
        bmask = torch.arange(ub, device=dev) < torch.clamp(n_uni, max=ub)
        pend = fusion._prepend(end, -1)
        flat_b = lk_s[end]
        clo = torch.where(pend >= 0, ccum[pend.clamp(min=0)], 0)
        cnt_b = (ccum[end] - clo).to(torch.float32)
        seg_len = end - pend
        S = torch.zeros((ub, fdim), dtype=torch.float32, device=dev)
        for i in range(n_dev):
            take = torch.clamp(end - i, min=0)
            S = S + torch.where((i < seg_len)[:, None], cs_s[take], zero)

        fusion._integrate_unique(
            table.local, flat_b, cnt_b, S, bmask, n_uni, ub, min_pts_in_grid,
            extra_overflow=torch.clamp(n_uni_shard - u, min=0) +
            cells_dropped)
        tot = group.all_reduce(torch.stack([
            torch.sum(torch.where(bmask, cnt_b, zero)),
            n_uni.to(torch.float32), n_valid.to(torch.float32)]))
        return fusion.FrameStats(
            n_avg_pts=tot[0] / torch.clamp(tot[1], min=1.0),
            n_touched=tot[1], n_valid_pts=tot[2])

    return step


class OwnerRows:
    """The corner-row hook (``rows=``) of ``fusion.decode_prepare``,
    ``decode_points``, ``render.prepare_render`` and
    ``optimize.make_optimize_step`` for a ``SpatialTable``: owner-assembled
    neighbourhoods.  Every rank passes the same corners; each looks up
    those its slab owns, and an all-reduce (SUM) over ``group`` assembles
    what the owners hold."""

    def __init__(self, group: DPGroup):
        self.group = group

    def lookup(self, table: SpatialTable, corners: torch.Tensor,
               weights: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Corner coords [K, 3] -> (shard-local slots [K] clamped to >= 0,
        owned [K]: the corner's row is in this shard, found [K]: in some
        shard, weights [K]: ``weights`` at the owner's row, 0 where none);
        one all-reduce of [K, 2] (owned, weight)."""
        _, ny, nz = table.n_xyz
        n = torch.as_tensor(table.n_xyz, dtype=corners.dtype,
                            device=corners.device)
        inside = torch.all((corners >= 0) & (corners < n), dim=-1)
        c = corners.long()
        flat = c[:, 0] * (ny * nz) + c[:, 1] * nz + c[:, 2] - table.lo
        mine = inside & (flat >= 0) & (flat < table.nv_shard)
        sl = torch.where(mine, table.slot_map[flat.clamp(
            0, table.nv_shard - 1)].long(), -1)
        owned = sl >= 0
        slots = sl.clamp(min=0)
        zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
        both = self.group.all_reduce(torch.stack(
            [owned.to(weights.dtype),
             torch.where(owned, weights[slots], zero)], dim=-1))
        return slots, owned, both[:, 0] > 0, both[:, 1]

    def gather(self, rows: torch.Tensor, slots: torch.Tensor,
               owned: torch.Tensor) -> torch.Tensor:
        """``rows`` [C, F] of this shard at the owned corners, assembled
        over the ranks: [K, F], zeros where no rank owns the corner; one
        all-reduce of [K, F]."""
        zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
        return self.group.all_reduce(
            torch.where(owned[:, None], rows[slots], zero))


def make_spatial_decode(group: DPGroup, params: Dict[str, Any],
                        voxel_size: float, min_pts_in_grid: int,
                        **decode_kwargs):
    """The SDF decode over a region-sharded map: ``decode(table, coords
    [M, 3] voxel coords) -> sdf [M]``, the same on every rank (the queries
    must be too).  Each rank contributes the corners it owns and
    ``OwnerRows`` assembles cells that straddle slabs; the rest is
    ``fusion.decode_points`` with ``decode_kwargs`` (sdf_delta, n_xyz,
    use_fused_kernel, masked_fill, layout, packed_decoder)."""
    rows = OwnerRows(group)

    def decode(table: SpatialTable, coords: torch.Tensor) -> torch.Tensor:
        return fusion.decode_points(
            table.features, table, params, coords, None, voxel_size,
            min_pts_in_grid, is_coords=True, rows=rows, **decode_kwargs)

    return decode

