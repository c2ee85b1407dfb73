"""Dense slot-map sparse voxel table: direct addressing, no probe loops.

Counterpart of bnv_fusion_tpu/table_dense.py:31-255.  ``slot_map`` is a dense
int32 array over the scene's voxel grid (flat id -> slot, -1 = unallocated);
values stay compacted in [capacity, F] rows.  Unlike the JAX package's
immutable pytree, the table is MUTATED IN PLACE: inserts write the slot map,
fusion and optimization write features / weights / num_hits rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class DenseIndexedTable:
    """slot_map [n_voxels] int32, slot_flat [capacity] int32 (each slot's
    voxel flat id, -1 = free), features [capacity, F] f32, weights and
    num_hits [capacity] f32, n_alloc and overflow as 0-d int64 tensors."""

    def __init__(self, n_xyz, capacity: int, feat_dims: int,
                 device: torch.device | str):
        n_xyz = tuple(int(v) for v in n_xyz)
        n_vox = n_xyz[0] * n_xyz[1] * n_xyz[2]
        if n_vox >= 2 ** 31:
            raise ValueError(
                f"voxel grid {list(n_xyz)} has {n_vox} cells; flat ids exceed "
                "int32")
        self.n_xyz = n_xyz
        self.device = torch.device(device)
        self.slot_map = torch.full((n_vox,), -1, dtype=torch.int32,
                                   device=self.device)
        self.slot_flat = torch.full((capacity,), -1, dtype=torch.int32,
                                    device=self.device)
        self.features = torch.zeros((capacity, feat_dims), dtype=torch.float32,
                                    device=self.device)
        self.weights = torch.zeros((capacity,), dtype=torch.float32,
                                   device=self.device)
        self.num_hits = torch.zeros((capacity,), dtype=torch.float32,
                                    device=self.device)
        self.n_alloc = torch.zeros((), dtype=torch.int64, device=self.device)
        self.overflow = torch.zeros((), dtype=torch.int64, device=self.device)

    @property
    def capacity(self) -> int:
        return self.features.shape[0]

    @property
    def feat_dims(self) -> int:
        return self.features.shape[1]

    @property
    def n_voxels(self) -> int:
        return self.slot_map.shape[0]


def create_dense_table(n_xyz, capacity: int, feat_dims: int,
                       device: torch.device | str = "cpu") -> DenseIndexedTable:
    return DenseIndexedTable(n_xyz, capacity, feat_dims, device)


def _flat_ids(table: DenseIndexedTable, keys: torch.Tensor,
              valid: torch.Tensor):
    nx, ny, nz = table.n_xyz
    n = torch.as_tensor(table.n_xyz, dtype=keys.dtype, device=keys.device)
    inside = torch.all((keys >= 0) & (keys < n), dim=-1) & valid
    f = keys[:, 0].long() * (ny * nz) + keys[:, 1].long() * nz + keys[:, 2].long()
    return torch.where(inside, f, -1), inside


def lookup(table: DenseIndexedTable, query: torch.Tensor,
           valid: torch.Tensor | None = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find slots for [M, 3] integer keys: one gather.  Returns (slots
    clamped to >= 0, found)."""
    if valid is None:
        valid = torch.ones((query.shape[0],), dtype=torch.bool,
                           device=query.device)
    flat, inside = _flat_ids(table, query, valid)
    slots = torch.where(inside, table.slot_map[flat.clamp(min=0)].long(), -1)
    found = slots >= 0
    return slots.clamp(min=0), found


def lookup_coords3(table: DenseIndexedTable, cx, cy, cz, inside):
    """lookup on per-axis coordinate tensors of any (equal) shape."""
    _, ny, nz = table.n_xyz
    flat = cx.long() * (ny * nz) + cy.long() * nz + cz.long()
    flat = torch.where(inside, flat, 0)
    slots = torch.where(inside, table.slot_map[flat].long(), -1)
    found = slots >= 0
    return slots.clamp(min=0), found


def insert(table: DenseIndexedTable, new_keys: torch.Tensor,
           valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert-or-find [M, 3] integer keys, duplicates allowed, in place.

    Each distinct new voxel takes its slot at its first occurrence in the
    batch (a scatter-min of batch positions into a dense claim array), and
    the new voxels take contiguous slots in the order of those first
    occurrences, as the JAX package assigns them.  Those beyond capacity
    are dropped and counted in ``table.overflow``.  Returns (slots [M]
    int64 clamped to >= 0, ok [M])."""
    m = new_keys.shape[0]
    cap = table.capacity
    n_vox = table.n_voxels
    dev = new_keys.device
    flat, inside = _flat_ids(table, new_keys, valid)
    flat_safe = flat.clamp(min=0)

    existing = torch.where(inside, table.slot_map[flat_safe].long(), -1)
    is_new = inside & (existing < 0)
    pos = torch.arange(m, dtype=torch.int64, device=dev)
    claim = torch.full((n_vox + 1,), m, dtype=torch.int64, device=dev)
    claim.scatter_reduce_(0, torch.where(is_new, flat, n_vox),
                          torch.where(is_new, pos, m), reduce="amin")
    winner = is_new & (claim[flat_safe] == pos)

    assign = table.n_alloc + torch.cumsum(winner.long(), 0) - 1
    fits = winner & (assign < cap)
    n_new_total = winner.sum()
    n_new_fit = fits.sum()
    table.slot_map[flat_safe[fits]] = assign[fits].to(torch.int32)
    table.slot_flat[assign[fits]] = flat_safe[fits].to(torch.int32)

    slots = torch.where(inside, table.slot_map[flat_safe].long(), -1)
    table.n_alloc = torch.clamp(table.n_alloc + n_new_total, max=cap)
    table.overflow = table.overflow + (n_new_total - n_new_fit)
    return slots.clamp(min=0), slots >= 0


def insert_unique(table: DenseIndexedTable, keys: torch.Tensor,
                  valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert-or-find [U, 3] keys that are already DEDUPLICATED, in place.
    Returns (slots [U], ok [U])."""
    flat, inside = _flat_ids(table, keys, valid)
    return insert_unique_flat(table, flat, inside)


def occupancy(table: DenseIndexedTable) -> torch.Tensor:
    """Allocated slots (0-d tensor)."""
    return table.n_alloc


def gather_values(table: DenseIndexedTable, slots: torch.Tensor,
                  found: torch.Tensor):
    """(features [M, F], weights [M], num_hits [M]) at ``slots``, zero where
    not ``found``."""
    zero = torch.zeros((), device=table.device)
    f = torch.where(found[:, None], table.features[slots], zero)
    w = torch.where(found, table.weights[slots], zero)
    h = torch.where(found, table.num_hits[slots], zero)
    return f, w, h


def insert_unique_flat(table: DenseIndexedTable, flat: torch.Tensor,
                       valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert-or-find DEDUPLICATED flat voxel ids [U], in place.

    New voxels take contiguous slots in batch order; those beyond capacity
    are dropped and counted in ``table.overflow``.  Returns (slots [U]
    int64 clamped to >= 0, ok [U])."""
    cap = table.capacity
    n_vox = table.n_voxels
    flat = flat.long()
    inside = valid & (flat >= 0) & (flat < n_vox)
    flat_safe = flat.clamp(0, n_vox - 1)

    existing = torch.where(inside, table.slot_map[flat_safe].long(), -1)
    is_new = inside & (existing < 0)
    rank = torch.cumsum(is_new.long(), 0) - 1
    assign = table.n_alloc + rank
    fits = is_new & (assign < cap)
    n_new_total = is_new.sum()
    n_new_fit = fits.sum()

    table.slot_map[flat_safe[fits]] = assign[fits].to(torch.int32)
    table.slot_flat[assign[fits]] = flat_safe[fits].to(torch.int32)

    slots = torch.where(fits, assign, existing)
    ok = slots >= 0
    table.n_alloc = torch.clamp(table.n_alloc + n_new_total, max=cap)
    table.overflow = table.overflow + (n_new_total - n_new_fit)
    return slots.clamp(min=0), ok


def active_entries(table: DenseIndexedTable, with_features: bool = True):
    """Host numpy (coords, feats or None, weights, hits, slot index) of the
    allocated entries, in slot order."""
    n = int(table.n_alloc)
    flat = table.slot_flat[:n].cpu().numpy().astype(np.int64)
    _, ny, nz = table.n_xyz
    keys = np.stack([flat // (ny * nz), (flat // nz) % ny, flat % nz],
                    axis=-1).astype(np.int32)
    feats = table.features[:n].cpu().numpy() if with_features else None
    return (keys, feats, table.weights[:n].cpu().numpy(),
            table.num_hits[:n].cpu().numpy(), np.arange(n))


def load_entries(n_xyz, capacity: int, coords, features, weights, num_hits,
                 device: torch.device | str = "cpu") -> DenseIndexedTable:
    """Rebuild a table from saved (unique) entries; slots follow row order."""
    coords = np.asarray(coords)
    features = np.asarray(features, np.float32)
    if coords.shape[0] > capacity:
        raise ValueError(
            f"load_entries: {coords.shape[0]} entries exceed table capacity "
            f"{capacity}")
    table = create_dense_table(n_xyz, capacity, features.shape[1], device)
    keys = torch.as_tensor(coords.astype(np.int64), device=table.device)
    valid = torch.ones((keys.shape[0],), dtype=torch.bool, device=table.device)
    flat, inside = _flat_ids(table, keys, valid)
    if not bool(inside.all()) or torch.unique(flat).numel() != flat.numel():
        raise ValueError("load_entries: coordinates must be unique and inside "
                         "the grid")
    slots, _ = insert_unique_flat(table, flat, inside)
    table.features[slots] = torch.tensor(features, device=table.device)
    table.weights[slots] = torch.tensor(
        np.asarray(weights, np.float32).reshape(-1), device=table.device)
    table.num_hits[slots] = torch.tensor(
        np.asarray(num_hits, np.float32).reshape(-1), device=table.device)
    return table
