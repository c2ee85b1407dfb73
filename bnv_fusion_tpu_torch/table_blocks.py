"""Block-sparse slot-map voxel table: dense indexing at block granularity.

Counterpart of bnv_fusion_tpu/table_blocks.py:1-271, the table of big
scenes.  The slot map lives at 4^3-block granularity (64x smaller than the
dense table's), and the slots inside an allocated block are fixed
(block slot * 64 + local offset), so inserts and lookups stay loop-free
gathers and scatters and every fusion path runs unchanged.  A 2^31-voxel
grid needs a 134 MB block map; values stay compacted in [capacity] rows.

Allocating a block makes all 64 of its voxel slots "found" with zero
values, which every consumer treats as absent (weight 0);
``active_entries`` keeps the slots that carry state (weight or hits).

Like the dense table, the table is MUTATED IN PLACE.  ``block_map`` is a
view of one [n_blocks + 1] tensor whose last entry is a spare that takes
the writes the JAX package drops (``mode="drop"``), so no insert syncs
with the host.  Block and voxel ids are int64, so they stay exact up to
the int32 flat-id ceiling, which ``create_block_table`` enforces.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

B = 4                 # block edge
BLOCK_SLOTS = B ** 3  # 64


class BlockIndexedTable:
    """block_map [n_blocks] int32 (block coord -> block slot, -1 = none),
    features [capacity, F] f32 (capacity % 64 == 0), weights and num_hits
    [capacity] f32, n_alloc (allocated BLOCKS) and overflow (voxels
    dropped) as 0-d int64 tensors."""

    def __init__(self, n_xyz, capacity: int, feat_dims: int,
                 device: torch.device | str):
        self.n_xyz = tuple(int(v) for v in n_xyz)
        self.device = torch.device(device)
        nb = int(np.prod(self.block_grid))
        self._block_map = torch.full((nb + 1,), -1, dtype=torch.int32,
                                     device=self.device)
        self.block_map = self._block_map[:nb]
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
        gx, gy, gz = self.n_xyz
        return gx * gy * gz

    @property
    def n_blocks(self) -> int:
        return self.block_map.shape[0]

    @property
    def block_grid(self) -> Tuple[int, int, int]:
        gx, gy, gz = self.n_xyz
        return (-(-gx // B), -(-gy // B), -(-gz // B))


def create_block_table(n_xyz, capacity: int, feat_dims: int,
                       device: torch.device | str = "cpu"
                       ) -> BlockIndexedTable:
    """An empty block table over the voxel grid ``n_xyz``; ``capacity`` is
    rounded up to whole blocks.  Grids of 2^31 voxels or more raise."""
    n_xyz = [int(v) for v in n_xyz]
    n_vox = n_xyz[0] * n_xyz[1] * n_xyz[2]
    if n_vox >= 2 ** 31:
        raise ValueError(
            f"voxel grid {n_xyz} has {n_vox} cells; flat ids exceed int32 — "
            "use a coarser voxel_size.  (Scenes that fit int32 ids but not "
            "one card's memory take the region-sharded map over several "
            "cards, model.table_layout=spatial; the flat-id ceiling is "
            "int32 in every layout)")
    capacity = -(-int(capacity) // BLOCK_SLOTS) * BLOCK_SLOTS
    return BlockIndexedTable(n_xyz, capacity, feat_dims, device)


def _inside(table: BlockIndexedTable, keys: torch.Tensor) -> torch.Tensor:
    n = torch.as_tensor(table.n_xyz, dtype=keys.dtype, device=keys.device)
    return torch.all((keys >= 0) & (keys < n), dim=-1)


def _decompose(table: BlockIndexedTable, keys: torch.Tensor):
    """[M, 3] voxel coords -> (block flat id [M], local slot offset [M])."""
    _, nby, nbz = table.block_grid
    keys = keys.long()
    bc = keys // B
    lc = keys - bc * B
    bflat = (bc[:, 0] * nby + bc[:, 1]) * nbz + bc[:, 2]
    local = (lc[:, 0] * B + lc[:, 1]) * B + lc[:, 2]
    return bflat, local


def _keys_from_flat(table: BlockIndexedTable, flat: torch.Tensor
                    ) -> torch.Tensor:
    """Voxel flat ids (x-major over the full grid) -> [M, 3] int64 coords."""
    _, gy, gz = table.n_xyz
    flat = flat.long()
    return torch.stack([flat // (gy * gz), (flat // gz) % gy, flat % gz],
                       dim=-1)


def lookup(table: BlockIndexedTable, query: torch.Tensor,
           valid: torch.Tensor | None = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find slots for [M, 3] keys: two gathers.  Returns (slots [M] int64,
    0 where not found; found [M])."""
    inside = _inside(table, query)
    if valid is not None:
        inside = inside & valid
    bflat, local = _decompose(table, torch.where(inside[:, None], query, 0))
    bslot = table.block_map[bflat].long()
    found = inside & (bslot >= 0)
    return torch.where(found, bslot * BLOCK_SLOTS + local, 0), found


def _alloc_blocks(table: BlockIndexedTable, bflat: torch.Tensor,
                  want: torch.Tensor):
    """Allocate the wanted block ids (duplicates fine), in place.

    Each new block takes its slot at its first occurrence (a scatter-min of
    batch positions), and the new blocks take contiguous block slots in the
    order of those first occurrences, as the JAX package assigns them.
    Returns (block slot [M] int64, -1 where none; fits [M])."""
    nb = table.n_blocks
    block_cap = table.capacity // BLOCK_SLOTS
    m = bflat.shape[0]
    dev = bflat.device

    existing = torch.where(want, table.block_map[bflat].long(), -1)
    is_new = want & (existing < 0)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    claim = torch.full((nb + 1,), m, dtype=torch.int32, device=dev)
    claim.scatter_reduce_(0, torch.where(is_new, bflat, nb),
                          torch.where(is_new, pos, m), reduce="amin")
    winner = is_new & (claim[bflat] == pos)

    assign = table.n_alloc + torch.cumsum(winner.long(), 0) - 1
    fits_new = winner & (assign < block_cap)
    n_new_total = winner.sum()
    # the spare entry nb takes every write that is not a fitting winner's
    table._block_map[torch.where(fits_new, bflat, nb)] = \
        torch.where(fits_new, assign, 0).to(torch.int32)

    bslot = torch.where(want, table.block_map[bflat].long(), -1)
    table.n_alloc = torch.clamp(table.n_alloc + n_new_total, max=block_cap)
    return bslot, want & (bslot >= 0)


def _insert_inside(table: BlockIndexedTable, keys: torch.Tensor,
                   inside: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    bflat, local = _decompose(table, torch.where(inside[:, None], keys, 0))
    bslot, ok = _alloc_blocks(table, bflat, inside)
    table.overflow = table.overflow + (inside & ~ok).sum()
    return torch.where(ok, bslot * BLOCK_SLOTS + local, 0), ok


def insert(table: BlockIndexedTable, new_keys: torch.Tensor,
           valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert-or-find [M, 3] keys (duplicates allowed), in place.  Voxels of
    blocks beyond capacity are dropped and counted in ``table.overflow``.
    Returns (slots [M] int64, 0 where not ok; ok [M])."""
    return _insert_inside(table, new_keys, _inside(table, new_keys) & valid)


def insert_unique_flat(table: BlockIndexedTable, flat: torch.Tensor,
                       valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``insert`` on precomputed voxel flat ids (the sort-reduce fuse path),
    in place.  Ids need not be block-unique: the block allocation dedups."""
    flat = flat.long()
    inside = valid & (flat >= 0) & (flat < table.n_voxels)
    return _insert_inside(table,
                          _keys_from_flat(table, torch.where(inside, flat, 0)),
                          inside)


def occupancy(table: BlockIndexedTable) -> torch.Tensor:
    """Slots carrying state (weight or hits), a 0-d tensor: the voxel-level
    counterpart of the dense table's n_alloc."""
    return ((table.weights > 0) | (table.num_hits > 0)).sum()


def gather_values(table: BlockIndexedTable, slots: torch.Tensor,
                  found: torch.Tensor):
    """(features [M, F], weights [M], num_hits [M]) at ``slots``, zero where
    not ``found``."""
    zero = torch.zeros((), device=table.device)
    f = torch.where(found[:, None], table.features[slots], zero)
    w = torch.where(found, table.weights[slots], zero)
    h = torch.where(found, table.num_hits[slots], zero)
    return f, w, h


def _allocated_slots(table: BlockIndexedTable):
    """(block flat ids, their 64 slot ids [n_alloc * 64]) of the allocated
    blocks, in slot order, on the device."""
    bflats = torch.nonzero(table.block_map >= 0).squeeze(1)
    bslots = table.block_map[bflats].long()
    order = torch.argsort(bslots)
    bflats, bslots = bflats[order], bslots[order]
    slots = (bslots[:, None] * BLOCK_SLOTS +
             torch.arange(BLOCK_SLOTS, device=table.device)).reshape(-1)
    return bflats, slots


def active_entries(table: BlockIndexedTable, with_features: bool = True):
    """Host numpy (coords, feats or None, weights, hits, slot index) of the
    slots carrying state, in slot order.  The live slots are selected on the
    device; only they come to the host."""
    _, nby, nbz = table.block_grid
    bflats, slots = _allocated_slots(table)
    bc = torch.stack([bflats // (nby * nbz), (bflats // nbz) % nby,
                      bflats % nbz], dim=-1)                     # [A, 3]
    li = torch.arange(BLOCK_SLOTS, device=table.device)
    lc = torch.stack([li // (B * B), (li // B) % B, li % B], dim=-1)
    keys = (bc[:, None, :] * B + lc[None]).reshape(-1, 3)
    w = table.weights[slots]
    h = table.num_hits[slots]
    live = (w > 0) | (h > 0)
    slots = slots[live]
    feats = (table.features[slots].cpu().numpy() if with_features
             else None)
    return (keys[live].to(torch.int32).cpu().numpy(), feats,
            w[live].cpu().numpy(), h[live].cpu().numpy(),
            slots.cpu().numpy())


def load_entries(n_xyz, capacity: int, coords, features, weights, num_hits,
                 device: torch.device | str = "cpu") -> BlockIndexedTable:
    """Rebuild a table from saved entries (their blocks allocated in order
    of first appearance)."""
    features = np.asarray(features, np.float32)
    table = create_block_table(n_xyz, capacity, features.shape[1], device)
    keys = torch.as_tensor(np.asarray(coords).astype(np.int64),
                           device=table.device)
    valid = torch.ones((keys.shape[0],), dtype=torch.bool,
                       device=table.device)
    slots, ok = insert(table, keys, valid)
    if not bool(ok.all()):
        raise ValueError("load_entries: entries exceed block table capacity "
                         f"{table.capacity}")
    table.features[slots] = torch.tensor(features, device=table.device)
    table.weights[slots] = torch.tensor(
        np.asarray(weights, np.float32).reshape(-1), device=table.device)
    table.num_hits[slots] = torch.tensor(
        np.asarray(num_hits, np.float32).reshape(-1), device=table.device)
    return table


def lookup_coords3(table: BlockIndexedTable, cx, cy, cz, inside):
    """``lookup`` on per-axis coordinate tensors of any (equal) shape."""
    _, nby, nbz = table.block_grid
    cx, cy, cz = (torch.where(inside, c.long(), 0) for c in (cx, cy, cz))
    bcx, bcy, bcz = cx // B, cy // B, cz // B
    bflat = (bcx * nby + bcy) * nbz + bcz
    bslot = table.block_map[bflat].long()
    found = inside & (bslot >= 0)
    local = ((cx - bcx * B) * B + (cy - bcy * B)) * B + (cz - bcz * B)
    return torch.where(found, bslot * BLOCK_SLOTS + local, 0), found
