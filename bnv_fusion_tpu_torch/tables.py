"""Facade over the three sparse voxel tables.

Counterpart of bnv_fusion_tpu/tables.py:45-106 (``replicated_spec`` is
``shard_map``'s partition spec: each rank of the port's DP steps holds the
whole table in its own process, parallel/dp.py).

* ``DenseIndexedTable`` (table_dense.py): a dense int32 slot map over the
  scene grid; every scene whose voxel count fits the map's memory.
* ``BlockIndexedTable`` (table_blocks.py): big scenes; the slot map at
  4^3-block granularity, up to the int32 flat-id ceiling (2^31 voxels).
* ``SparseVoxelTable`` (table.py): an open-addressing hash for unbounded
  scenes (no ``n_xyz``); never routed to when bounds are known.

Routing as in the JAX package: dense below DENSE_MAP_MAX_VOXELS, blocks
(with 4x the capacity) below 2^31 voxels, ``ValueError`` beyond.  Every
table is updated in place; dispatch is by type.
"""

from __future__ import annotations

from typing import Union

import torch

from bnv_fusion_tpu_torch import table as _hash
from bnv_fusion_tpu_torch import table_blocks as _blocks
from bnv_fusion_tpu_torch import table_dense as _dense

AnyTable = Union[_hash.SparseVoxelTable, _dense.DenseIndexedTable,
                 _blocks.BlockIndexedTable]

# dense slot maps beyond this many voxels switch to block granularity (the
# limit guards memory: 512M * 4 B = 2 GB of map)
DENSE_MAP_MAX_VOXELS = 512 * 1024 * 1024


def map_layout(n_xyz=None) -> str:
    """The table ``create_table`` routes a grid of ``n_xyz`` to: "hash"
    without bounds, "dense" below DENSE_MAP_MAX_VOXELS, else "blocks"."""
    if n_xyz is None:
        return "hash"
    n_vox = int(n_xyz[0]) * int(n_xyz[1]) * int(n_xyz[2])
    return "dense" if n_vox < DENSE_MAP_MAX_VOXELS else "blocks"


def create_table(feat_dims: int, capacity: int, n_xyz=None,
                 device: torch.device | str = "cpu") -> AnyTable:
    layout = map_layout(n_xyz)
    if layout == "hash":
        return _hash.create_table(capacity, feat_dims, device)
    if layout == "dense":
        return _dense.create_dense_table(n_xyz, capacity, feat_dims, device)
    # capacity counts voxels; a surface crossing a 4^3 block touches ~1/4
    # of its 64 slots, so block tables get 4x the slots (raises at 2^31)
    return _blocks.create_block_table(n_xyz, capacity * 4, feat_dims, device)


def _mod(table: AnyTable):
    if isinstance(table, _dense.DenseIndexedTable):
        return _dense
    if isinstance(table, _blocks.BlockIndexedTable):
        return _blocks
    return _hash


def _slot_map_mod(table: AnyTable, what: str):
    mod = _mod(table)
    if mod is _hash:
        raise TypeError(f"{what} takes a slot-map table (dense or blocks), "
                        "not the hash table")
    return mod


def insert(table: AnyTable, keys: torch.Tensor, valid: torch.Tensor):
    """Insert-or-find [M, 3] keys (duplicates allowed), in place ->
    (slots, ok)."""
    return _mod(table).insert(table, keys, valid)


def lookup(table: AnyTable, query: torch.Tensor,
           valid: torch.Tensor | None = None):
    return _mod(table).lookup(table, query, valid)


def lookup_coords3(table: AnyTable, cx, cy, cz, inside):
    """``lookup`` on per-axis coordinate tensors of any (equal) shape; the
    slot-map tables (dense, blocks) only."""
    return _slot_map_mod(table, "lookup_coords3").lookup_coords3(
        table, cx, cy, cz, inside)


def gather_values(table: AnyTable, slots, found):
    return _mod(table).gather_values(table, slots, found)


def occupancy(table: AnyTable):
    return _mod(table).occupancy(table)


def active_entries(table: AnyTable, with_features: bool = True):
    return _mod(table).active_entries(table, with_features=with_features)


def insert_unique_flat(table: AnyTable, flat: torch.Tensor,
                       valid: torch.Tensor):
    """Insert-or-find precomputed voxel flat ids (sort-reduce fuse hot
    path), in place -> (slots, ok); the slot-map tables only."""
    return _slot_map_mod(table, "insert_unique_flat").insert_unique_flat(
        table, flat, valid)


def load_entries(like: AnyTable, coords, features, weights, num_hits
                 ) -> AnyTable:
    """Rebuild a table of the same kind, shape and device as ``like`` from
    saved entries."""
    if isinstance(like, _hash.SparseVoxelTable):
        return _hash.load_entries(like.capacity, coords, features, weights,
                                  num_hits, device=like.device)
    return _mod(like).load_entries(like.n_xyz, like.capacity, coords,
                                   features, weights, num_hits,
                                   device=like.device)
