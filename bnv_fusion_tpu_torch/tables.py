"""Sparse voxel table facade, dense slot map only.

Counterpart of bnv_fusion_tpu/tables.py:45-106.  The JAX package routes big
scenes to block tables and unbounded ones to a hash table; those layouts are
not ported yet (ROADMAP Queue 1 item 13), so routing to them raises, and so
does every facade call on a table of another kind.
"""

from __future__ import annotations

import torch

from bnv_fusion_tpu_torch import table_dense as _dense

AnyTable = _dense.DenseIndexedTable

# dense slot maps beyond this many voxels route to block tables in the JAX
# package (tables.py:42)
DENSE_MAP_MAX_VOXELS = 512 * 1024 * 1024


def create_table(feat_dims: int, capacity: int, n_xyz=None,
                 device: torch.device | str = "cpu") -> AnyTable:
    if n_xyz is None:
        raise NotImplementedError(
            "unbounded scenes need the hash table, which is not ported yet "
            "(ROADMAP Queue 1 item 13)")
    n_vox = int(n_xyz[0]) * int(n_xyz[1]) * int(n_xyz[2])
    if n_vox >= DENSE_MAP_MAX_VOXELS:
        raise NotImplementedError(
            f"a grid of {n_vox} voxels needs the block table, which is not "
            "ported yet (ROADMAP Queue 1 item 13)")
    return _dense.create_dense_table(n_xyz, capacity, feat_dims, device)


def _mod(table):
    if isinstance(table, _dense.DenseIndexedTable):
        return _dense
    raise NotImplementedError(
        f"{type(table).__name__}: only the dense slot-map table is ported "
        "(ROADMAP Queue 1 item 13)")


def insert(table: AnyTable, keys: torch.Tensor, valid: torch.Tensor):
    """Insert-or-find [M, 3] keys (duplicates allowed), in place ->
    (slots, ok)."""
    return _mod(table).insert(table, keys, valid)


def lookup(table: AnyTable, query: torch.Tensor,
           valid: torch.Tensor | None = None):
    return _mod(table).lookup(table, query, valid)


def gather_values(table: AnyTable, slots, found):
    return _mod(table).gather_values(table, slots, found)


def occupancy(table: AnyTable):
    return _mod(table).occupancy(table)


def active_entries(table: AnyTable, with_features: bool = True):
    return _mod(table).active_entries(table, with_features=with_features)


def insert_unique_flat(table: AnyTable, flat: torch.Tensor,
                       valid: torch.Tensor):
    """Insert-or-find precomputed voxel flat ids (sort-reduce fuse hot
    path), in place -> (slots, ok)."""
    return _mod(table).insert_unique_flat(table, flat, valid)


def load_entries(like: AnyTable, coords, features, weights, num_hits
                 ) -> AnyTable:
    """Rebuild a table of the same kind, shape and device as ``like`` from
    saved entries."""
    return _mod(like).load_entries(like.n_xyz, like.capacity, coords,
                                   features, weights, num_hits,
                                   device=like.device)
