"""Sparse voxel table facade, dense slot map only.

Counterpart of bnv_fusion_tpu/tables.py:45-106.  The JAX package routes big
scenes to block tables and unbounded ones to a hash table; those layouts are
not ported yet (ROADMAP Queue 1 item 13), so routing to them raises.
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


lookup = _dense.lookup
insert_unique_flat = _dense.insert_unique_flat
active_entries = _dense.active_entries
