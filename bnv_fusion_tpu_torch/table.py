"""Fixed-capacity sparse voxel table: an open-addressing hash in tensors.

Counterpart of bnv_fusion_tpu/table.py:1-286, the table of unbounded
scenes (``tables.create_table`` without ``n_xyz``).  Keys [C, 3] int32
voxel coords ((-1, -1, -1) = empty), values features [C, F], weights [C]
and num_hits [C]; C is a power of two.  Probing is double hashing with a
3-int mix hash; an insert runs deterministic claim rounds: each pending key
looks at its next probe slot, matches an existing key, or claims an empty
slot by a scatter-min of batch positions (the smallest wins), after which
the winners and their duplicates resolve.  Slots are never deleted, so a
lookup that probes the same sequence is exact.  Plain torch: the JAX
package has no kernel for it.

``unroll=True`` sweeps a fixed UNROLL_PROBE rounds; the default ends the
loop once every key resolved, up to MAX_PROBE rounds (one host sync per
round).  The hash's uint32 arithmetic runs in int64 with the low 32 bits
kept after every multiply and left shift, bit for bit the JAX package's.
The table is MUTATED IN PLACE; ``keys`` is a view of one [C + 1, 3]
tensor whose last row is a spare that takes the losers' writes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MAX_PROBE = 32
UNROLL_PROBE = 12

_P1 = 0x9E3779B1
_P2 = 0x85EBCA77
_P3 = 0xC2B2AE3D
_U32 = 0xFFFFFFFF


class SparseVoxelTable:
    """keys [C, 3] int32 (-1 = empty), features [C, F] f32, weights and
    num_hits [C] f32, overflow (keys dropped after the probe budget) as a
    0-d int64 tensor."""

    def __init__(self, capacity: int, feat_dims: int,
                 device: torch.device | str):
        self.device = torch.device(device)
        self._keys = torch.full((capacity + 1, 3), -1, dtype=torch.int32,
                                device=self.device)
        self.keys = self._keys[:capacity]
        self.features = torch.zeros((capacity, feat_dims), dtype=torch.float32,
                                    device=self.device)
        self.weights = torch.zeros((capacity,), dtype=torch.float32,
                                   device=self.device)
        self.num_hits = torch.zeros((capacity,), dtype=torch.float32,
                                    device=self.device)
        self.overflow = torch.zeros((), dtype=torch.int64, device=self.device)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def feat_dims(self) -> int:
        return self.features.shape[1]


def create_table(capacity: int, feat_dims: int,
                 device: torch.device | str = "cpu") -> SparseVoxelTable:
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    return SparseVoxelTable(capacity, feat_dims, device)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant b,
    in halves so that no int64 product overflows."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _u32(coords: torch.Tensor, axis: int) -> torch.Tensor:
    """One coordinate as uint32 (negative values wrap) in int64."""
    return coords[..., axis].long() & _U32


def _hash_coords(coords: torch.Tensor, capacity: int) -> torch.Tensor:
    """Mix-hash [..., 3] int coords into [0, capacity) slot indices."""
    x = _mul32(_u32(coords, 0), _P1)
    y = _mul32(_u32(coords, 1), _P2)
    z = _mul32(_u32(coords, 2), _P3)
    h = x ^ ((y + _P1 + ((x << 6) & _U32) + (x >> 2)) & _U32)
    h = h ^ ((z + _P2 + ((h << 6) & _U32) + (h >> 2)) & _U32)
    return h & (capacity - 1)


def _probe_stride(coords: torch.Tensor, capacity: int) -> torch.Tensor:
    """Odd double-hash stride (a full cycle over a power-of-two capacity)."""
    x = _mul32(_u32(coords, 0), _P2)
    y = _mul32(_u32(coords, 1), _P3)
    z = _mul32(_u32(coords, 2), _P1)
    h = ((x ^ (y >> 3) ^ ((z << 5) & _U32)) + _P3) & _U32
    return (h | 1) & (capacity - 1)


def lookup(table: SparseVoxelTable, query: torch.Tensor,
           valid: torch.Tensor | None = None,
           unroll: bool | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find slots for [M, 3] int keys.  Returns (slots [M] int64, 0 where not
    found; found [M])."""
    cap = table.capacity
    h0 = _hash_coords(query, cap)
    stride = _probe_stride(query, cap)
    m = query.shape[0]
    dev = query.device
    slots = torch.zeros((m,), dtype=torch.int64, device=dev)
    found = torch.zeros((m,), dtype=torch.bool, device=dev)
    done = (~valid if valid is not None
            else torch.zeros((m,), dtype=torch.bool, device=dev))
    for i in range(UNROLL_PROBE if unroll else MAX_PROBE):
        if not unroll and bool(done.all()):
            break
        cand = (h0 + i * stride) & (cap - 1)
        k = table.keys[cand]
        is_match = torch.all(k == query, dim=-1) & ~done
        is_empty = (k[:, 0] < 0) & ~done
        slots = torch.where(is_match, cand, slots)
        found = found | is_match
        done = done | is_match | is_empty
    return slots, found


def insert(table: SparseVoxelTable, new_keys: torch.Tensor,
           valid: torch.Tensor, unroll: bool | None = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert-or-find [M, 3] keys (duplicates allowed), in place; values are
    untouched.  Keys still pending after the probe budget are dropped and
    counted in ``table.overflow``.  Returns (slots [M] int64, 0 where not
    ok; ok [M])."""
    cap = table.capacity
    m = new_keys.shape[0]
    dev = new_keys.device
    new_keys = new_keys.to(torch.int32)
    h0 = _hash_coords(new_keys, cap)
    stride = _probe_stride(new_keys, cap)
    ticket = torch.arange(m, dtype=torch.int32, device=dev)
    slots = torch.zeros((m,), dtype=torch.int64, device=dev)
    pending = valid.clone()
    resolved = torch.zeros((m,), dtype=torch.bool, device=dev)
    for i in range(UNROLL_PROBE if unroll else MAX_PROBE):
        if not unroll and not bool(pending.any()):
            break
        cand = (h0 + i * stride) & (cap - 1)
        k = table.keys[cand]
        # phase 1: match an existing key
        is_match = torch.all(k == new_keys, dim=-1) & pending
        slots = torch.where(is_match, cand, slots)
        resolved = resolved | is_match
        pending = pending & ~is_match
        # phase 2: claim empty slots (the smallest ticket wins)
        want = pending & (k[:, 0] < 0)
        claim = torch.full((cap,), m, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, cand, torch.where(want, ticket, m),
                              reduce="amin")
        winner = want & (claim[cand] == ticket)
        table._keys[torch.where(winner, cand, cap)] = new_keys
        # phase 3: the winners and their duplicates resolve
        is_match2 = torch.all(table.keys[cand] == new_keys, dim=-1) & pending
        slots = torch.where(is_match2, cand, slots)
        resolved = resolved | is_match2
        pending = pending & ~is_match2
    table.overflow = table.overflow + pending.sum()
    return slots, resolved


def occupancy(table: SparseVoxelTable) -> torch.Tensor:
    """Occupied slots (0-d tensor)."""
    return (table.keys[:, 0] >= 0).sum()


def gather_values(table: SparseVoxelTable, slots: torch.Tensor,
                  found: torch.Tensor):
    """(features, weights, num_hits) at ``slots``, zero where not found."""
    zero = torch.zeros((), device=table.device)
    f = torch.where(found[:, None], table.features[slots], zero)
    w = torch.where(found, table.weights[slots], zero)
    h = torch.where(found, table.num_hits[slots], zero)
    return f, w, h


def active_entries(table: SparseVoxelTable, with_features: bool = True):
    """Host numpy (coords, feats or None, weights, hits, slot index) of the
    occupied slots, in slot order."""
    idx = torch.nonzero(table.keys[:, 0] >= 0).squeeze(1)
    feats = table.features[idx].cpu().numpy() if with_features else None
    return (table.keys[idx].cpu().numpy(), feats,
            table.weights[idx].cpu().numpy(),
            table.num_hits[idx].cpu().numpy(), idx.cpu().numpy())


def load_entries(capacity: int, coords, features, weights, num_hits,
                 device: torch.device | str = "cpu") -> SparseVoxelTable:
    """Rebuild a table from saved entries."""
    features = np.asarray(features, np.float32)
    table = create_table(capacity, features.shape[1], device)
    keys = torch.tensor(np.asarray(coords, np.int32), device=table.device)
    valid = torch.ones((keys.shape[0],), dtype=torch.bool,
                       device=table.device)
    slots, _ = insert(table, keys, valid)
    table.features[slots] = torch.tensor(features, device=table.device)
    table.weights[slots] = torch.tensor(
        np.asarray(weights, np.float32).reshape(-1), device=table.device)
    table.num_hits[slots] = torch.tensor(
        np.asarray(num_hits, np.float32).reshape(-1), device=table.device)
    return table
