"""Port parity of the dense table API (bnv_fusion_tpu_torch.table_dense and
the tables facade) against the JAX package, on the same numpy keys.

Slots are compared BY KEY, never by row: for every input row, whether it
found a slot and which voxel that slot holds (slot_flat), plus the
allocation count and the overflow count; both packages hand out slots in
the order of each new key's first occurrence, so the whole slot -> key map
must agree too.  Values are exact (gathers and scatters, no arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import table_dense as jtd
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu_torch import table_dense as ttd
from bnv_fusion_tpu_torch import tables as ttables

N_XYZ = (12, 10, 9)


def _keys(seed, m, dup_frac=0.5):
    """[m, 3] int32 keys with repeats, a few outside the grid, and a
    validity mask with some rows off."""
    rng = np.random.RandomState(seed)
    base = rng.randint(-1, 13, size=(m, 3)).astype(np.int32)
    rep = rng.rand(m) < dup_frac
    base[rep] = base[rng.randint(0, max(m // 4, 1), size=int(rep.sum()))]
    valid = rng.rand(m) > 0.1
    return base, valid


def _slot_keys(slot_flat, slots, ok):
    """The voxel flat id each row's slot holds (-1 where no slot)."""
    return np.where(ok, np.asarray(slot_flat)[np.asarray(slots)], -1)


@pytest.mark.parametrize("capacity", [4096, 150], ids=["fits", "overflows"])
def test_insert_with_duplicates_matches_jax(capacity):
    """Two inserts (the second half-new) into both tables: per row the same
    found flag and slot voxel, duplicates of a key share its slot, and the
    same n_alloc, overflow and slot -> key map."""
    jt = jtd.create_dense_table(N_XYZ, capacity, 4)
    tt = ttd.create_dense_table(N_XYZ, capacity, 4)
    for seed in (0, 1):
        keys, valid = _keys(seed, 700)
        jt, js, jok = jtd.insert(jt, jnp.asarray(keys), jnp.asarray(valid))
        ts, tok = ttables.insert(tt, torch.as_tensor(keys),
                                 torch.as_tensor(valid))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        tkey = _slot_keys(tt.slot_flat.numpy(), ts.numpy(), tok.numpy())
        np.testing.assert_array_equal(
            tkey, _slot_keys(jt.slot_flat, js, np.asarray(jok)))
        # every row that found a slot holds its own key there
        flat = (keys[:, 0].astype(np.int64) * N_XYZ[1] * N_XYZ[2] +
                keys[:, 1] * N_XYZ[2] + keys[:, 2])
        np.testing.assert_array_equal(tkey[tok.numpy()], flat[tok.numpy()])
        assert int(tt.n_alloc) == int(jt.n_alloc)
        assert int(tt.overflow) == int(jt.overflow)
    np.testing.assert_array_equal(tt.slot_flat.numpy(),
                                  np.asarray(jt.slot_flat))
    np.testing.assert_array_equal(tt.slot_map.numpy(), np.asarray(jt.slot_map))
    if capacity == 150:
        assert int(tt.overflow) > 0 and int(tt.n_alloc) == capacity


def test_insert_unique_matches_jax():
    """Deduplicated keys: the same slots by key, allocation and overflow."""
    rng = np.random.RandomState(3)
    flat = rng.choice(int(np.prod(N_XYZ)), size=300, replace=False)
    keys = np.stack([flat // (N_XYZ[1] * N_XYZ[2]),
                     (flat // N_XYZ[2]) % N_XYZ[1], flat % N_XYZ[2]],
                    -1).astype(np.int32)
    valid = rng.rand(300) > 0.2
    jt = jtd.create_dense_table(N_XYZ, 200, 4)
    tt = ttd.create_dense_table(N_XYZ, 200, 4)
    jt, js, jok = jtd.insert_unique(jt, jnp.asarray(keys), jnp.asarray(valid))
    ts, tok = ttd.insert_unique(tt, torch.as_tensor(keys),
                                torch.as_tensor(valid))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(
        _slot_keys(tt.slot_flat.numpy(), ts.numpy(), tok.numpy()),
        _slot_keys(jt.slot_flat, js, np.asarray(jok)))
    assert int(ttd.occupancy(tt)) == int(jtd.occupancy(jt)) == 200
    assert int(tt.overflow) == int(jt.overflow) > 0


def test_gather_values_and_load_entries_match_jax():
    """tables.load_entries (facade, like=) then lookup + gather_values and
    occupancy: exact, with zeros where a key is absent."""
    rng = np.random.RandomState(4)
    flat = rng.choice(int(np.prod(N_XYZ)), size=120, replace=False)
    coords = np.stack([flat // (N_XYZ[1] * N_XYZ[2]),
                       (flat // N_XYZ[2]) % N_XYZ[1], flat % N_XYZ[2]],
                      -1).astype(np.int32)
    feats = rng.randn(120, 4).astype(np.float32)
    w = rng.rand(120).astype(np.float32)
    h = rng.randint(1, 5, 120).astype(np.float32)
    jt = jtables.load_entries(jtd.create_dense_table(N_XYZ, 256, 4),
                              coords, feats, w, h)
    tt = ttables.load_entries(ttd.create_dense_table(N_XYZ, 256, 4),
                              coords, feats, w, h)
    assert tt.capacity == 256 and tt.n_xyz == N_XYZ
    assert int(ttables.occupancy(tt)) == int(jtables.occupancy(jt)) == 120
    query, _ = _keys(5, 400, dup_frac=0.0)
    query[:100] = coords[rng.randint(0, 120, 100)]
    js, jf = jtables.lookup(jt, jnp.asarray(query))
    ts, tf = ttables.lookup(tt, torch.as_tensor(query))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.numpy()[:100].all() and not tf.numpy().all()
    for a, b in zip(ttables.gather_values(tt, ts, tf),
                    jtables.gather_values(jt, js, jf)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_facade_refuses_other_layouts():
    """Flat ids and per-axis lookups belong to the slot-map tables (dense,
    blocks): the facade refuses them on the hash table by name."""
    hashed = ttables.create_table(4, 64)
    with pytest.raises(TypeError, match="slot-map"):
        ttables.insert_unique_flat(hashed, torch.zeros(1, dtype=torch.int64),
                                   torch.ones(1, dtype=torch.bool))
    zero = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError, match="slot-map"):
        ttables.lookup_coords3(hashed, zero, zero, zero,
                               torch.ones(2, dtype=torch.bool))
