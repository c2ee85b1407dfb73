"""Port parity of the open-addressing hash table (bnv_fusion_tpu_torch.table),
the table of unbounded scenes, against the JAX package on the same numpy
keys: the uint32 hash and probe stride bit for bit (negative coordinates
wrap), insert and lookup with both probe strategies slot for slot (the
claim rounds are deterministic), overflow under pressure, and the hash
branch of fuse_frame and the decode through a hash table (features and
SDF within 1e-5: the capacity-sized scatter-adds sum in other orders).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import fusion as jfusion
from bnv_fusion_tpu import pipeline as jpipe
from bnv_fusion_tpu import table as jth
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu import voxel as jvoxel
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import table as tth
from bnv_fusion_tpu_torch import tables as ttables


def _coords(seed, m, span=1000):
    """[m, 3] int32 coords, negative and extreme ones among them."""
    rng = np.random.RandomState(seed)
    c = rng.randint(-span, span, size=(m, 3)).astype(np.int32)
    c[:4] = [[-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 0],
             [-2 ** 31, 2 ** 31 - 1, -7], [123456789, -987654321, 5]]
    return c


def _keys(seed, m, span):
    """[m, 3] table keys: x in [0, span), y and z in [-span, span) (both
    packages read a slot whose key has x < 0 as empty)."""
    c = np.random.RandomState(seed).randint(-span, span, size=(m, 3))
    c[:, 0] = np.abs(c[:, 0])
    return c.astype(np.int32)


@pytest.mark.parametrize("capacity", [1 << 4, 1 << 19, 1 << 30])
def test_hash_and_stride_bit_equal(capacity):
    """_hash_coords and _probe_stride on negative, extreme and random
    coordinates: bit-equal; the stride odd and inside the capacity."""
    c = _coords(0, 5000)
    for fn in ("_hash_coords", "_probe_stride"):
        want = np.asarray(getattr(jth, fn)(jnp.asarray(c), capacity))
        got = getattr(tth, fn)(torch.as_tensor(c), capacity).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < capacity
    assert (tth._probe_stride(torch.as_tensor(c), capacity) % 2 == 1).all()


def _insert_both(keys, valid, capacity, unroll, jt=None, tt=None):
    jt = jth.create_table(capacity, 4) if jt is None else jt
    tt = tth.create_table(capacity, 4) if tt is None else tt
    jt, js, jok = jth.insert(jt, jnp.asarray(keys), jnp.asarray(valid),
                             unroll=unroll)
    ts, tok = tth.insert(tt, torch.as_tensor(keys), torch.as_tensor(valid),
                         unroll=unroll)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    assert int(tt.overflow) == int(jt.overflow)
    return jt, tt


@pytest.mark.parametrize("unroll", [False, True], ids=["loop", "unrolled"])
def test_insert_and_lookup_match_jax(unroll):
    """Two inserts (keys with duplicates, invalid rows, negative coords),
    then lookups with and without a validity mask: the same slots, ok
    flags, key array and overflow (none at this load)."""
    rng = np.random.RandomState(1)
    keys = _keys(1, 900, span=40)
    rep = rng.rand(900) < 0.3
    keys[rep] = keys[rng.randint(0, 200, int(rep.sum()))]
    valid = rng.rand(900) > 0.1
    jt, tt = _insert_both(keys[:500], valid[:500], 1 << 12, unroll)
    jt, tt = _insert_both(keys[500:], valid[500:], 1 << 12, unroll, jt, tt)
    assert int(tt.overflow) == 0
    query = np.concatenate([keys[:300], _keys(2, 200, span=60)])
    qvalid = rng.rand(500) > 0.2
    for v in (None, qvalid):
        js, jf = jth.lookup(jt, jnp.asarray(query),
                            None if v is None else jnp.asarray(v),
                            unroll=unroll)
        ts, tf = ttables.lookup(tt, torch.as_tensor(query),
                                None if v is None else torch.as_tensor(v))
        if unroll:
            ts, tf = tth.lookup(tt, torch.as_tensor(query),
                                None if v is None else torch.as_tensor(v),
                                unroll=True)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ts.numpy()[tf.numpy()],
                                      np.asarray(js)[np.asarray(jf)])
    assert tf.numpy()[:300].any() and not tf.numpy().all()


@pytest.mark.parametrize("unroll", [False, True], ids=["loop", "unrolled"])
def test_overflow_under_pressure_matches_jax(unroll):
    """More distinct keys than a 256-slot table can take within the probe
    budget: the same resolved slots, dropped keys and overflow count."""
    keys = np.unique(_keys(3, 400, span=30), axis=0)[:300]
    _, tt = _insert_both(keys, np.ones(len(keys), bool), 256, unroll)
    assert int(tt.overflow) >= len(keys) - 256
    assert int(tth.occupancy(tt)) == len(keys) - int(tt.overflow)


def test_table_api_matches_jax():
    """The facade: create_table without bounds, load_entries, occupancy,
    gather_values and active_entries (slot order), exact."""
    rng = np.random.RandomState(4)
    coords = np.unique(_keys(4, 300, span=50), axis=0)
    n = len(coords)
    feats = rng.randn(n, 4).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    h = rng.randint(1, 4, n).astype(np.float32)
    tt = ttables.create_table(4, 1 << 10)
    assert isinstance(tt, tth.SparseVoxelTable)
    jt = jtables.load_entries(jtables.create_table(4, 1 << 10), coords,
                              feats, w, h)
    tt = ttables.load_entries(tt, coords, feats, w, h)
    assert isinstance(tt, tth.SparseVoxelTable) and tt.capacity == 1 << 10
    assert int(ttables.occupancy(tt)) == int(jtables.occupancy(jt)) == n
    for a, b in zip(ttables.active_entries(tt), jtables.active_entries(jt)):
        np.testing.assert_array_equal(a, b)
    js, jf = jtables.lookup(jt, jnp.asarray(coords[:100]))
    ts, tf = ttables.lookup(tt, torch.as_tensor(coords[:100]))
    for a, b in zip(ttables.gather_values(tt, ts, tf),
                    jtables.gather_values(jt, js, jf)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="power of two"):
        tth.create_table(1000, 4)


def test_negative_x_key_reads_as_empty_as_in_jax():
    """Both packages mark an empty slot by x < 0, so a key with negative x
    is not counted and a later key may claim its slot: the same key array
    and occupancy on both sides (kept as the JAX package has it; fused
    voxel keys, relative to the scene's lower bound, are never negative)."""
    keys = np.array([[-3, 1, 1], [5, 2, 2], [-3, 1, 1], [7, -4, 9]],
                    np.int32)
    jt, tt = _insert_both(keys, np.ones(4, bool), 1 << 4, False)
    assert int(tth.occupancy(tt)) == int(jth.occupancy(jt)) == 2


VOXEL = 0.03
CAP = 1 << 16
DEC_MIN_W = 0.5     # the decode's weight gate: two frames give at most 2
OVERRIDES = ["dataset.img_res=[60,80]", "dataset.num_images=6",
             f"model.voxel_size={VOXEL}"]


@pytest.fixture(scope="module")
def fused():
    """Two frames fused into a 2^16-slot hash table by both packages."""
    cfg = jload_config(OVERRIDES)
    ds = SyntheticDemoDataset(cfg, "val")
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))
    mn, mx, _ = jvoxel.get_world_range(ds.dimensions, VOXEL)
    jt = jtables.create_table(8, CAP)
    tt = ttables.create_table(8, CAP)
    tp = tnn.params_from_numpy(params, "cpu")
    jfn = jax.jit(partial(jfusion.fuse_frame, voxel_size=VOXEL,
                          min_pts_in_grid=2))
    stats = []
    for i in range(2):
        f = ds[i]
        p = [np.array(x) for x in jpipe._frame_points(
            jnp.asarray(f["depth"]), jnp.asarray(f["T_wc"]),
            jnp.asarray(f["intr_mat"]))]
        jt, js = jfn(jt, jax.tree.map(jnp.asarray, params),
                     *map(jnp.asarray, p), jnp.asarray(mn), jnp.asarray(mx))
        ts = tfusion.fuse_frame(tt, tp, *map(torch.as_tensor, p),
                                torch.as_tensor(mn), torch.as_tensor(mx),
                                VOXEL, 2)
        stats.append((js, ts))
    return dict(jt=jt, tt=tt, params=params, tp=tp, mn=mn, stats=stats)


def test_fuse_frame_on_hash_table_matches_jax(fused):
    """The hash branch of fuse_frame: the same key -> slot map, weights and
    hits exactly, features within 1e-5, and the frame statistics."""
    jt, tt = fused["jt"], fused["tt"]
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    assert int(tt.overflow) == int(jt.overflow) == 0
    jk, jf, jw, jh, _ = jtables.active_entries(jt)
    tk, tf, tw, th, _ = ttables.active_entries(tt)
    assert len(tk) > 1000 and (tw > 0).sum() > 500
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(tf, jf, atol=1e-5)
    for js, ts in fused["stats"]:
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("layout", ["rows", "fm"])
def test_decode_on_hash_table_matches_jax(fused, layout):
    """decode_points through the hash table (fm falls to the rows layout,
    as in the JAX package): within 1e-5 of JAX's, bit-equal across the two
    layout names."""
    jt, tt = fused["jt"], fused["tt"]
    keys = ttables.active_entries(tt, with_features=False)[0]
    rng = np.random.RandomState(5)
    coords = (keys[rng.randint(0, len(keys), 2000)] +
              rng.rand(2000, 3)).astype(np.float32)

    def dec(lay):
        return tfusion.decode_points(
            tt.features, tt, fused["tp"], torch.as_tensor(coords),
            torch.as_tensor(fused["mn"]), VOXEL, DEC_MIN_W, is_coords=True,
            layout=lay).numpy()

    got = dec(layout)
    np.testing.assert_array_equal(got, dec("rows"))
    want = jax.jit(partial(jfusion.decode_points, voxel_size=VOXEL,
                           min_pts_in_grid=DEC_MIN_W, is_coords=True,
                           layout=layout))(
        jt.features, jt, jax.tree.map(jnp.asarray, fused["params"]),
        jnp.asarray(coords), jnp.asarray(fused["mn"]))
    assert np.isfinite(got).all() and (got != VOXEL).any()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
