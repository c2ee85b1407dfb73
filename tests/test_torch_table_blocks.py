"""Port parity of the block-sparse slot-map table (bnv_fusion_tpu_torch.
table_blocks), the tables facade's routing, and the fusion and decode paths
on a block table, against the JAX package on the same numpy inputs.

Slot positions are deterministic in both packages (a scatter-min claim of
first occurrences, a cumsum rank), so slots are compared directly, with
the block map, the block count and the overflow.  Fused tables are
compared by voxel key: keys, weights and hits exactly; features to 1e-5
on the merged route's direct segment sums (the two sides sum in other
orders) and to 2e-3 on the per-frame routes' mean-centered cumsum fronts,
whose cancellation noise each side carries in its own order (the bound
tests/test_torch_fusion.py holds those fronts to).  Against the port's
own dense table on the same inputs, bit for bit.
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
from bnv_fusion_tpu import table_blocks as jtb
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu import voxel as jvoxel
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import table as tth
from bnv_fusion_tpu_torch import table_blocks as ttb
from bnv_fusion_tpu_torch import table_dense as ttd
from bnv_fusion_tpu_torch import tables as ttables

N_XYZ = (37, 29, 41)      # no axis a multiple of the block edge
FEAT_ATOL = {"merged": 1e-5, "cell": 2e-3, "corner": 2e-3}


def _keys(seed, m, lo=-2, hi=45, dup_frac=0.3):
    """[m, 3] int32 keys with repeats, some outside the grid, and a
    validity mask with some rows off."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(lo, hi, size=(m, 3)).astype(np.int32)
    rep = rng.rand(m) < dup_frac
    keys[rep] = keys[rng.randint(0, max(m // 4, 1), size=int(rep.sum()))]
    return keys, rng.rand(m) > 0.1


def _same_state(tt, jt):
    np.testing.assert_array_equal(tt.block_map.numpy(),
                                  np.asarray(jt.block_map))
    assert int(tt.n_alloc) == int(jt.n_alloc)
    assert int(tt.overflow) == int(jt.overflow)


@pytest.mark.parametrize("capacity", [900 * 64, 12 * 64],
                         ids=["fits", "overflows"])
def test_insert_with_duplicates_matches_jax(capacity):
    """Two inserts of keys with duplicates, invalid rows and out-of-grid
    keys: the same slots and ok flags row by row, block map, block count
    and overflow; under capacity pressure the excess blocks' voxels drop."""
    jt = jtb.create_block_table(np.asarray(N_XYZ), capacity, 4)
    tt = ttb.create_block_table(N_XYZ, capacity, 4)
    for seed in (0, 1):
        keys, valid = _keys(seed, 600)
        jt, js, jok = jtb.insert(jt, jnp.asarray(keys), jnp.asarray(valid))
        ts, tok = ttables.insert(tt, torch.as_tensor(keys),
                                 torch.as_tensor(valid))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        _same_state(tt, jt)
    if capacity == 12 * 64:
        assert int(tt.overflow) > 0 and int(tt.n_alloc) == 12
    else:
        assert int(tt.overflow) == 0


def test_insert_unique_flat_matches_jax():
    """Flat ids (the fuse path's insert): invalid rows, ids outside the
    grid and several voxels of one block, under capacity pressure."""
    rng = np.random.RandomState(2)
    n_vox = int(np.prod(N_XYZ))
    flat = rng.choice(n_vox, size=500, replace=False).astype(np.int32)
    flat[:20] = rng.randint(n_vox, n_vox + 100, 20)
    flat[20:30] = -1 - np.arange(10)
    valid = rng.rand(500) > 0.1
    jt = jtb.create_block_table(np.asarray(N_XYZ), 200 * 64, 4)
    tt = ttb.create_block_table(N_XYZ, 200 * 64, 4)
    jt, js, jok = jtb.insert_unique_flat(jt, jnp.asarray(flat),
                                         jnp.asarray(valid))
    ts, tok = ttables.insert_unique_flat(tt, torch.as_tensor(flat),
                                         torch.as_tensor(valid))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _same_state(tt, jt)
    assert int(tt.overflow) > 0


def _loaded(seed, n=150):
    """Both packages' tables after inserting n unique keys and setting
    their values."""
    rng = np.random.RandomState(seed)
    flat = rng.choice(int(np.prod(N_XYZ)), size=n, replace=False)
    coords = np.stack([flat // (N_XYZ[1] * N_XYZ[2]),
                       (flat // N_XYZ[2]) % N_XYZ[1], flat % N_XYZ[2]],
                      -1).astype(np.int32)
    feats = rng.randn(n, 4).astype(np.float32)
    w = rng.rand(n).astype(np.float32) + 0.1
    h = rng.randint(0, 4, n).astype(np.float32)
    jt = jtables.load_entries(
        jtb.create_block_table(np.asarray(N_XYZ), 256 * 64, 4), coords, feats,
        w, h)
    tt = ttables.load_entries(ttb.create_block_table(N_XYZ, 256 * 64, 4),
                              coords, feats, w, h)
    return jt, tt, coords


def test_lookup_and_gather_values_match_jax():
    """lookup (with and without a validity mask), lookup_coords3 and
    gather_values after load_entries: exact, zeros where absent."""
    jt, tt, coords = _loaded(4)
    _same_state(tt, jt)
    query, valid = _keys(5, 400, dup_frac=0.0)
    query[:100] = coords[np.random.RandomState(6).randint(0, 150, 100)]
    for v in (None, valid):
        js, jf = jtb.lookup(jt, jnp.asarray(query),
                            None if v is None else jnp.asarray(v))
        ts, tf = ttables.lookup(tt, torch.as_tensor(query),
                                None if v is None else torch.as_tensor(v))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tf.numpy()[:100].any() and not tf.numpy().all()
    for a, b in zip(ttables.gather_values(tt, ts, tf),
                    jtables.gather_values(jt, js, jf)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q3 = query.reshape(4, 100, 3)
    inside = np.all((q3 >= 0) & (q3 < np.asarray(N_XYZ)), -1)
    js3, jf3 = jtb.lookup_coords3(jt, *(jnp.asarray(q3[..., i])
                                        for i in range(3)),
                                  jnp.asarray(inside))
    ts3, tf3 = ttables.lookup_coords3(tt, *(torch.as_tensor(q3[..., i])
                                            for i in range(3)),
                                      torch.as_tensor(inside))
    np.testing.assert_array_equal(tf3.numpy(), np.asarray(jf3))
    np.testing.assert_array_equal(ts3.numpy(), np.asarray(js3))


def test_active_entries_and_occupancy_match_jax():
    """active_entries (the live slots only, in slot order) and occupancy,
    exact; a round trip through the facade's load_entries keeps them."""
    jt, tt, _ = _loaded(7)
    jk, jf, jw, jh, js = jtb.active_entries(jt)
    tk, tf, tw, th, ts = ttables.active_entries(tt)
    for a, b in zip((tk, tf, tw, th, ts), (jk, jf, jw, jh, js)):
        np.testing.assert_array_equal(a, b)
    assert ttables.active_entries(tt, with_features=False)[1] is None
    assert int(ttables.occupancy(tt)) == int(jtb.occupancy(jt)) == 150
    tt2 = ttables.load_entries(tt, tk, tf, tw, th)
    assert isinstance(tt2, ttb.BlockIndexedTable)
    assert tt2.capacity == tt.capacity and tt2.n_xyz == tt.n_xyz
    for a, b in zip(ttables.active_entries(tt2), (tk, tf, tw, th, ts)):
        np.testing.assert_array_equal(a, b)


def test_routing_policy_matches_jax():
    """create_table routes as the JAX package does: dense, blocks at the
    JAX test's 671M-voxel grid with 4x the capacity, the hash table without
    bounds, and a ValueError at the int32 flat-id ceiling."""
    assert isinstance(ttables.create_table(8, 1024, n_xyz=[64, 64, 64]),
                      ttd.DenseIndexedTable)
    big = [1024, 1024, 640]
    jt = jtables.create_table(8, 64 * 64, n_xyz=big)
    tt = ttables.create_table(8, 64 * 64, n_xyz=big)
    assert isinstance(tt, ttb.BlockIndexedTable)
    assert isinstance(jt, jtb.BlockIndexedTable)
    assert tt.capacity == jt.capacity == 4 * 64 * 64
    assert tt.n_blocks == jt.block_map.shape[0]
    keys = np.array([[0, 0, 0], [512, 512, 320], [1023, 1023, 639]], np.int32)
    jt, js, jok = jtb.insert(jt, jnp.asarray(keys), jnp.ones((3,), bool))
    ts, tok = ttables.insert(tt, torch.as_tensor(keys),
                             torch.ones(3, dtype=torch.bool))
    assert tok.numpy().all()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert isinstance(ttables.create_table(8, 1024), tth.SparseVoxelTable)
    assert isinstance(jtables.create_table(8, 1024), jth.SparseVoxelTable)
    for n_xyz in ([2048, 2048, 1024], [2048, 2048, 512]):
        with pytest.raises(ValueError, match="int32"):
            jtables.create_table(8, 1024, n_xyz=n_xyz)
        with pytest.raises(ValueError, match="spatial"):
            ttables.create_table(8, 1024, n_xyz=n_xyz)


def test_ids_exact_at_the_int32_ceiling():
    """A grid just under 2^31 voxels: keys and flat ids at its far corner
    (flat id 2^31 - 2^22 - 1 and below) insert and look up to the JAX
    package's slots; the flat ids decompose back to their keys exactly."""
    n_xyz = [2048, 2048, 511]
    n_vox = int(np.prod(n_xyz))
    assert n_vox == 2 ** 31 - 2 ** 22
    keys = np.array([[0, 0, 0], [2047, 2047, 510], [1000, 1500, 300],
                     [2047, 2046, 509], [2047, 2047, 511]], np.int32)
    flat = np.array([n_vox - 1, n_vox - 2, n_vox - 511 * 4 - 3, n_vox,
                     2 ** 31 - 1], np.int64)
    jt = jtables.create_table(4, 64, n_xyz=n_xyz)
    tt = ttables.create_table(4, 64, n_xyz=n_xyz)
    jt, js, jok = jtb.insert(jt, jnp.asarray(keys), jnp.ones((5,), bool))
    ts, tok = ttables.insert(tt, torch.as_tensor(keys),
                             torch.ones(5, dtype=torch.bool))
    np.testing.assert_array_equal(tok.numpy(), [True] * 4 + [False])
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jt, js, jok = jtb.insert_unique_flat(jt, jnp.asarray(flat, jnp.int32),
                                         jnp.ones((5,), bool))
    ts, tok = ttables.insert_unique_flat(tt, torch.as_tensor(flat),
                                         torch.ones(5, dtype=torch.bool))
    np.testing.assert_array_equal(tok.numpy(), [True] * 3 + [False] * 2)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = ttb._keys_from_flat(tt, torch.as_tensor(flat[:3])).numpy()
    np.testing.assert_array_equal(
        back[:, 0] * (n_xyz[1] * n_xyz[2]) + back[:, 1] * n_xyz[2] +
        back[:, 2], flat[:3])
    np.testing.assert_array_equal(back[0], [2047, 2047, 510])
    _same_state(tt, jt)


# ---------------------------------------------------------------------------
# fusion and decode on a block table
# ---------------------------------------------------------------------------

VOXEL = 0.03
MIN_PTS = 2
MU, MUC = 16384, 8192
CAP = 1 << 16
OVERRIDES = ["dataset.img_res=[60,80]", "dataset.num_images=6",
             f"model.voxel_size={VOXEL}"]


@pytest.fixture(scope="module")
def scene():
    cfg = jload_config(OVERRIDES)
    ds = SyntheticDemoDataset(cfg, "val")
    frames = [ds[i] for i in range(2)]
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))
    pts = [jax.tree.map(np.asarray, jpipe._frame_points(
        jnp.asarray(f["depth"]), jnp.asarray(f["T_wc"]),
        jnp.asarray(f["intr_mat"]))) for f in frames]
    pw, nw, va = (np.stack([p[j] for p in pts]) for j in range(3))
    mn, mx, n_xyz = jvoxel.get_world_range(ds.dimensions, VOXEL)
    return dict(params=params, pw=pw, nw=nw, va=va, mn=mn, mx=mx,
                n_xyz=tuple(int(v) for v in n_xyz))


def _by_key(table_mod, table):
    k, f, w, h, _ = table_mod.active_entries(table)
    o = np.lexsort(k.T[::-1])
    return k[o], f[o], w[o], h[o]


def _port_fuse(s, table, algorithm):
    tp = tnn.params_from_numpy(s["params"], "cpu")
    t = torch.as_tensor
    if algorithm == "merged":
        tfusion.fuse_frames_merged(
            table, tp, t(s["pw"]), t(s["nw"]), t(s["va"]), t(s["mn"]),
            t(s["mx"]), VOXEL, MIN_PTS, max_unique=MU, max_unique_cells=MUC,
            seg_kernel="interpret")
        return
    for k in range(s["pw"].shape[0]):
        tfusion.fuse_frame(table, tp, t(s["pw"][k]), t(s["nw"][k]),
                           t(s["va"][k]), t(s["mn"]), t(s["mx"]), VOXEL,
                           MIN_PTS, max_unique=MU, max_unique_cells=MUC,
                           algorithm=algorithm)


@pytest.mark.parametrize("algorithm", ["cell", "corner", "merged"])
def test_fuse_on_block_table_equals_dense_and_jax(scene, algorithm):
    """Each fuse route into a block table: bit-equal to the same route into
    the port's dense table, and by key within FEAT_ATOL of the JAX
    package's block table (the live entries; weights and hits exact)."""
    s = scene
    tb = ttb.create_block_table(s["n_xyz"], CAP, 8)
    td = ttd.create_dense_table(s["n_xyz"], CAP, 8)
    _port_fuse(s, tb, algorithm)
    _port_fuse(s, td, algorithm)
    bk = _by_key(ttb, tb)
    dk = _by_key(ttd, td)
    live = (dk[2] > 0) | (dk[3] > 0)   # dense lists min-pts-dropped voxels
    assert live.sum() > 500 and int(tb.overflow) == 0
    for a, b in zip(bk, dk):
        np.testing.assert_array_equal(a, b[live])

    jt = jtb.create_block_table(np.asarray(s["n_xyz"]), CAP, 8)
    params = jax.tree.map(jnp.asarray, s["params"])
    a = (jnp.asarray(s["mn"]), jnp.asarray(s["mx"]))
    if algorithm == "merged":
        fn = jax.jit(partial(jfusion.fuse_frames_merged, voxel_size=VOXEL,
                             min_pts_in_grid=MIN_PTS, max_unique=MU,
                             max_unique_cells=MUC, seg_kernel="interpret"))
        jt, _ = fn(jt, params, jnp.asarray(s["pw"]), jnp.asarray(s["nw"]),
                   jnp.asarray(s["va"]), *a)
    else:
        fn = jax.jit(partial(jfusion.fuse_frame, voxel_size=VOXEL,
                             min_pts_in_grid=MIN_PTS, max_unique=MU,
                             max_unique_cells=MUC, algorithm=algorithm))
        for k in range(s["pw"].shape[0]):
            jt, _ = fn(jt, params, jnp.asarray(s["pw"][k]),
                       jnp.asarray(s["nw"][k]), jnp.asarray(s["va"][k]), *a)
    jk = _by_key(jtb, jt)
    np.testing.assert_array_equal(bk[0], jk[0])
    np.testing.assert_array_equal(bk[2], jk[2])
    np.testing.assert_array_equal(bk[3], jk[3])
    np.testing.assert_allclose(bk[1], jk[1], atol=FEAT_ATOL[algorithm])


@pytest.mark.parametrize("layout", ["rows", "fm"])
def test_decode_on_block_table_equals_dense_and_jax(scene, layout):
    """decode_points through a block table in both layouts: bit-equal to
    the port's dense table, within 1e-6 of the JAX package's block table."""
    s = scene
    tb = ttb.create_block_table(s["n_xyz"], CAP, 8)
    td = ttd.create_dense_table(s["n_xyz"], CAP, 8)
    _port_fuse(s, tb, "merged")
    _port_fuse(s, td, "merged")
    keys = ttables.active_entries(tb, with_features=False)[0]
    rng = np.random.RandomState(3)
    coords = (keys[rng.randint(0, len(keys), 2000)] +
              rng.rand(2000, 3)).astype(np.float32)
    tp = tnn.params_from_numpy(s["params"], "cpu")

    def dec(table):
        return tfusion.decode_points(
            table.features, table, tp, torch.as_tensor(coords),
            torch.as_tensor(s["mn"]), VOXEL, MIN_PTS, is_coords=True,
            layout=layout).numpy()

    got = dec(tb)
    np.testing.assert_array_equal(got, dec(td))
    jt = jtables.load_entries(
        jtb.create_block_table(np.asarray(s["n_xyz"]), CAP, 8),
        *ttables.active_entries(tb)[:4])
    want = jax.jit(partial(jfusion.decode_points, voxel_size=VOXEL,
                           min_pts_in_grid=MIN_PTS, is_coords=True,
                           layout=layout))(
        jt.features, jt, jax.tree.map(jnp.asarray, s["params"]),
        jnp.asarray(coords), jnp.asarray(s["mn"]))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
