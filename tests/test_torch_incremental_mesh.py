"""Port parity of demo mode: the incremental mesher, its weld keys and native
cell ids, NeuralMap.extract_mesh_incremental and run_e2e's demo loop, each
held against the JAX package on the same numpy inputs (CPU, small sizes).

The mesher runs on tests/test_incremental_mesh.py's analytic sphere: both
packages get the same decode function, so their meshes must be bit-identical
over a whole sequence of updates.  NeuralMap runs at tests/test_torch_e2e.py's
point (60x80, voxel 0.05, K=2, the decoder's output bias shifted so the
level set crosses the map), where the two decodes differ in float rounding
only: its triangles are held to a mutual F-score >= 0.99 at voxel/4, its
change masks, by voxel key, must be equal, and its cache must hold the
triangles of a fresh mesher.
"""

import numpy as np
import pytest
import torch

import jax
from bnv_fusion_tpu import mesh as jmesh
from bnv_fusion_tpu import native as jnative
from bnv_fusion_tpu import nn as jnn
from bnv_fusion_tpu import run_e2e as jrun_e2e
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.incremental_mesh import IncrementalMesher as JMesher
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import evaluation, mesh as tmesh
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import native as tnative
from bnv_fusion_tpu_torch import run_e2e
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.incremental_mesh import IncrementalMesher
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

VS = 0.05
MIN_COORDS = np.array([-1.0, -1.0, -1.0], np.float32)
N_XYZ = np.array([40, 40, 40])


def _sphere():
    """Active voxels of a shell around the r=0.5 sphere (it covers r=0.52
    too), their weights and zero latents."""
    r = np.arange(0, 40)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    d = np.abs(np.linalg.norm(g * VS + MIN_COORDS, axis=-1) - 0.5)
    active = g[d < 2 * VS].astype(np.int32)
    return (active, np.full(len(active), 8.0, np.float32),
            np.zeros((len(active), 4), np.float32))


def _decoder(radius, calls):
    """Analytic SDF of a sphere at voxel coords; counts its batches.  Takes
    a jax array or a CPU tensor, returns float32 numpy."""
    def decode(coords):
        calls.append(1)
        w = np.asarray(coords) * VS + MIN_COORDS
        return (np.linalg.norm(w, axis=-1) - radius).astype(np.float32)

    return decode


def test_mesher_sequence_bit_identical_to_jax():
    """First update, a half-scene latent change, no change, an equal-sum
    latent change, a prior-only change and an unchanged prior: equal
    vertices and faces bit for bit, and the decode skipped in the same
    updates."""
    active, weights, feats = _sphere()
    half = feats.copy()
    half[active[:, 0] >= 20, 1] += 1.0
    equal_sum = half.copy()
    equal_sum[:, 0] += 1.0
    equal_sum[:, 1] -= 1.0
    delta0 = np.zeros((20, 20, 20), np.float32)
    delta1 = np.full((20, 20, 20), 0.1, np.float32)
    steps = [(0.5, feats, delta0), (0.52, half, delta0), (0.6, half, delta0),
             (0.54, equal_sum, delta0), (0.5, equal_sum, delta1),
             (0.6, equal_sum, delta1.copy())]
    jm = JMesher(MIN_COORDS, VS, batch_size=1 << 14, n_xyz=N_XYZ)
    tm = IncrementalMesher(MIN_COORDS, VS, batch_size=1 << 14, n_xyz=N_XYZ)
    decoded = []
    for radius, f, delta in steps:
        jcalls, tcalls = [], []
        a = jm.update(_decoder(radius, jcalls), active, weights, f, 1.0,
                      sdf_delta=delta)
        b = tm.update(_decoder(radius, tcalls), active, weights, f, 1.0,
                      sdf_delta=delta)
        np.testing.assert_array_equal(b.vertices, a.vertices)
        np.testing.assert_array_equal(b.faces, a.faces)
        assert len(tcalls) == len(jcalls)
        decoded.append(len(tcalls) > 0)
    assert decoded == [True, True, False, True, True, False]
    assert len(b.faces) > 1000
    # the last mesh carries the prior-only step's radius
    assert abs(np.linalg.norm(b.vertices, axis=-1).mean() - 0.5) < 0.01


def test_weld_keys_bit_identical_to_jax():
    rng = np.random.RandomState(0)
    verts = (rng.rand(3000, 3) * 4 - 2).astype(np.float32)
    verts[1000:2000] = verts[:1000] + 1e-4   # within the weld tolerance
    faces = rng.randint(0, 3000, (2000, 3)).astype(np.int32)
    tol = 0.05 * 0.25
    pk = tmesh.pack_weld_keys(verts, tol)
    np.testing.assert_array_equal(pk, jmesh.pack_weld_keys(verts, tol))
    a = tmesh.merge_vertices(tmesh.Mesh(verts, faces), tol, packed_keys=pk)
    b = jmesh.merge_vertices(jmesh.Mesh(verts, faces), tol, packed_keys=pk)
    c = tmesh.merge_vertices(tmesh.Mesh(verts, faces), tol)
    for m in (b, c):
        np.testing.assert_array_equal(a.vertices, m.vertices)
        np.testing.assert_array_equal(a.faces, m.faces)
    assert len(a.vertices) < 3000
    # out of the +-2**20 packing range: no keys, the row-unique fallback
    far = verts * 1e6
    assert tmesh.pack_weld_keys(far, 0.25) is None
    assert jmesh.pack_weld_keys(far, 0.25) is None
    a = tmesh.merge_vertices(tmesh.Mesh(far, faces), 0.25)
    b = jmesh.merge_vertices(jmesh.Mesh(far, faces), 0.25)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert tmesh.pack_weld_keys(np.zeros((0, 3), np.float32), tol).shape \
        == (0,)


def test_return_cell_ids_matches_jax_binding():
    active, _, _ = _sphere()
    points, corner_idx, cells = tmesh.build_sample_lattice(active)
    sdf = _decoder(0.5, [])(points.astype(np.float32) / 2.0)
    sdf[::97] = np.nan                      # "no data" samples
    got = tnative.marching_tetrahedra_indexed_native(
        cells, corner_idx, sdf, use_sentinel=True, nan_fallback=VS,
        weld_tol=0.0, return_cell_ids=True)
    want = jnative.marching_tetrahedra_indexed_native(
        cells, corner_idx, sdf, use_sentinel=True, nan_fallback=VS,
        weld_tol=0.0, return_cell_ids=True)
    assert len(got) == 3 and len(got[1]) > 1000
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # without the flag the binding keeps its two outputs
    assert len(tnative.marching_tetrahedra_indexed_native(
        cells, corner_idx, sdf, use_sentinel=True, nan_fallback=VS)) == 2


def test_host_diff_matches_rows_by_voxel_key():
    """A permuted but unchanged active set triggers no decode (the JAX
    class compares rows by position and would re-mesh)."""
    active, weights, feats = _sphere()
    feats = np.random.RandomState(1).randn(*feats.shape).astype(np.float32)
    tm = IncrementalMesher(MIN_COORDS, VS, n_xyz=N_XYZ)
    first = tm.update(_decoder(0.5, []), active, weights, feats, 1.0)
    perm = np.random.RandomState(2).permutation(len(active))
    calls = []
    again = tm.update(_decoder(0.5, calls), active[perm], weights[perm],
                      feats[perm], 1.0)
    assert not calls
    np.testing.assert_array_equal(again.vertices, first.vertices)
    # one changed row, permuted, is still found
    feats2 = feats.copy()
    feats2[5, 2] += 1.0
    tm.update(_decoder(0.5, calls), active[perm], weights[perm],
              feats2[perm], 1.0)
    assert calls and tm.last_stats["changed"] == 1


@pytest.mark.parametrize("change", ["latents", "prior"])
def test_failed_update_commits_no_snapshot(change):
    """An update whose decode raises leaves every snapshot as it was: the
    retry re-decodes the changed voxels and equals a mesher that never saw
    the failure."""
    active, weights, feats = _sphere()
    delta0 = np.zeros((20, 20, 20), np.float32)
    feats2, delta2 = feats, delta0
    if change == "latents":
        feats2 = feats.copy()
        feats2[active[:, 0] >= 20, 1] += 1.0
    else:
        delta2 = np.full_like(delta0, 0.1)
    ref = IncrementalMesher(MIN_COORDS, VS, n_xyz=N_XYZ)
    tm = IncrementalMesher(MIN_COORDS, VS, n_xyz=N_XYZ)
    for m in (ref, tm):
        m.update(_decoder(0.5, []), active, weights, feats, 1.0,
                 sdf_delta=delta0)

    def broken(coords):
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        tm.update(broken, active, weights, feats2, 1.0, sdf_delta=delta2)
    calls = []
    got = tm.update(_decoder(0.52, calls), active, weights, feats2, 1.0,
                    sdf_delta=delta2)
    want = ref.update(_decoder(0.52, []), active, weights, feats2, 1.0,
                      sdf_delta=delta2)
    assert calls
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)


OVERRIDES = ["dataset.img_res=[60,80]", "dataset.num_images=4",
             f"model.voxel_size={VS}", "model.integrate_batch_size=2",
             "dataset.num_pixels=200", "model.train_ray_splits=100",
             "model.min_pts_in_grid=0", "model.table_capacity=65536",
             "model.use_seg_reduce_kernel=interpret",
             "model.fuse_sort_bf16=false", "model.mode=demo"]


def _record_masks(nmap, out):
    """Wrap the map's change-mask method, keeping each mask it returns."""
    orig = nmap._inc_changed_mask

    def wrapped(*args):
        res = orig(*args)
        out.append(np.array(res[0] if isinstance(res, tuple) else res))
        return res

    nmap._inc_changed_mask = wrapped


def _changed_keys(mask, table_mod, table):
    keys = table_mod.active_entries(table, with_features=False)[0]
    assert len(keys) == len(mask)
    return {tuple(k) for k in keys[mask]}


def _triangle_rows(tris):
    """Triangles [K, 3, 3] as rows of 9 coordinates rounded to 1e-5 m,
    sorted: equal for two caches that hold the same triangles in any
    order."""
    r = np.round(np.asarray(tris).reshape(-1, 9) / 1e-5).astype(np.int64)
    return r[np.lexsort(r.T[::-1])]


def _fscore(a_tris, b_tris):
    """Mutual F-score at voxel/4 of two triangle sets' centroids.  (Welded
    vertices and area-sampled points both follow the cache's triangle
    order, which differs between two caches of the same surface.)"""
    return evaluation.fscore_points(np.mean(a_tris, axis=1),
                                    np.mean(b_tris, axis=1),
                                    VS / 4)["fscore"]


def _shifted_params(ds, frames):
    """The e2e fixture's weights: init_model's, with the decoder's output
    bias shifted by the median decoded SDF at the voxel centers after the 4
    frames, so the untrained decoder's level set crosses the map."""
    params = jax.tree.map(np.asarray, jnn.init_model(jax.random.key(0)))
    nm = TNeuralMap(ds.dimensions,
                    tload_config(OVERRIDES + ["device_type=cpu"]), params)
    for i in range(0, len(frames), 2):
        nm.integrate_batch(frames[i:i + 2])
    keys = ttables.active_entries(nm.table, with_features=False)[0]
    with torch.no_grad():
        sdf = tfusion.decode_points(
            nm.table.features, nm.table, nm.params,
            torch.as_tensor(keys + 0.5, dtype=torch.float32), nm.bound_min,
            VS, 0, is_coords=True)
    params["decoder"]["b_out"] = params["decoder"]["b_out"] - \
        np.float32(np.median(sdf.numpy()) / VS)
    return params


def test_neural_map_incremental_matches_jax():
    """Two events (frames 0-1, then 2-3): equal latent-change masks by
    voxel key, meshes that agree at a mutual F-score >= 0.99, a failed
    update that commits no snapshot, and a cache equal to a fresh mesher's
    on the final state.  The prior (0.025 m) is finer than the grid here,
    where the JAX class's prior dilation leaves a stale cell."""
    cfg = jload_config(OVERRIDES)
    ds = SyntheticDemoDataset(cfg, "val")
    frames = [ds[i] for i in range(len(ds))]
    params = _shifted_params(ds, frames)
    jnm = JNeuralMap(ds.dimensions, cfg, params)
    tnm = TNeuralMap(ds.dimensions,
                     tload_config(OVERRIDES + ["device_type=cpu"]), params)
    jmasks, tmasks = [], []
    _record_masks(jnm, jmasks)
    _record_masks(tnm, tmasks)
    for event in range(2):
        for nm in (jnm, tnm):
            nm.integrate_batch(frames[2 * event:2 * event + 2])
        if event == 1:
            # a failed update commits no device snapshot
            snap, real = tnm._inc_prev, tnm.inc_mesher.update

            def broken(*a, **k):
                raise RuntimeError("mesher failed")

            tnm.inc_mesher.update = broken
            with pytest.raises(RuntimeError, match="mesher failed"):
                tnm.extract_mesh_incremental()
            assert tnm._inc_prev is snap
            tnm.inc_mesher.update = real
            tmasks.pop()
        jm, tm = jnm.extract_mesh_incremental(), tnm.extract_mesh_incremental()
        assert jm is not None and tm is not None and len(tm.faces) > 1000
        assert _changed_keys(tmasks[-1], ttables, tnm.table) == \
            _changed_keys(jmasks[-1], jtables, jnm.table)
        jtris = jnm._inc_mesher._world_verts(
            jnm._inc_mesher._tris).reshape(-1, 3, 3)
        assert _fscore(jtris, tnm.inc_mesher.triangles()) >= 0.99
    assert tmasks[0].all() and not tmasks[1].all() and tmasks[1].any()
    stats = tnm.inc_mesher.last_stats
    assert 0 < stats["redecoded"] < stats["eligible"]

    # the cache equals one update of a fresh mesher on the same state:
    # the same triangles, the same welded face and vertex counts
    decode, keys, weights, delta, _ = tnm.incremental_mesh_inputs()
    fresh = IncrementalMesher(tnm.bound_min.numpy(), VS,
                              n_xyz=np.asarray(tnm.n_xyz))
    fm = fresh.update(decode, keys, weights, None, tnm.min_pts_in_grid,
                      sdf_delta=delta, changed_rows=np.ones(len(keys), bool))
    assert (len(fm.faces), len(fm.vertices)) == \
        (len(tm.faces), len(tm.vertices))
    np.testing.assert_array_equal(_triangle_rows(fresh.triangles()),
                                  _triangle_rows(tnm.inc_mesher.triangles()))


def test_both_mesh_paths_gate_voxels_alike(monkeypatch):
    """Under model.mesh_require_observation a voxel without a fused
    observation meshes in neither path, even at min_pts_in_grid 0 (the JAX
    incremental path gives it weight 0, which passes that gate)."""
    from bnv_fusion_tpu_torch import pipeline

    cfg = tload_config(OVERRIDES + ["device_type=cpu",
                                    "model.mesh_require_observation=true"])
    ds = SyntheticDemoDataset(jload_config(OVERRIDES), "val")
    nm = TNeuralMap(ds.dimensions, cfg, _shifted_params(
        ds, [ds[i] for i in range(len(ds))]))
    nm.integrate_batch([ds[0], ds[1]])
    nm.table.num_hits[:int(nm.table.n_alloc)][::3] = 0
    hits = ttables.active_entries(nm.table, with_features=False)[3]
    n_obs = int((hits > 0).sum())
    assert 0 < n_obs < len(hits)
    gated = []
    real = pipeline.mesh_mod.extract_mesh
    monkeypatch.setattr(pipeline.mesh_mod, "extract_mesh",
                        lambda fn, active, *a, **k:
                        gated.append(len(active)) or real(fn, active, *a, **k))
    assert nm.extract_mesh() is not None
    assert nm.extract_mesh_incremental() is not None
    assert gated == [n_obs] == [nm.inc_mesher.last_stats["eligible"]]


def _record_calls(monkeypatch, cls, calls):
    """Wrap the loop's NeuralMap calls on ``cls`` so they are recorded,
    then run."""
    def wrap(name, what):
        orig = getattr(cls, name)

        def wrapped(self, *a, **k):
            calls.append(what(*a, **k))
            return orig(self, *a, **k)

        monkeypatch.setattr(cls, name, wrapped)

    wrap("integrate", lambda frame: ("flush", 1))
    wrap("integrate_batch", lambda frames: ("flush", len(frames)))
    wrap("optimize", lambda n_iters, last_frame=-1, **k:
         ("optimize", n_iters, last_frame))
    wrap("extract_mesh_incremental", lambda *a, **k: ("event",))


def test_demo_loop_matches_jax(monkeypatch, tmp_path):
    """4 frames, optim_interval=2, K=2: the same flushes, optimize
    arguments and events in both packages; the port writes the event PLYs
    and takes n_frames final steps (not doubled in demo mode)."""
    over = OVERRIDES + ["model.optim_interval=2", "trainer.global_steps=0"]
    jcalls, tcalls = [], []
    _record_calls(monkeypatch, JNeuralMap, jcalls)
    _record_calls(monkeypatch, TNeuralMap, tcalls)
    assert jrun_e2e.main(over + [f"output_dir={tmp_path / 'jax'}"]) == 0
    out = run_e2e.run(over + ["device_type=cpu",
                              f"output_dir={tmp_path / 'torch'}"])
    assert tcalls == jcalls == [
        ("flush", 1), ("optimize", 1, 0), ("event",), ("flush", 2),
        ("optimize", 2, 1), ("event",), ("flush", 1), ("optimize", 4, -1)]
    assert out["global_steps"] == 4
    assert len(out["nmap"].optimize_losses) == 4
    wd = out["working_dir"]
    for name in ("0.ply", "2.ply", "before_optim.ply", "final.ply"):
        assert (tmp_path / "torch" / "run_e2e" / "synthetic_demo" /
                name).exists(), name
    assert [e["frame"] for e in out["events"]] == [0, 2]
    assert [e["optimize_iters"] for e in out["events"]] == [1, 2]
    for e in out["events"]:
        assert 0 < e["redecoded"] <= e["eligible"] and e["vertices"] > 0
        m = tmesh.load_ply(f"{wd}/{e['frame']}.ply")
        assert len(m.vertices) == e["vertices"]
