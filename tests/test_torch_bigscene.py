"""Port parity of the big-scene layouts end to end: NeuralMap on a block
table and a block-major TSDF prior, against the JAX package and against
the port's own dense run, on the e2e parity test's tiny stream (60x80,
4 frames, K=2, voxel 0.05; tests/test_torch_e2e.py says why that point).

Both packages' ``tables.DENSE_MAP_MAX_VOXELS`` are patched below the grid's
voxel count while the maps are built, so the table routes to blocks, and
``model.tsdf_layout=blocks`` routes the prior.  Checked: the routing; the
fused table by voxel key (keys, weights and hits exact, features within
1e-5 of JAX's) and the prior against JAX, and both bit for bit against
the dense run; one optimize step on a block table against JAX's on the
same draws; the before-optimize mesh against JAX's
(mutual F-score >= 0.99 at voxel / 4) and equal to the dense run's
triangles; the prefetch skipped on a block table; save / load_map round
trips of a block-major prior (and across the packages); demo mode's
incremental mesh and change masks on a block table equal to the dense
table's; the refiner's prior on a block-major volume equal to the dense
one's.  And two faults of the JAX package on these layouts, reproduced:
its demo-mode change mask on a block table has the wrong length, and its
refiner resamples a prior to the block-major volume's [n_blocks, 64] brick
shape (ROADMAP Queue 3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import nn as jnn
from bnv_fusion_tpu import optimize as jopt
from bnv_fusion_tpu import render as jrender
from bnv_fusion_tpu import table_blocks as jtb
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu import tsdf as jtsdf
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.models.fusion_refiner import FusionRefiner as JRefiner
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import evaluation, mesh as tmesh
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import optimize as topt
from bnv_fusion_tpu_torch import table_blocks as ttb
from bnv_fusion_tpu_torch import table_dense as ttd
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch import tsdf as ttsdf
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.models.fusion_refiner import \
    FusionRefiner as TRefiner
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

VOXEL = 0.05
BASE = ["dataset.img_res=[60,80]", "dataset.num_images=4",
        f"model.voxel_size={VOXEL}", "model.integrate_batch_size=2",
        "dataset.num_pixels=200", "model.train_ray_splits=100",
        "trainer.global_steps=2", "model.min_pts_in_grid=0",
        "model.table_capacity=65536",
        "model.use_seg_reduce_kernel=interpret",
        "model.fuse_sort_bf16=false"]
BLOCKS = BASE + ["model.tsdf_layout=blocks"]
SMALL_MAP = 1000           # DENSE_MAP_MAX_VOXELS while the maps are built
# the prior against JAX's: weights equal and sdf within PRIOR_ATOL on all
# but EDGE_SHARE of the voxels.  Each package projects the voxels in its own
# float rounding: the dense priors of the two differ by up to 1.9e-6 at this
# point (tests/test_torch_e2e.py holds them to 1e-5), and a voxel within
# float noise of a pixel's edge can take the other pixel (4 of 752,812 here,
# where the JAX package's own block and dense priors differ at 4 too)
PRIOR_ATOL = 1e-5
EDGE_SHARE = 1e-3


def _blocks_maps(jcfg, tcfg, dims, params):
    """A JAX and a port NeuralMap whose tables route to blocks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtables, "DENSE_MAP_MAX_VOXELS", SMALL_MAP)
        mp.setattr(ttables, "DENSE_MAP_MAX_VOXELS", SMALL_MAP)
        return (None if jcfg is None else JNeuralMap(dims, jcfg, params),
                TNeuralMap(dims, tcfg, params))


@pytest.fixture(scope="module")
def maps():
    jcfg = jload_config(BLOCKS)
    tcfg = tload_config(BLOCKS + ["device_type=cpu"])
    ds = SyntheticDemoDataset(jcfg, "val")
    frames = [ds[i] for i in range(len(ds))]
    params = jax.tree.map(np.asarray, jnn.init_model(jax.random.key(0)))
    jnm, tnm = _blocks_maps(jcfg, tcfg, ds.dimensions, params)
    dnm = TNeuralMap(ds.dimensions, tload_config(BASE + ["device_type=cpu"]),
                     params)
    for i in range(0, len(frames), 2):
        for nm in (jnm, tnm, dnm):
            nm.integrate_batch(frames[i:i + 2])
    # shift the decoder's output bias so the untrained level set crosses the
    # map (tests/test_torch_e2e.py), the same weights in all three maps
    keys = ttables.active_entries(dnm.table, with_features=False)[0]
    with torch.no_grad():
        sdf = tfusion.decode_points(
            dnm.table.features, dnm.table, dnm.params,
            torch.as_tensor(keys + 0.5, dtype=torch.float32), dnm.bound_min,
            VOXEL, 0, is_coords=True)
    params["decoder"]["b_out"] = params["decoder"]["b_out"] - \
        np.float32(np.median(sdf.numpy()) / VOXEL)
    for nm in (tnm, dnm):
        nm.params["decoder"]["b_out"] = torch.as_tensor(
            params["decoder"]["b_out"])
    return dict(jnm=jnm, tnm=tnm, dnm=dnm, ds=ds, frames=frames,
                params=params, jcfg=jcfg, tcfg=tcfg)


def _by_key(entries):
    k, f, w, h = entries[:4]
    o = np.lexsort(k.T[::-1])
    return k[o], f[o], w[o], h[o]


def _live(entries):
    k, f, w, h = entries
    live = (w > 0) | (h > 0)
    return k[live], f[live], w[live], h[live]


def _close(got, want, atol):
    far = np.abs(np.asarray(got) - np.asarray(want)) > atol
    assert far.mean() <= EDGE_SHARE, (far.sum(), far.size)


def _triangle_rows(mesh):
    """A mesh's triangles as sorted rows of 9 coordinates."""
    t = np.asarray(mesh.vertices)[np.asarray(mesh.faces)].reshape(-1, 9)
    return t[np.lexsort(t.T[::-1])]


def test_big_layouts_route_in_both_packages(maps):
    """The patched map budget routes the table to blocks, and
    tsdf_layout=blocks the prior, in both packages; under auto a prior of
    8M voxels or more is block-major too, and below it dense."""
    assert isinstance(maps["tnm"].table, ttb.BlockIndexedTable)
    assert isinstance(maps["jnm"].table, jtb.BlockIndexedTable)
    assert isinstance(maps["tnm"].tsdf_vol, ttsdf.TSDFVolumeBM)
    assert isinstance(maps["jnm"].tsdf_vol, jtsdf.TSDFVolumeBM)
    assert isinstance(maps["dnm"].table, ttd.DenseIndexedTable)
    assert isinstance(maps["dnm"].tsdf_vol, ttsdf.TSDFVolume)
    cfg = tload_config(BASE + ["device_type=cpu", "model.voxel_size=0.1"])
    params = maps["params"]
    room = np.array([6.0, 7.0, 3.0], np.float32)     # 8.06M prior voxels
    assert isinstance(TNeuralMap(room, cfg, params).tsdf_vol,
                      ttsdf.TSDFVolumeBM)
    assert isinstance(TNeuralMap(room * 0.9, cfg, params).tsdf_vol,
                      ttsdf.TSDFVolume)


def test_fused_table_and_prior_match_jax(maps):
    """After four frames: the live entries by voxel key and the prior (as
    dense, up to the pixel-edge voxels) against the JAX package's block
    layouts."""
    jnm, tnm = maps["jnm"], maps["tnm"]
    tk, tf, tw, th = _by_key(ttables.active_entries(tnm.table))
    jk, jf, jw, jh = _by_key(jtables.active_entries(jnm.table))
    assert len(tk) > 1000
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(tf, jf, atol=1e-5)
    assert tnm.overflow == 0 == jnm.overflow
    assert int(tnm.tsdf_vol.overflow) == 0 == int(jnm.tsdf_vol.overflow)
    tp, jp = ttsdf.as_dense(tnm.tsdf_vol), jtsdf.as_dense(jnm.tsdf_vol)
    _close(tp.weight.numpy(), jp.weight, 0.0)
    _close(tp.sdf.numpy(), jp.sdf, PRIOR_ATOL)


def test_block_run_equals_dense_run(maps):
    """The block layouts against the port's dense run on the same frames:
    the live table entries and the prior bit for bit, the before-optimize
    mesh's triangles equal; and the optimize-overlapped lattice prefetch
    is skipped on the block table (the in-line build meshes), as in the
    JAX package."""
    tnm, dnm = maps["tnm"], maps["dnm"]
    for a, b in zip(_by_key(ttables.active_entries(tnm.table)),
                    _live(_by_key(ttables.active_entries(dnm.table)))):
        np.testing.assert_array_equal(a, b)
    tp = ttsdf.as_dense(tnm.tsdf_vol)
    np.testing.assert_array_equal(tp.weight.numpy(),
                                  dnm.tsdf_vol.weight.numpy())
    np.testing.assert_array_equal(tp.sdf.numpy(), dnm.tsdf_vol.sdf.numpy())
    tm, dm = tnm.extract_mesh(), dnm.extract_mesh()
    assert len(tm.faces) > 1000
    np.testing.assert_array_equal(_triangle_rows(tm), _triangle_rows(dm))
    tnm.prefetch_mesh_lattice()
    assert tnm._mesh_prefetch is None and tnm._prefetched_lattice() is None
    dnm.prefetch_mesh_lattice()
    assert dnm._prefetched_lattice() is not None


def test_before_optim_mesh_matches_jax(maps):
    jm, tm = maps["jnm"].extract_mesh(), maps["tnm"].extract_mesh()
    pj = tmesh.sample_surface(tmesh.Mesh(np.asarray(jm.vertices),
                                         np.asarray(jm.faces)), 20000, 0)
    pt = tmesh.sample_surface(tm, 20000, 0)
    res = evaluation.fscore_points(pt, pj, VOXEL / 4)
    assert res["fscore"] >= 0.99, res


def test_optimize_step_on_block_table_matches_jax(maps):
    """One optimize step on a block table holding the JAX map's entries in
    the JAX map's slots, on the JAX step's draws: the loss within 1e-5,
    the bumped weights exact, the gradient rows (Adam's first moment)
    within 1e-4 of the largest on all but 0.5% of the rows (the bound
    tests/test_torch_optimize.py holds the dense step to)."""
    jnm, tnm = maps["jnm"], maps["tnm"]
    f = maps["frames"][1]
    units, ray_max, splits, n_rays = 10, 3.0, 100, 200
    trunc = min(units * VOXEL * 0.5, 0.1)
    params = maps["params"]
    jt = jnm.table
    tt = ttables.load_entries(tnm.table, *jtables.active_entries(jt)[:4])
    np.testing.assert_array_equal(tt.block_map.numpy(),
                                  np.asarray(jt.block_map))
    delta = np.asarray(jtsdf.prepare_sdf_delta(
        jnm.tsdf_vol, jnm.tsdf_voxel_size, trunc, 0.1))
    n_xyz = np.asarray(jnm.n_xyz)
    key = jax.random.key(7)
    k_rays, k_chunks = jax.random.split(key)
    pixel_ids = np.asarray(jax.random.choice(
        k_rays, f["depth"].size, (n_rays,), replace=False))
    n_fine, n_coarse = 2 * units, int(ray_max * 5)
    uniforms = [tuple(np.asarray(u) for u in jrender.draw_sampling_uniforms(
        k, splits, n_fine, n_coarse))
        for k in jax.random.split(k_chunks, n_rays // splits)]
    _, jstep, _ = jopt.make_optimize_step(
        jax.tree.map(jnp.asarray, params), VOXEL, 0, units, trunc, ray_max,
        n_rays, splits, lr=1e-3)
    opt_state = jopt.OptimState(
        features=jt.features + 0, weights=jt.weights + 0,
        opt_state=__import__("optax").adam(1e-3).init(jt.features))
    jstate, jloss = jstep(opt_state, jt, jnp.asarray(f["depth"]),
                          jnp.asarray(f["T_wc"]), jnp.asarray(f["intr_mat"]),
                          jnm.bound_min, jnm.n_xyz, jnp.asarray(delta), key,
                          lr_scale=0.5)
    t = torch.as_tensor
    tstep = topt.make_optimize_step(tnn.params_from_numpy(params), VOXEL, 0,
                                    units, trunc, ray_max, n_rays, splits,
                                    lr=1e-3)
    state = topt.init_optim_state(tt)
    state, tloss = tstep(
        state, tt, t(f["depth"]), t(f["T_wc"]), t(f["intr_mat"]),
        tnm.bound_min, tuple(int(v) for v in n_xyz), t(delta),
        pixel_ids=t(pixel_ids), uniforms=[tuple(t(u) for u in us)
                                          for us in uniforms], lr_scale=0.5)
    assert float(jloss) > 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(state.weights.numpy(),
                                  np.asarray(jstate.weights))
    jg = np.asarray(jstate.opt_state[0].mu) / 0.1
    tg = state.mu.numpy() / 0.1
    assert np.abs(jg).max() > 0
    off = np.abs(tg - jg).max(1) > 1e-4 * np.abs(jg).max()
    assert off.sum() <= 0.005 * (np.abs(jg).max(1) > 0).sum()


def test_save_and_load_map_round_trip_block_prior(maps, tmp_path):
    """save writes the dense metric prior of a block-major volume; load_map
    restores table and prior in the port, and each package loads the
    other's save (JAX's block-major branch of load_map)."""
    tnm, jnm = maps["tnm"], maps["jnm"]
    prefix = str(tmp_path / "port")
    tnm.save(prefix)
    saved = np.load(prefix + "_tsdf.npy")
    assert saved.shape == tnm.tsdf_vol.vol_dim
    np.testing.assert_array_equal(
        saved, ttsdf.as_dense(tnm.tsdf_vol).sdf.numpy() *
        np.float32(tnm.tsdf_voxel_size * 5))
    _, back = _blocks_maps(None, maps["tcfg"], maps["ds"].dimensions,
                           maps["params"])
    back.load_map(prefix)
    assert isinstance(back.tsdf_vol, ttsdf.TSDFVolumeBM)
    assert isinstance(back.table, ttb.BlockIndexedTable)
    for a, b in zip(_by_key(ttables.active_entries(back.table)),
                    _by_key(ttables.active_entries(tnm.table))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        ttsdf.as_dense(back.tsdf_vol).sdf.numpy() *
        np.float32(tnm.tsdf_voxel_size * 5), saved, rtol=1e-6, atol=1e-7)
    assert float(back.tsdf_vol.weight.min()) == 1.0
    jback, _ = _blocks_maps(maps["jcfg"], maps["tcfg"],
                            maps["ds"].dimensions, maps["params"])
    jback.load_map(prefix)
    np.testing.assert_array_equal(
        np.asarray(jtsdf.as_dense(jback.tsdf_vol).sdf),
        ttsdf.as_dense(back.tsdf_vol).sdf.numpy())
    jprefix = str(tmp_path / "jax")
    jnm.save(jprefix)
    back.load_map(jprefix)
    np.testing.assert_array_equal(
        ttsdf.as_dense(back.tsdf_vol).sdf.numpy(),
        np.load(jprefix + "_tsdf.npy").astype(np.float32) /
        np.float32(back.tsdf_voxel_size * 5.0))
    with pytest.raises(ValueError, match="tsdf prior shape"):
        back.set_tsdf_prior(np.zeros((3, 3, 3), np.float32))


def _record_masks(nmap, out):
    """Keep each change mask the map's incremental mesh computes."""
    orig = nmap._inc_changed_mask

    def wrapped(*args):
        res = orig(*args)
        out.append(np.array(res[0]))
        return res

    nmap._inc_changed_mask = wrapped


def test_demo_incremental_mesh_on_block_table_equals_dense(maps):
    """Demo mode's incremental mesh on the block layouts against the dense
    table, over two events with frames fused between them: the same change
    masks by voxel key (each as long as the live entries) and the same
    triangles."""
    ds, frames, params = maps["ds"], maps["frames"], maps["params"]
    cfg = tload_config(BLOCKS + ["device_type=cpu", "model.mode=demo"])
    _, bnm = _blocks_maps(None, cfg, ds.dimensions, params)
    dnm = TNeuralMap(ds.dimensions, tload_config(
        BASE + ["device_type=cpu", "model.mode=demo"]), params)
    masks = {}
    for name, nm in (("blocks", bnm), ("dense", dnm)):
        nm.params["decoder"]["b_out"] = torch.as_tensor(
            params["decoder"]["b_out"])
        masks[name] = []
        _record_masks(nm, masks[name])
    tris = {"blocks": [], "dense": []}
    for lo in (0, 2):
        for name, nm in (("blocks", bnm), ("dense", dnm)):
            nm.integrate_batch(frames[lo:lo + 2])
            mesh = nm.extract_mesh_incremental()
            tris[name].append(_triangle_rows(mesh))
            keys = ttables.active_entries(nm.table, with_features=False)[0]
            assert len(masks[name][-1]) == len(keys)
            masks[name][-1] = {tuple(k) for k in keys[masks[name][-1]]}
    for i in range(2):
        np.testing.assert_array_equal(tris["blocks"][i], tris["dense"][i])
        assert masks["blocks"][i] == masks["dense"][i]
    assert 0 < len(masks["blocks"][1])


def test_jax_demo_mask_on_block_table_has_the_wrong_length(maps):
    """Reproduces the JAX package's fault (ROADMAP Queue 3): its change mask
    diffs rows [:n_alloc], and on a block table n_alloc counts blocks, so
    the mask's length is the block count, not the live entries', and the
    incremental mesh fails."""
    jnm = maps["jnm"]
    n_live = len(jtables.active_entries(jnm.table, with_features=False)[0])
    assert int(jnm.table.n_alloc) != n_live
    with pytest.raises(ValueError, match="broadcast"):
        jnm.extract_mesh_incremental()


def _refine(refiner, cfg, ds, params, tmp_path):
    r = refiner(cfg, params)
    r.run(ds, str(tmp_path), n_epochs=1, iters_per_epoch=1)
    return r.nmap


def test_refiner_prior_on_block_volume_equals_dense(maps, tmp_path):
    """The refiner's prior (a saved .npy on another grid, resampled) on a
    block-major volume equals the dense volume's; the JAX refiner raises
    there (ROADMAP Queue 3: it resamples to the [n_blocks, 64] brick
    shape)."""
    ds, params = maps["ds"], maps["params"]
    maps["dnm"].save(str(tmp_path / "map"))
    coarse = np.random.RandomState(8).randn(20, 21, 13).astype(np.float32) \
        * 0.05
    np.save(tmp_path / "prior.npy", coarse)
    extra = [f"model.sparse_volume_path={tmp_path / 'map'}_sparse_volume.npz",
             f"model.tsdf_prior_path={tmp_path / 'prior.npy'}",
             "model.refine_frame_order=epoch"]
    bnm = _refine(TRefiner, tload_config(
        BLOCKS + extra + ["device_type=cpu"]), ds, params, tmp_path / "b")
    dnm = _refine(TRefiner, tload_config(
        BASE + extra + ["device_type=cpu"]), ds, params, tmp_path / "d")
    assert isinstance(bnm.tsdf_vol, ttsdf.TSDFVolumeBM)
    np.testing.assert_array_equal(ttsdf.as_dense(bnm.tsdf_vol).sdf.numpy(),
                                  dnm.tsdf_vol.sdf.numpy())
    assert bnm.last_optimize_iters == 1 and \
        np.isfinite(bnm.optimize_losses).all()
    with pytest.raises(ValueError, match="broadcast"):
        _refine(JRefiner, jload_config(BLOCKS + extra), ds, params,
                tmp_path / "j")
    assert os.path.exists(tmp_path / "b" / "refined_tsdf.npy")
